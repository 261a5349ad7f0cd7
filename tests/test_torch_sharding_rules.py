"""Port parity for the sharding-rules layer
(``paddle_tpu_torch/distributed/sharding_rules.py``) and the
update-sharding rule table: the reference's ``TestResolver``,
``TestSpecConstructors``, ``TestDigests`` and the rule-table case of
``TestUpdateSharding`` (``tests/test_sharding_rules.py``) on the port,
over the port's ``ProcessMesh`` (layout only: no process group), and
every resolved spec and digest held against the JAX package's: specs
entry for entry, digests as equal strings (A6c's resume check compares
them across the packages).  No spawn; the spawn-free layout math of a
rank's shard (``local_shard``) against the reference's
``addressable_shards``.
"""

import gc
import re

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed import sharding_rules as sr
from paddle_tpu_torch.distributed.topology import ProcessMesh
from paddle_tpu_torch.distributed.update_sharding import update_sharding_rules
from paddle_tpu_torch.utils.stats import get_all_stats

P = sr.PartitionSpec


def _mesh(n, names=("data",), shape=None, rank=0):
    return ProcessMesh(names, shape if shape is not None else (n,), rank)


def _jmesh(n, names=("data",), shape=None):
    import jax
    from jax.sharding import Mesh
    devs = np.array(jax.devices()[:n])
    if shape is not None:
        devs = devs.reshape(shape)
    return Mesh(devs, names)


def _fallback_stats():
    s = get_all_stats()
    return (s.get("sharding_replicated_fallback_bytes", 0),
            s.get("sharding_replicated_fallback_leaves", 0))


def _same(tspec, jspec):
    """A port spec tree equals a reference spec tree entry for entry."""
    if isinstance(jspec, dict):
        assert set(tspec) == set(jspec)
        for k in jspec:
            _same(tspec[k], jspec[k])
    elif isinstance(jspec, list):
        assert len(tspec) == len(jspec)
        for a, b in zip(tspec, jspec):
            _same(a, b)
    elif jspec is None:
        assert tspec is None
    else:
        assert isinstance(tspec, P), tspec
        assert tuple(tspec) == tuple(jspec), (tspec, jspec)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_arrays():
    """Drop this module's JAX arrays when it ends: a later module in the
    same process ranks the live JAX arrays (the reference's memory
    forensics), and these would crowd out its own."""
    yield
    gc.collect()


# ==========================================================================
# resolver semantics
# ==========================================================================

class TestResolver:
    def test_first_match_wins_in_rule_order(self):
        rules = sr.ShardingRules([(r"w", ("data",)), (r".*", None)])
        assert rules.spec_for("w1", np.zeros((8,))) == P("data")
        assert rules.spec_for("b1", np.zeros((8,))) == P()
        shadowed = sr.ShardingRules([(r".*", None), (r"w", ("data",))])
        assert shadowed.spec_for("w1", np.zeros((8,))) == P()

    def test_search_not_fullmatch_and_scalars_exempt(self):
        rules = sr.ShardingRules([(r"attn/", ("model",))])
        assert rules.spec_for("block0/attn/wq", np.zeros((4, 4))) == \
            P("model")
        rules = sr.ShardingRules([(r".*", ("data",))])
        assert rules.spec_for("step", np.zeros(())) == P()
        assert rules.spec_for("beta_pow", torch.zeros(1)) == P()
        assert rules.spec_for("v", torch.zeros(8)) == P("data")

    def test_unmatched_policies(self):
        with pytest.raises(ValueError, match=r"no rule matches path 'b'"):
            sr.ShardingRules([(r"^w$", ("data",))],
                             name="strict").spec_for("b", np.zeros((8,)))
        rules = sr.ShardingRules([(r"^w$", ("data",))],
                                 unmatched="replicate")
        b0, l0 = _fallback_stats()
        with pytest.warns(UserWarning, match="stays fully replicated"):
            assert rules.spec_for("b", torch.zeros(8)) == P()
        b1, l1 = _fallback_stats()
        assert (b1 - b0, l1 - l0) == (32, 1)

    def test_indivisible_policies(self):
        rules = sr.ShardingRules([(r".*", ("data",))], mesh=_mesh(2))
        b0, _ = _fallback_stats()
        with pytest.warns(UserWarning, match="indivisible|replicated"):
            assert rules.spec_for("odd", np.zeros((7, 4), np.float32)) == P()
        assert _fallback_stats()[0] - b0 == 7 * 4 * 4
        assert rules.spec_for("even", np.zeros((8, 4))) == P("data")
        with pytest.raises(ValueError, match="does not divide dim 0"):
            sr.ShardingRules([(r".*", ("data",))], mesh=_mesh(2),
                             indivisible="raise").spec_for(
                "odd", np.zeros((7,)))

    def test_rank_fit_and_tuple_axes(self):
        rules = sr.ShardingRules([(r".*", ("data", None))])
        for shape in ((8,), (8, 4, 2), (8, 4)):
            assert rules.spec_for("t", np.zeros(shape)) == P("data")
        mesh = _mesh(4, ("data", "model"), (2, 2))
        rules = sr.ShardingRules([(r".*", (("data", "model"),))], mesh=mesh)
        assert rules.spec_for("v", np.zeros((8,))) == P(("data", "model"))
        with pytest.warns(UserWarning):
            assert rules.spec_for("odd", np.zeros((6,))) == P()

    def test_spec_forms_and_bad_arguments(self):
        leaf = np.zeros((8, 4))
        for form in [P("data"), ("data",), ["data"]]:
            assert sr.ShardingRules([(r".*", form)]).spec_for("x", leaf) \
                == P("data")
        for form in [None, P(), ()]:
            assert sr.ShardingRules([(r".*", form)]).spec_for("x", leaf) \
                == P()
        with pytest.raises(ValueError, match="unmatched"):
            sr.ShardingRules([], unmatched="bogus")
        with pytest.raises(ValueError, match="indivisible"):
            sr.ShardingRules([], indivisible="bogus")
        with pytest.raises(TypeError, match="rule spec"):
            sr.ShardingRules([(r".*", 5)])

    @pytest.mark.parametrize("case", ["tree", "state", "kv_pool"])
    def test_resolve_equals_the_reference(self, case):
        """``resolve``/``resolve_state`` give the reference's spec trees
        for the reference's own cases."""
        from paddle_tpu.distributed import sharding_rules as jsr
        if case == "tree":
            tree = {"a": {"w": np.zeros((8, 4)), "b": np.zeros((4,))},
                    "n": [np.zeros((8,)), np.zeros(())]}
            rules = [(r"/w$", ("data", None)), (r".*", None)]
            fn = "resolve"
        elif case == "state":
            tree = {"params": {"w": np.zeros((8, 4)), "b": np.zeros((4,))},
                    "opt": {"step": np.zeros(()),
                            "slots": {"w": {"m": np.zeros((8, 4)),
                                            "beta1_pow": np.zeros((1,))},
                                      "b": {"m": np.zeros((4,))}}},
                    "buffers": {}}
            rules = [(r"^params/w$", ("data", None)), (r".*", None)]
            fn = "resolve_state"
        else:
            tree = {"layers": [{"k": np.zeros((16, 8, 4, 64)),
                                "v": np.zeros((16, 8, 4, 64))}
                               for _ in range(2)],
                    "page_table": np.zeros((32,), np.int32)}
            rules = [(r"layers/\d+/[kv]$", (None, None, "model", None)),
                     (r"page_table", None)]
            fn = "resolve"
        got = getattr(sr.ShardingRules(rules), fn)(tree)
        want = getattr(jsr.ShardingRules(rules), fn)(tree)
        _same(got, want)
        assert sr.spec_tree_digest(got) == jsr.spec_tree_digest(want)

    def test_match_partition_rules(self):
        tree = {"w": np.zeros((8,)), "b": np.zeros((4,))}
        assert sr.match_partition_rules([(r"w", ("data",)), (r".*", None)],
                                        tree) == {"w": P("data"), "b": P()}
        with pytest.raises(ValueError, match="no rule matches"):
            sr.match_partition_rules([(r"w", ("data",))], tree)


# ==========================================================================
# spec constructors and inference
# ==========================================================================

class TestSpecConstructors:
    def test_constructors(self):
        assert sr.make_spec("data", None) == P("data", None)
        assert sr.replicated_spec() == P() and P() != P(None)
        assert sr.replica_stacked_spec(np.zeros((4, 2, 3)), "data") == \
            P("data", None, None)
        assert sr.batch_spec(_mesh(2)) == P("data")
        assert sr.batch_spec(_mesh(1)) == P()
        assert sr.batch_spec(_mesh(2), "model") == P()
        assert sr.activation_batch_spec(_mesh(2)) == P("data", None, None)
        assert sr.activation_batch_spec(
            _mesh(2, ("data", "sep"), (1, 2))) == P("data", "sep", None)
        assert sr.activation_batch_spec(_mesh(1)) is None

    def test_resolve_flat_shard_spec(self):
        import warnings
        assert sr.resolve_flat_shard_spec("r", 8, _mesh(2), "data") == \
            P("data")
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert sr.resolve_flat_shard_spec("r", 8, _mesh(1), "data") == P()
        b0, l0 = _fallback_stats()
        with pytest.warns(UserWarning, match="stays fully replicated"):
            assert sr.resolve_flat_shard_spec("resid", 7, _mesh(2),
                                              "data") == P()
        b1, l1 = _fallback_stats()
        assert (b1 - b0, l1 - l0) == (28, 1)

    def test_replication_fallback_emits_tracer_event(self):
        events = []

        class Tracer:
            def emit(self, event, **kw):
                events.append((event, kw))

        with pytest.warns(UserWarning):
            sr.replication_fallback("unit-test", "x", 128, axis="data",
                                    degree=2, tracer=Tracer())
        assert events == [("sharding_fallback",
                           {"kind": "unit-test", "name": "x", "bytes": 128,
                            "axis": "data", "degree": 2})]

    @pytest.mark.parametrize("zero_stage", [0, 1, 3])
    def test_param_and_slot_specs_equal_the_reference(self, zero_stage):
        """The data × sharding inference (``build_param_specs``,
        ``_slot_spec``) for every tiny-GPT parameter, and the local shard
        each rank holds, against the reference's mesh of 4."""
        import jax
        import paddle_tpu as paddle
        from jax.sharding import NamedSharding
        from paddle_tpu.distributed import sharding_rules as jsr
        from paddle_tpu.models.gpt import GPTConfig, GPTModel
        paddle.seed(0)
        jm = GPTModel(GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                                num_attention_heads=4,
                                max_position_embeddings=64,
                                compute_dtype="float32"))
        params = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
        names = ("data", "pipe", "sharding", "sep", "model")
        jmesh = _jmesh(4, names, (2, 1, 2, 1, 1))
        jp = jsr.build_param_specs(params, jmesh, jm, zero_stage)
        for r in range(4):
            mesh = _mesh(4, names, (2, 1, 2, 1, 1), rank=r)
            tp = sr.build_param_specs(params, mesh, None, zero_stage)
            _same(tp, jp)
            for n, p in params.items():
                ts = sr._slot_spec(tp[n], p, mesh, max(zero_stage, 1))
                js = jsr._slot_spec(jp[n], p, jmesh, max(zero_stage, 1))
                _same(ts, js)
                arr = jax.device_put(p, NamedSharding(jmesh, js))
                want = {s.device: np.asarray(s.data)
                        for s in arr.addressable_shards}[
                            jmesh.devices.flat[r]]
                np.testing.assert_array_equal(
                    sr.local_shard(torch.tensor(p), ts, mesh).numpy(), want)
        assert sr.spec_tree_digest(tp) == jsr.spec_tree_digest(jp)


    @pytest.mark.parametrize("vocab", [128, 129])
    def test_model_axis_specs_equal_the_reference(self, vocab):
        """GPT's ``_dims_mapping`` over a dp 2 x mp 2 mesh (a vocabulary
        the degree does not divide leaves ``wte`` replicated), each
        rank's shard against the reference's ``addressable_shards``, and
        the spec constructors of the sequence and model axes."""
        import jax
        import paddle_tpu as paddle
        from jax.sharding import NamedSharding
        from paddle_tpu.distributed import sharding_rules as jsr
        from paddle_tpu.models.gpt import GPTConfig, GPTModel
        from paddle_tpu_torch.models import gpt as TG
        cfg = dict(vocab_size=vocab, hidden_size=32, num_layers=2,
                   num_attention_heads=4, max_position_embeddings=32,
                   compute_dtype="float32")
        paddle.seed(0)
        jm = GPTModel(GPTConfig(**cfg))
        params = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
        tm = TG.GPTModel(TG.GPTConfig(**cfg), device="meta")
        names = ("data", "pipe", "sharding", "sep", "model")
        jmesh = _jmesh(4, names, (2, 1, 1, 1, 2))
        jp = jsr.build_param_specs(params, jmesh, jm, 0)
        assert (jp["wte"][0] == "model") == (vocab == 128)
        for r in range(4):
            mesh = _mesh(4, names, (2, 1, 1, 1, 2), rank=r)
            tp = sr.build_param_specs(params, mesh, tm, 0)
            _same(tp, jp)
            for n, p in params.items():
                arr = jax.device_put(p, NamedSharding(jmesh, jp[n]))
                want = {s.device: np.asarray(s.data)
                        for s in arr.addressable_shards}[
                            jmesh.devices.flat[r]]
                np.testing.assert_array_equal(
                    sr.local_shard(torch.tensor(p), tp[n], mesh).numpy(),
                    want)
        assert sr.sep_activation_spec() == P(None, "sep", None, None)
        _same(sr.sep_activation_spec(3, "x", 2), jsr.sep_activation_spec(
            3, "x", 2))
        assert sr.without_axis(P(None, ("data", "model"), "model")) == \
            P(None, "data", None)

    def test_partition_spec_survives_pickle(self):
        """A spec pickles whole (it crossed process boundaries as one
        tuple entry, ``PartitionSpec((None, 'model'))``, before
        ``__getnewargs__``)."""
        import pickle
        for spec in (P(), P(None), P(None, "model"), P(("data", "model"))):
            back = pickle.loads(pickle.dumps(spec))
            assert back == spec and type(back) is P


# ==========================================================================
# digests
# ==========================================================================

class TestDigests:
    def test_rules_digest_is_content_and_equals_the_reference(self):
        from paddle_tpu.distributed import sharding_rules as jsr
        cases = [[(r"w", ("data",))], [(r"w", ("data",)), (r".*", None)],
                 [(r".*", None), (r"w", ("data",))],
                 [(r"w", ("model",)), (r".*", None)],
                 [(r"w", (("data", "model"), None))]]
        digests = set()
        for rules in cases:
            for kw in ({}, {"unmatched": "replicate"}):
                d = sr.ShardingRules(rules, name="a", **kw).digest()
                assert d == sr.ShardingRules(rules, name="b", **kw).digest()
                assert d == jsr.ShardingRules(rules, **kw).digest()
                assert re.fullmatch(r"[0-9a-f]{32}", d)
                digests.add(d)
        assert len(digests) == 2 * len(cases)
        assert sr.ShardingRules([(r"w", ("data", None))]).digest() == \
            sr.ShardingRules([(r"w", P("data", None))]).digest()
        assert sr.ShardingRules([(r"w", None)]).digest() == \
            sr.ShardingRules([(r"w", P())]).digest()

    def test_spec_tree_digest_equals_the_reference(self):
        from jax.sharding import PartitionSpec as JP
        from paddle_tpu.distributed import sharding_rules as jsr
        t1 = {"a": P("data"), "b": {"c": None}, "d": [P(), P(None, "m")]}
        j1 = {"a": JP("data"), "b": {"c": None}, "d": [JP(), JP(None, "m")]}
        t2 = {"d": [P(), P(None, "m")], "b": {"c": None}, "a": P("data")}
        assert sr.spec_tree_digest(t1) == sr.spec_tree_digest(t2) == \
            jsr.spec_tree_digest(j1)
        assert sr.spec_tree_digest({"a": P(("x", "y"))}) == \
            jsr.spec_tree_digest({"a": JP(("x", "y"))})
        assert sr.spec_tree_digest({"a": None}) != \
            sr.spec_tree_digest({"a": P()})
        assert sr.spec_tree_digest({"a": None}) == \
            jsr.spec_tree_digest({"a": None})

    def test_global_digest_equals_the_reference_and_tracks_registration(self):
        from paddle_tpu.distributed import sharding_rules as jsr
        d0 = sr.sharding_rules_digest()
        assert d0 == jsr.sharding_rules_digest()
        rules = sr.ShardingRules([(r".*", ("data",))], name="test_digest")
        jrules = jsr.ShardingRules([(r".*", ("data",))], name="test_digest")
        try:
            sr.register_rules(rules)
            jsr.register_rules(jrules)
            d1 = sr.sharding_rules_digest()
            assert d1 != d0 and d1 == jsr.sharding_rules_digest()
            sr.register_rules(rules)
            assert sr.sharding_rules_digest() == d1
        finally:
            sr.unregister_rules("test_digest")
            jsr.unregister_rules("test_digest")
        assert sr.sharding_rules_digest() == d0


class TestUpdateShardingRules:
    def test_rule_table_layout_equals_the_reference(self):
        from paddle_tpu.distributed.update_sharding import \
            update_sharding_rules as jrules
        tree = {"params": {"w": np.zeros((8,))},
                "opt": {"step": np.zeros(()),
                        "slots": {"flat": np.zeros((16,))}},
                "comm_e": np.zeros((2, 16))}
        specs = update_sharding_rules("data").resolve(tree)
        assert specs["params"]["w"] == P()
        assert specs["opt"]["step"] == P()
        assert specs["opt"]["slots"]["flat"] == P("data")
        assert specs["comm_e"] == P("data")
        _same(specs, jrules("data").resolve(tree))
        assert update_sharding_rules("data").digest() == \
            jrules("data").digest()

    def test_guards_refuse_unsupported_optimizers_and_meshes(self):
        from paddle_tpu_torch.distributed.update_sharding import \
            make_dp_update_sharded_train_step
        from paddle_tpu_torch.nn import ClipGradByGlobalNorm
        import paddle_tpu_torch.optimizer as TO
        params = {"w": torch.zeros(8, 4)}
        loss = lambda p, x: (p["w"] * x).sum()   # noqa: E731
        mesh = _mesh(2)
        with pytest.raises(NotImplementedError, match="grad_clip"):
            make_dp_update_sharded_train_step(
                loss, params, TO.Adam(0.05, grad_clip=ClipGradByGlobalNorm(
                    1.0)), mesh)
        with pytest.raises(NotImplementedError, match="multi_precision"):
            make_dp_update_sharded_train_step(
                loss, params, TO.Adam(0.05, multi_precision=True), mesh)
        with pytest.raises(NotImplementedError, match="per-param-identity"):
            make_dp_update_sharded_train_step(loss, params, TO.Lamb(0.05),
                                              mesh)
        hybrid = _mesh(4, ("data", "model"), (2, 2))
        with pytest.raises(NotImplementedError, match="non-trivial axes"):
            make_dp_update_sharded_train_step(loss, params, TO.Adam(0.05),
                                              hybrid)
