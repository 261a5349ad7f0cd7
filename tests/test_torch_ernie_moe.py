"""Port parity for ERNIE-MoE (paddle_tpu_torch/models/ernie_moe.py) against
``paddle_tpu/models/ernie_moe.py`` on the same numpy weights, at the
reference tests' widths (hidden 32, 2 layers, 4 experts, top-2, vocab
under 130): forward logits and loss, a 10-step training trajectory with
AdamW under a scheduler and a global-norm clip (remat on and off),
``prefill``/``decode_step``/``decode_ragged``, ``generate()``,
``generate_speculative`` with a GPT draft, the greedy streams of the
four engines with an ERNIE-MoE target against the JAX engines (the cases
of ``tests/test_serving_ragged.py:392``, ``test_serving_engine.py:445``,
``test_serving_speculative.py:204`` and ``test_generate.py:745``), and
the ``.genmodel`` artifact.

Tolerances: fp32 logits and hidden states 1e-5; the trajectory's losses
1e-5 relative and final parameters 1e-5 absolute (the bound of the GPT
trajectory, ``tests/test_torch_train.py``); token streams equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.clip as JC
import paddle_tpu.optimizer as JO
from paddle_tpu.models.ernie_moe import ErnieMoeConfig as JCfg
from paddle_tpu.models.ernie_moe import ErnieMoeModel as JModel
from paddle_tpu.models.ernie_moe import make_ernie_moe_train_step as j_step
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTModel as JGPT
from paddle_tpu.serving import ContinuousBatchingEngine as JContiguous
from paddle_tpu.serving import PagedContinuousBatchingEngine as JPaged
from paddle_tpu.serving_paged import \
    RaggedPagedContinuousBatchingEngine as JRagged
import paddle_tpu_torch.nn.clip as TC
import paddle_tpu_torch.optimizer as TO
from paddle_tpu_torch.models import ernie_moe as TE
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models._decode import (load_generate_program,
                                             save_generate_program)
from paddle_tpu_torch.serving import ContinuousBatchingEngine as TContiguous
from paddle_tpu_torch.serving_paged import (
    PagedContinuousBatchingEngine as TPaged,
    RaggedPagedContinuousBatchingEngine as TRagged)

TINY = dict(vocab_size=97, hidden_size=32, num_layers=2,
            num_attention_heads=4, num_experts=4, top_k=2,
            max_position_embeddings=96, initializer_range=0.2,
            compute_dtype="float32")
DRAFT = dict(vocab_size=97, hidden_size=32, num_layers=1,
             num_attention_heads=4, max_position_embeddings=96,
             initializer_range=0.2, compute_dtype="float32")
PROMPTS = [[5, 17, 3], [40, 2], [9, 8, 7, 1, 60, 33]]
BUDGETS = (7, 5, 6)


def _close(got, want, tol=1e-5, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=msg)


_MODELS = {}


def _models():
    """(jax ERNIE, its params, port ERNIE, jax GPT draft, its params, port
    GPT draft), built once; the JAX models are never changed."""
    if not _MODELS:
        paddle.seed(41)
        jm = JModel(JCfg(**TINY))
        params = {n: p._data for n, p in jm.named_parameters()}
        paddle.seed(79)
        jd = JGPT(JGPTConfig(**DRAFT))
        dparams = {n: p._data for n, p in jd.named_parameters()}
        td = TG.params_from_numpy({n: np.asarray(v) for n, v in
                                   dparams.items()}, TG.GPTConfig(**DRAFT),
                                  device="cpu")
        _MODELS["m"] = (jm, params, _fresh(params), jd, dparams, td)
    return _MODELS["m"]


def _fresh(params):
    """A port ERNIE-MoE holding ``params`` (the JAX model's)."""
    return TE.params_from_numpy({n: np.asarray(v) for n, v in params.items()},
                                TE.ErnieMoeConfig(**TINY), device="cpu")


def _solo(p, n):
    jm, params, tm, *_ = _models()
    want = np.asarray(jm.generate(params, jnp.asarray([p], jnp.int32), n,
                                  greedy=True))[0].tolist()
    assert tm.generate([p], n)[0].tolist() == want
    return want


# ------------------------------------------------------------ the model --

class TestModel:
    def test_params_from_numpy_names_and_layout(self):
        jm, params, tm, *_ = _models()
        state = {n: np.asarray(v) for n, v in params.items()}
        assert [n for n, _ in tm.named_parameters()] == \
            [n for n, _ in jm.named_parameters()]
        assert tuple(tm.blocks_expert_w1.shape) == (2, 4, 32, 128)
        assert TE.ErnieMoeModel.stacked_param_names() == \
            JModel.stacked_param_names()
        bad = dict(state)
        bad.pop("lnf_b")
        with pytest.raises(ValueError, match="missing"):
            TE.params_from_numpy(bad, TE.ErnieMoeConfig(**TINY),
                                 device="cpu")
        meta = TE.ErnieMoeModel(TE.ErnieMoeConfig(**TINY), device="meta")
        assert sum(p.numel() for p in meta.parameters()) == \
            sum(v.size for v in state.values())

    def test_forward_logits_and_loss(self):
        jm, params, *_ = _models()
        tm = _fresh(params)
        r = np.random.RandomState(0)
        ids, lbl = r.randint(0, 97, (2, 16)), r.randint(0, 97, (2, 16))
        _close(tm(torch.tensor(ids)), jm(jnp.asarray(ids)))
        tl = tm(torch.tensor(ids), labels=torch.tensor(lbl))
        jl = jm(jnp.asarray(ids), labels=jnp.asarray(lbl))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
        # the aux term is in the loss: a different weight moves it
        tm.config.aux_loss_weight = 1.0
        assert float(tm(torch.tensor(ids), labels=torch.tensor(lbl))) > \
            float(tl)

    @pytest.mark.parametrize("remat", [False, True])
    def test_ten_step_trajectory(self, remat):
        """AdamW under LinearWarmup(CosineAnnealingDecay) to a peak of
        3e-4 (the GPT trajectory's rate, which its 1e-5 parameter bound
        assumes: Adam's normalised step turns a last-bit gradient
        difference into up to 2·lr) with ClipGradByGlobalNorm(0.1), 10
        steps, the rate read from each side's scheduler."""
        jm, params, *_ = _models()
        tm = _fresh(params)
        hcg = _hcg()
        opts = {}
        for pkg, O, C in (("j", JO, JC), ("t", TO, TC)):
            sched = O.lr.LinearWarmup(O.lr.CosineAnnealingDecay(3e-4, 8),
                                      warmup_steps=3, start_lr=1e-5,
                                      end_lr=3e-4)
            opts[pkg] = O.AdamW(sched, weight_decay=0.01,
                                grad_clip=C.ClipGradByGlobalNorm(0.1))
        # the shared JAX model's arrays must outlive this step: no donation
        jstep, jstate = j_step(jm, opts["j"], hcg, remat=remat, donate=False)
        tstep, tstate = TE.make_ernie_moe_train_step(tm, opts["t"],
                                                     remat=remat)
        r = np.random.RandomState(1)
        # one batch throughout, so the loss must fall
        ids, lbl = r.randint(0, 97, (2, 32)), r.randint(0, 97, (2, 32))
        jl, tl = [], []
        for _ in range(10):
            lr = opts["t"].get_lr()
            assert lr == opts["j"].get_lr()
            jstate, loss = jstep(jstate, np.float32(lr), jnp.asarray(ids),
                                 jnp.asarray(lbl))
            jl.append(float(loss))
            tstate, loss = tstep(tstate, lr, torch.tensor(ids),
                                 torch.tensor(lbl))
            tl.append(float(loss))
            for o in opts.values():
                o._learning_rate.step()
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        assert tl[-1] < tl[0]
        for n, p in tm.named_parameters():
            assert tstate["params"][n] is p
            _close(p, jstate["params"][n], msg=n)

    def test_donate_false_and_unported(self):
        """donate=False follows the donated trajectory; what still waits
        for ROADMAP A7b (a sep degree, ZeRO with a split expert axis)
        raises, and the sharded step builds on one device (its mesh arms:
        tests/test_torch_ernie_moe_ep.py)."""
        params = _models()[1]
        ta, tb = _fresh(params), _fresh(params)
        sa, sta = TE.make_ernie_moe_train_step(ta, TO.AdamW(1e-3))
        sb, stb = TE.make_ernie_moe_train_step(tb, TO.AdamW(1e-3),
                                               donate=False)
        r = np.random.RandomState(2)
        for _ in range(2):
            ids = torch.tensor(r.randint(0, 97, (2, 16)))
            lbl = torch.tensor(r.randint(0, 97, (2, 16)))
            sta, la = sa(sta, 1e-3, ids, lbl)
            stb, lb = sb(stb, 1e-3, ids, lbl)
            assert float(la) == pytest.approx(float(lb), rel=1e-6)
        for n, p in ta.named_parameters():
            _close(stb["params"][n], p.detach().numpy(), msg=n)
            assert not torch.equal(dict(tb.named_parameters())[n], p)

        class TwoSep:
            def get_sep_parallel_world_size(self):
                return 2

        class TwoWay:
            def get_data_parallel_world_size(self):
                return 2

        with pytest.raises(NotImplementedError, match="A7b"):
            TE.make_ernie_moe_train_step(ta, TO.AdamW(1e-3), TwoSep())
        with pytest.raises(NotImplementedError, match="A7b item 3"):
            TE.make_sharded_ernie_moe_train_step(
                TE.ErnieMoeConfig(**TINY), TO.AdamW(1e-3), TwoWay(),
                zero_stage=1, device="cpu")
        _, st = TE.make_sharded_ernie_moe_train_step(
            TE.ErnieMoeConfig(**TINY), TO.AdamW(1e-3), None, device="cpu")
        assert set(st) == {"params", "opt", "buffers"}
        with pytest.raises(ValueError, match="remat"):
            ta.scan_blocks(torch.zeros(1, 8, 32), remat="dots")


def _hcg():
    from paddle_tpu.distributed import fleet
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                               "pp_degree": 1}
    fleet.init(is_collective=True, strategy=strategy)
    return fleet.get_hybrid_communicate_group()


# ------------------------------------------------------------- decoding --

class TestDecode:
    def test_prefill_and_decode_step(self):
        """A left-padded prompt through ``prefill`` (the port's gather
        dispatch against the reference's no-drop index dispatch), then 3
        ``decode_step``s (gather dispatch)."""
        jm, params, tm, *_ = _models()
        ids = np.asarray([[0, 0, 5, 17, 3, 9], [40, 2, 8, 8, 1, 60]])
        pads = np.asarray([2, 0], np.int32)
        jh, jc = jm.prefill(params, jnp.asarray(ids), 16,
                            pad_lens=jnp.asarray(pads))
        th, tc = tm.prefill(torch.tensor(ids), 16,
                            pad_lens=torch.tensor(pads))
        _close(th[:, 2:], np.asarray(jh)[:, 2:])
        for a, b in zip(tc, jc):
            _close(a[:, :, :6], np.asarray(b)[:, :, :6])
        tok = np.asarray([11, 23])
        for t in range(6, 9):
            jx = jm._embed_one(params, jnp.asarray(tok), t,
                               pad_lens=jnp.asarray(pads))
            tx = tm._embed_one(torch.tensor(tok), t,
                               pad_lens=torch.tensor(pads))
            jh, jc = jm.decode_step(params, jx, jc, t,
                                    pad_lens=jnp.asarray(pads))
            th, tc = tm.decode_step(tx, tc, t, pad_lens=torch.tensor(pads))
            jl = jm.decode_logits(params, jh)
            with torch.no_grad():
                tl = tm.decode_logits(th)
            _close(tl, jl)
            tok = np.asarray(jl)[:, 0].argmax(-1)

    def test_decode_ragged(self):
        """Two ragged packs: prefill chunks of two sequences (one
        left-padded) with padding rows, then a decode row each and a chunk
        of a third sequence."""
        jm, params, tm, *_ = _models()
        table = np.asarray([[3, 7, 1, 0], [2, 5, 0, 0], [4, 6, 8, 0]],
                           np.int32)
        pads = np.asarray([2, 4, 0], np.int32)
        r = np.random.RandomState(0)
        jpools = tuple(jnp.zeros((2, 9, 4, 4, 8)) for _ in range(2))
        tpools = tuple(torch.zeros(2, 9, 4, 4, 8) for _ in range(2))
        for rows in ([(0, p) for p in range(8)] + [(2, p) for p in range(5)],
                     [(0, 8), (2, 5)] + [(1, p) for p in range(4, 7)]):
            toks = np.zeros(16, np.int32)
            seq = np.full(16, -1, np.int32)
            pos = np.full(16, -1, np.int32)
            for i, (s, p) in enumerate(rows):
                toks[i], seq[i], pos[i] = r.randint(1, 97), s, p
            j = [jnp.asarray(a) for a in (toks, seq, pos, pads, table)]
            t = [torch.from_numpy(a) for a in (toks, seq, pos, pads, table)]
            jh = jm._embed_ragged(params, j[0], j[1], j[2], j[3])
            jh, jpools = jm.decode_ragged(params, jh, jpools, j[4], j[1],
                                          j[2], j[3])
            th = tm._embed_ragged(t[0], t[1], t[2], t[3])
            th, tpools = tm.decode_ragged(th, tpools, t[4], t[1], t[2], t[3])
            real = [i for i in range(len(rows)) if pos[i] >= pads[seq[i]]]
            _close(th[0, real], np.asarray(jh)[0, real])
        for a, b in zip(tpools, jpools):
            _close(a, b)

    def test_generate_and_speculative(self):
        jm, params, tm, jd, dparams, td = _models()
        prompt = np.random.RandomState(92).randint(0, 97, (2, 4))
        want = np.asarray(jm.generate(params, jnp.asarray(prompt), 8,
                                      greedy=True))
        np.testing.assert_array_equal(tm.generate(prompt, 8), want)
        jsp = jm.generate_speculative(params, jnp.asarray(prompt[:1]), 8, jd,
                                      dparams, draft_k=2)
        tsp = tm.generate_speculative(prompt[:1], 8, td, draft_k=2)
        np.testing.assert_array_equal(np.asarray(tsp), np.asarray(jsp))
        np.testing.assert_array_equal(np.asarray(tsp), want[:1])


# -------------------------------------------------------------- engines --

def _drive(eng, step_after=None):
    rids = []
    for i, (p, n) in enumerate(zip(PROMPTS, BUDGETS)):
        rids.append(eng.add_request(p, n))
        if i == step_after:
            eng.step()
    got = eng.run_to_completion(max_ticks=300)
    return [got[r] for r in rids]


class TestEngines:
    @pytest.mark.parametrize("kind", ["ragged", "ragged_gpt_draft",
                                      "paged", "contiguous"])
    def test_greedy_streams_match_jax_engine(self, kind):
        jm, params, tm, jd, dparams, td = _models()
        if kind.startswith("ragged"):
            kw = dict(max_slots=2, max_len=48, block_size=4,
                      prompt_buckets=[8])
            extra = (dict(draft_model=jd, draft_params=dparams, draft_k=2),
                     dict(draft_model=td, draft_k=2)) \
                if kind.endswith("draft") else ({}, {})
            jeng = JRagged(jm, params, **kw, **extra[0])
            teng = TRagged(tm, device="cpu", **kw, **extra[1])
        elif kind == "paged":
            kw = dict(max_slots=2, max_len=32, block_size=4,
                      prompt_buckets=[8], ticks_per_sync=2)
            jeng, teng = JPaged(jm, params, **kw), TPaged(tm, device="cpu",
                                                          **kw)
        else:
            kw = dict(max_slots=2, max_len=32, prompt_buckets=[8],
                      ticks_per_sync=2)
            jeng = JContiguous(jm, params, **kw)
            teng = TContiguous(tm, device="cpu", **kw)
        want = _drive(jeng, step_after=1)
        got = _drive(teng, step_after=1)
        assert got == want == [_solo(p, n) for p, n in zip(PROMPTS, BUDGETS)]
        if kind == "ragged_gpt_draft":
            assert teng.spec_rounds == jeng.spec_rounds > 0
            assert teng.tokens_accepted == jeng.tokens_accepted
        if kind != "contiguous":
            assert teng.blocks_in_use == 0


# ------------------------------------------------ repairs of the parent --

class TestRepairs:
    def test_config_without_kv_cache_dtype(self):
        """A config with no ``kv_cache_dtype`` (ERNIE-MoE's has none)
        builds caches and pools in the compute dtype; the engines and
        ``init_cache`` read it as optional, as the reference does."""
        cfg = TG.GPTConfig(**DRAFT)
        del cfg.kv_cache_dtype
        model = TG.GPTModel(cfg, device="cpu")
        ck, cv = model.init_cache(2, 16)
        assert ck.dtype == torch.float32 and ck.shape == (1, 2, 16, 4, 8)
        eng = TPaged(model, max_slots=2, max_len=32, block_size=4,
                     prompt_buckets=[8], device="cpu")
        rid = eng.add_request([5, 6, 7], 3)
        assert len(eng.run_to_completion(max_ticks=50)[rid]) == 3

    def test_genmodel_round_trip(self, tmp_path):
        """``save_generate_program``/``load_generate_program`` rebuild an
        ERNIE-MoE from its config and numpy parameters."""
        _, _, tm, *_ = _models()
        prompt = np.asarray([[5, 17, 3, 9]])
        path = str(tmp_path / "moe")
        save_generate_program(tm, path, prompt_len=4, max_new_tokens=6)
        fn, meta = load_generate_program(path, device="cpu")
        assert meta["max_new_tokens"] == 6
        np.testing.assert_array_equal(np.asarray(fn(prompt)),
                                      tm.generate(prompt, 6))
        with open(path + ".genmodel", "rb") as f:
            import pickle
            spec = pickle.load(f)
        assert (spec["module"], spec["model"]) == (
            "paddle_tpu_torch.models.ernie_moe", "ErnieMoeModel")
        spec["module"], spec["model"] = "paddle_tpu_torch.models.bert", \
            "BertModel"
        with open(path + ".genmodel", "wb") as f:
            pickle.dump(spec, f)
        with pytest.raises(ValueError, match="models.bert.BertModel"):
            load_generate_program(path, device="cpu")
