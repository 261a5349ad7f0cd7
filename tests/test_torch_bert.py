"""Port parity for BERT pretraining (paddle_tpu_torch/models/bert.py): a
tiny BERT built from the JAX model's weights (``params_from_numpy``) is fed
the same numpy inputs as the JAX package.

With ``FLAGS_use_fused_ln`` on, the JAX side runs the fused LN's Pallas
kernels in interpret mode (``FLAGS_fused_ln_interpret``) and the port its
plain versions; the flags are reset after each test.

Tolerances: ``forward`` h and pooled fp32 atol 1e-5 (the same math, other
summation orders; the port's CPU attention is the flash path's plain
version, the reference's the dense path).  ``pretrain_loss_fn`` 1e-5
relative.  The 10-step trajectory: losses within 1e-5 relative, final
parameters within atol 1e-5 (Adam's normalised step turns a last-bit
gradient difference on a near-zero gradient into up to 2·lr).  One bf16
step within 2e-2 relative on the loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as JO
from paddle_tpu.core.flags import set_flags as j_set_flags
from paddle_tpu.models.bert import BertConfig as JConfig
from paddle_tpu.models.bert import BertModel as JModel
from paddle_tpu.models.bert import make_bert_train_step as j_make_step
import paddle_tpu_torch.optimizer as TO
from paddle_tpu_torch.core import flags as TFL
from paddle_tpu_torch.distributed.topology import ProcessMesh
from paddle_tpu_torch.models import bert as TB
from paddle_tpu_torch.optimizer import opt_state_from_numpy
from paddle_tpu_torch.ops import fused as TF

TINY = dict(vocab_size=512, hidden_size=128, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=128)
B, L = 2, 128


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Run the port's CPU ops on one thread, then restore the count: the
    suite runs six workers on the cores, and a worker spreading small
    ops over every core spends its time in OpenMP's barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fused_ln():
    def set_on(on):
        j_set_flags({"FLAGS_use_fused_ln": on,
                     "FLAGS_fused_ln_interpret": on})
        TFL.set_flags({"FLAGS_use_fused_ln": on})
    yield set_on
    set_on(False)


def _hcg():
    from paddle_tpu.distributed import fleet
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                               "pp_degree": 1}
    fleet.init(is_collective=True, strategy=strategy)
    return fleet.get_hybrid_communicate_group()


def _pair(compute_dtype="float32", seed=0):
    paddle.seed(seed)
    kw = dict(TINY, compute_dtype=compute_dtype)
    jm = JModel(JConfig(**kw))
    state = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    return jm, TB.params_from_numpy(state, TB.BertConfig(**kw), device="cpu")


def _batch(seed=0, n_ignored=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, TINY["vocab_size"], (B, L))
    mlm = rng.randint(0, TINY["vocab_size"], (B, L))
    mlm.reshape(-1)[rng.permutation(B * L)[:n_ignored]] = -100
    return ids, mlm, rng.randint(0, 2, (B,))


def _padding_mask():
    am = np.ones((B, L), np.int32)
    am[0, 100:] = 0
    am[1, 37:] = 0
    return am


class TestForward:
    @pytest.mark.parametrize("masked", [False, True])
    def test_matches_reference(self, masked):
        jm, tm = _pair(seed=1)
        ids, _, _ = _batch(1)
        am = _padding_mask() if masked else None
        jh, jp = jm(jnp.asarray(ids),
                    attention_mask=None if am is None else jnp.asarray(am))
        with torch.no_grad():
            th, tp = tm(torch.tensor(ids),
                        attention_mask=None if am is None
                        else torch.tensor(am))
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                                   atol=1e-5)

    @pytest.mark.parametrize("flag_on", [False, True])
    def test_pretrain_loss_matches_reference(self, fused_ln, flag_on):
        fused_ln(flag_on)
        jm, tm = _pair(seed=2)
        ids, mlm, nsp = _batch(2, n_ignored=100)
        params = {n: p._data for n, p in jm.named_parameters()}
        jl = jm.pretrain_loss_fn(params, jnp.asarray(ids), jnp.asarray(mlm),
                                 jnp.asarray(nsp),
                                 attention_mask=jnp.asarray(_padding_mask()))
        tl = tm.pretrain_loss_fn(torch.tensor(ids), torch.tensor(mlm),
                                 torch.tensor(nsp),
                                 attention_mask=torch.tensor(_padding_mask()))
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
        jm_only = jm.pretrain_loss_fn(params, jnp.asarray(ids),
                                      jnp.asarray(mlm))
        tm_only = tm.pretrain_loss_fn(torch.tensor(ids), torch.tensor(mlm))
        np.testing.assert_allclose(tm_only.item(), float(jm_only), rtol=1e-5)

    def test_mlm_logits_match_reference(self):
        jm, tm = _pair(seed=3)
        ids, _, _ = _batch(3)
        params = {n: p._data for n, p in jm.named_parameters()}
        jlog = jm.mlm_logits(params, jm.encode(params, jnp.asarray(ids)))
        with torch.no_grad():
            tlog = tm.mlm_logits(tm.encode(torch.tensor(ids)))
        assert tlog.dtype == torch.float32
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                                   atol=1e-5)


class TestEpilogue:
    def test_fused_matches_plain(self, fused_ln):
        """The wiring preserves the numerics: encode with the flag on (the
        kernels' plain versions) matches the flag-off ``_ln`` path."""
        _, tm = _pair(seed=4)
        ids = torch.tensor(_batch(4)[0])
        with torch.no_grad():
            plain = tm.encode(ids)
            fused_ln(True)
            fused = tm.encode(ids)
        torch.testing.assert_close(fused, plain, rtol=2e-5, atol=2e-5)

    @pytest.mark.parametrize("flag_on", [False, True])
    def test_flag_routes_every_block_epilogue(self, fused_ln, monkeypatch,
                                              flag_on):
        fused_ln(flag_on)
        calls = []
        real = TF._FusedLN.apply
        monkeypatch.setattr(TF._FusedLN, "apply",
                            lambda *a: calls.append(1) or real(*a))
        _, tm = _pair(seed=5)
        ids, mlm, nsp = (torch.tensor(a) for a in _batch(5))
        tm.pretrain_loss_fn(ids, mlm, nsp).backward()
        assert len(calls) == (2 * TINY["num_hidden_layers"] if flag_on else 0)


class TestTrainStep:
    @pytest.mark.parametrize("remat", [False, True])
    @pytest.mark.parametrize("flag_on", [False, True])
    def test_ten_step_trajectory_matches_reference(self, fused_ln, flag_on,
                                                   remat):
        fused_ln(flag_on)
        jm, tm = _pair(seed=6)
        jstep, jstate = j_make_step(jm, JO.AdamW(1e-4, weight_decay=0.01),
                                    _hcg(), remat=remat)
        tstep, tstate = TB.make_bert_train_step(
            tm, TO.AdamW(1e-4, weight_decay=0.01), None, remat=remat)
        # both sides start from the same optimizer state, carried over
        tstate["opt"] = opt_state_from_numpy(
            jax.tree_util.tree_map(np.asarray, jstate["opt"]), device="cpu")
        jl, tl = [], []
        for i in range(10):
            ids, mlm, nsp = _batch(10 + i, n_ignored=40)
            jstate, loss = jstep(jstate, np.float32(1e-4), jnp.asarray(ids),
                                 jnp.asarray(mlm), jnp.asarray(nsp))
            jl.append(float(loss))
            tstate, loss = tstep(tstate, 1e-4, torch.tensor(ids),
                                 torch.tensor(mlm), torch.tensor(nsp))
            tl.append(float(loss))
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        assert int(tstate["opt"]["step"]) == 10
        for n, p in tm.named_parameters():
            assert tstate["params"][n] is p             # updated in place
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jstate["params"][n]),
                                       rtol=0, atol=1e-5, err_msg=n)

    def test_bf16_step(self, fused_ln):
        fused_ln(True)
        jm, tm = _pair("bfloat16", seed=7)
        jstep, jstate = j_make_step(jm, JO.AdamW(1e-4, weight_decay=0.01),
                                    _hcg(), remat=False)
        tstep, tstate = TB.make_bert_train_step(
            tm, TO.AdamW(1e-4, weight_decay=0.01), remat=False)
        ids, mlm, nsp = _batch(7)
        _, jloss = jstep(jstate, np.float32(1e-4), jnp.asarray(ids),
                         jnp.asarray(mlm), jnp.asarray(nsp))
        _, tloss = tstep(tstate, 1e-4, torch.tensor(ids), torch.tensor(mlm),
                         torch.tensor(nsp))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-2)

    def test_bf16_backward_reaches_every_parameter(self, fused_ln):
        fused_ln(True)
        tm = TB.BertModel(TB.BertConfig(**TINY, compute_dtype="bfloat16"),
                          device="cpu",
                          generator=torch.Generator().manual_seed(0))
        ids, mlm, nsp = (torch.tensor(a) for a in _batch(8))
        tm.pretrain_loss_fn(ids, mlm, nsp).backward()
        for n, p in tm.named_parameters():
            if n == "type_emb":
                assert p.grad[0].abs().sum() > 0 and p.grad[1].eq(0).all()
            else:
                assert p.grad is not None and p.grad.abs().sum() > 0, n

    def test_unported_options_raise(self):
        _, tm = _pair()
        opt = TO.AdamW(1e-4)

        class TwoWay:
            def get_model_parallel_world_size(self):
                return 2

        class TwoSep:
            def get_sep_parallel_world_size(self):
                return 2

        # model degrees run (tests/test_torch_bert_tp.py); ZeRO over model
        # ranks and sep degrees wait for ROADMAP A7b
        with pytest.raises(NotImplementedError, match="A7b"):
            TB.make_bert_train_step(tm, opt, TwoWay(), zero_stage=1)
        with pytest.raises(NotImplementedError, match="A7b"):
            TB.make_bert_train_step(tm, opt, TwoSep())
        # donate=False (ported): a fresh state, the model untouched, the
        # donated step's loss
        _, ta = _pair()
        own = {n: p.detach().clone() for n, p in tm.named_parameters()}
        kept, s0 = TB.make_bert_train_step(tm, TO.AdamW(1e-4), donate=False)
        donated, sa = TB.make_bert_train_step(ta, TO.AdamW(1e-4))
        batch = [torch.tensor(a) for a in _batch(3)]
        s1, lk = kept(s0, 1e-4, *batch)
        _, ld = donated(sa, 1e-4, *batch)
        assert float(lk) == pytest.approx(float(ld), rel=1e-6)
        for n, p in tm.named_parameters():
            assert torch.equal(p.detach(), own[n]) and s0["params"][n] is p
            torch.testing.assert_close(s1["params"][n],
                                       dict(ta.named_parameters())[n]
                                       .detach(), rtol=1e-5, atol=1e-6)
        # ported: the sharded-init builder (tests/test_torch_dp_bert.py);
        # a pipeline degree (ROADMAP A7c) holds the pipe axis replicated,
        # as the reference's BERT steps do: rank 0 of two stages keeps
        # every parameter whole
        step, st = TB.make_sharded_bert_train_step(
            TB.BertConfig(**TINY), opt, None, device="cpu")
        assert set(st) == {"params", "opt", "buffers"}

        class TwoStages:
            mesh = ProcessMesh(("data", "pipe", "sharding", "sep", "model"),
                               (1, 2, 1, 1, 1), rank=0)

            def get_pipe_parallel_world_size(self):
                return 2

        step, st = TB.make_sharded_bert_train_step(
            TB.BertConfig(**TINY), opt, TwoStages(), device="cpu")
        assert "pipe" not in str(step.layout.specs)
        for n, p in st["params"].items():
            assert p.shape == dict(tm.named_parameters())[n].shape, n
        with pytest.raises(ValueError, match="remat"):
            tm.scan_blocks(torch.zeros(1, 8, 128), remat="dots")
        with pytest.raises(ValueError, match="hidden_act"):
            TB.BertConfig(**TINY, hidden_act="relu")
        with pytest.raises(ValueError, match="compute_dtype"):
            TB.BertConfig(**TINY, compute_dtype="int8")


class TestModelSurface:
    def test_names_and_presets_match_reference(self):
        paddle.seed(0)
        jm = JModel(JConfig(**TINY))
        tm = TB.BertModel(TB.BertConfig(**TINY), device="meta")
        assert [n for n, _ in tm.named_parameters()] == \
            [n for n, _ in jm.named_parameters()]
        assert TB.BertModel.stacked_param_names() == \
            JModel.stacked_param_names()
        cfg = TB.bert_preset("bert-large", vocab_size=1000)
        assert (cfg.hidden_size, cfg.num_hidden_layers,
                cfg.num_attention_heads, cfg.intermediate_size,
                cfg.layer_norm_eps) == (1024, 24, 16, 4096, 1e-12)

    def test_params_from_numpy_refuses_wrong_names(self):
        jm, _ = _pair()
        state = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
        state["extra"] = state.pop("nsp_b")
        with pytest.raises(ValueError, match="nsp_b"):
            TB.params_from_numpy(state, TB.BertConfig(**TINY), device="cpu")

    def test_default_device_needs_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            TB.BertModel(TB.BertConfig(**TINY))

    def test_additive_mask(self):
        m = TB.BertModel._additive_mask(torch.tensor([[1, 1, 0]]))
        assert m.shape == (1, 1, 1, 3) and m[0, 0, 0, 2] == -1e30
        assert m[0, 0, 0, :2].eq(0).all()
        assert TB.BertModel._additive_mask(None) is None
