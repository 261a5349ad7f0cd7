"""Port parity for the rest of the optimizer surface: the ten optimizers'
functional ``update`` and eager ``step()``, the three gradient clips, the
eager ``state_dict``, and the train step's ``donate=False`` and
``n_microbatches`` — each against the JAX package on the same numpy
inputs.

Tolerances: fp32 rtol 1e-6 with atol 1e-7 over 5 functional or 3 eager
steps (the same rules; sqrt, pow and the norms may differ in the last
bit); bf16 parameters within one bf16 step (2^-7 relative) and fp32
masters within 1e-6; clips fp32 1e-6, bf16 gradients 2^-7.  The GPT
steps: losses within 1e-5 relative (``tests/test_torch_train.py``'s
trajectory bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.clip as JC
import paddle_tpu.optimizer as JO
from paddle_tpu.core.tensor import Parameter as JParam
from paddle_tpu.models.gpt import GPTConfig as JConfig
from paddle_tpu.models.gpt import GPTModel as JModel
from paddle_tpu.models.gpt import make_gpt_train_step as j_make_step
import paddle_tpu_torch.nn.clip as TC
import paddle_tpu_torch.optimizer as TO
from paddle_tpu_torch.models.gpt import (GPTConfig, make_gpt_train_step,
                                         params_from_numpy)
from paddle_tpu_torch.optimizer import opt_state_from_numpy

RTOL, ATOL = 1e-6, 1e-7
BF16_RTOL = 2.0 ** -7
SHAPES = {"w": (4, 3), "bias": (5,), "emb": (2, 3, 2)}

OPTS = {
    "sgd": lambda m, **kw: m.SGD(0.05, **kw),
    "momentum": lambda m, **kw: m.Momentum(0.05, momentum=0.9,
                                           use_nesterov=True,
                                           weight_decay=0.01, **kw),
    "adam": lambda m, **kw: m.Adam(0.01, **kw),
    "adamw": lambda m, **kw: m.AdamW(0.01, weight_decay=0.05, **kw),
    "adamax": lambda m, **kw: m.Adamax(0.01, **kw),
    "adagrad": lambda m, **kw: m.Adagrad(0.05, initial_accumulator_value=0.1,
                                         **kw),
    "adadelta": lambda m, **kw: m.Adadelta(1.0, rho=0.9, **kw),
    "rmsprop": lambda m, **kw: m.RMSProp(0.01, momentum=0.5, **kw),
    "rmsprop_centered": lambda m, **kw: m.RMSProp(0.01, momentum=0.5,
                                                  centered=True, **kw),
    "lamb": lambda m, **kw: m.Lamb(0.01, lamb_weight_decay=0.02, **kw),
    "lars": lambda m, **kw: m.Lars(0.1, momentum=0.9, lars_coeff=0.01,
                                   lars_weight_decay=0.001,
                                   exclude_from_weight_decay=["bias"], **kw),
}
CLIPS = {"value": lambda m: m.ClipGradByValue(0.05),
         "norm": lambda m: m.ClipGradByNorm(0.5),
         "global": lambda m: m.ClipGradByGlobalNorm(0.5)}


def _arrays(seed, scale=1.0):
    r = np.random.RandomState(seed)
    return {n: (scale * r.standard_normal(s)).astype(np.float32)
            for n, s in SHAPES.items()}


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=msg)


def _t2n(t):
    return t.detach().float().numpy()


# ------------------------------------------------------------ functional --

def _functional(name, dtype_j, dtype_t, clip=None, steps=5, **kw):
    jo = OPTS[name](JO, grad_clip=None if clip is None else CLIPS[clip](JC),
                    **kw)
    to = OPTS[name](TO, grad_clip=None if clip is None else CLIPS[clip](TC),
                    **kw)
    p0 = _arrays(0)
    jp = {n: jnp.asarray(v, dtype_j) for n, v in p0.items()}
    tp = {n: torch.tensor(v).to(dtype_t) for n, v in p0.items()}
    js, ts = jo.init_state(jp), to.init_state(tp)
    for i in range(steps):
        g = _arrays(10 + i, 0.3)
        jp, js = jo.update({n: jnp.asarray(v, dtype_j) for n, v in g.items()},
                           js, jp, lr=None)
        tp, ts = to.update({n: torch.tensor(v).to(dtype_t)
                            for n, v in g.items()}, ts, tp)
    assert int(ts["step"]) == int(js["step"]) == steps
    return jp, js, tp, ts


@pytest.mark.parametrize("clip", [None, "global"])
@pytest.mark.parametrize("name", sorted(OPTS))
def test_functional_update_matches_reference(name, clip):
    jp, js, tp, ts = _functional(name, jnp.float32, torch.float32, clip)
    for n in SHAPES:
        _close(_t2n(tp[n]), jp[n], msg=f"{name} {n}")
        assert set(ts["slots"][n]) == set(js["slots"][n])
        for k, v in ts["slots"][n].items():
            _close(_t2n(v), js["slots"][n][k], msg=f"{name} {n}.{k}")


@pytest.mark.parametrize("name", ["lamb", "lars"])
def test_multi_precision_bf16(name):
    """bf16 parameters with ``multi_precision``: Lars keeps an fp32 master
    and fp32 velocity; Lamb does not pass the flag on (the reference's
    constructor drops it), so its moments stay bf16."""
    jp, js, tp, ts = _functional(name, jnp.bfloat16, torch.bfloat16,
                                 multi_precision=True)
    for n in SHAPES:
        assert tp[n].dtype == torch.bfloat16
        _close(_t2n(tp[n]), jp[n], rtol=BF16_RTOL, atol=1e-6, msg=n)
        assert set(ts["slots"][n]) == set(js["slots"][n])
        for k, v in ts["slots"][n].items():
            assert str(v.dtype).split(".")[-1] == js["slots"][n][k].dtype.name
            tol = RTOL if v.dtype == torch.float32 else BF16_RTOL
            _close(_t2n(v), js["slots"][n][k], rtol=tol, atol=1e-6,
                   msg=f"{n}.{k}")
    assert ("master" in ts["slots"]["w"]) == (name == "lars")


def test_lars_excludes_by_name():
    """``exclude_from_weight_decay`` matches name substrings: "bias" takes
    wd 0, so it moves as with lars_weight_decay 0, and "w" does not."""
    out = []
    for wd in (0.001, 0.0):
        opt = TO.Lars(0.1, momentum=0.9, lars_coeff=0.01,
                      lars_weight_decay=wd, exclude_from_weight_decay=["bias"])
        tp = {n: torch.tensor(v) for n, v in _arrays(0).items()}
        ts = opt.init_state(tp)
        for i in range(3):
            tp, ts = opt.update({n: torch.tensor(v) for n, v in
                                 _arrays(10 + i, 0.3).items()}, ts, tp)
        out.append(tp)
    assert torch.equal(out[0]["bias"], out[1]["bias"])
    assert not torch.equal(out[0]["w"], out[1]["w"])


# ----------------------------------------------------------------- clips --

@pytest.mark.parametrize("form", ["eager", "dict"])
@pytest.mark.parametrize("clip", sorted(CLIPS))
def test_clip_matches_reference(clip, form):
    g = _arrays(3)
    g16 = {"half": np.random.RandomState(4).standard_normal(7)
           .astype(np.float32)}
    jg = {**{n: jnp.asarray(v) for n, v in g.items()},
          "half": jnp.asarray(g16["half"], jnp.bfloat16)}
    tg = {**{n: torch.tensor(v) for n, v in g.items()},
          "half": torch.tensor(g16["half"]).to(torch.bfloat16)}
    jc, tc = CLIPS[clip](JC), CLIPS[clip](TC)
    if form == "eager":
        jg["none"], tg["none"] = None, None
        jo, to = jc._clip_eager([], jg), tc._clip_eager([], tg)
        assert to["none"] is None
    else:
        jo, to = jc._clip_pytree(jg), tc._clip_pytree(tg)
    for n in jg:
        if jg[n] is None:
            continue
        assert to[n].dtype == tg[n].dtype
        tol = BF16_RTOL if n == "half" else RTOL
        _close(_t2n(to[n]), jo[n], rtol=tol, atol=1e-7, msg=n)
    if clip != "value":   # the clip bites
        assert not torch.equal(to["w"], tg["w"])


def test_global_norm_axes_raise():
    """``axes`` is ported: the squared norm is summed over those axes'
    groups of the active hybrid group; with none (one process) the clip
    equals the clip without axes, and nothing raises."""
    g = {"w": torch.tensor([3.0, 4.0]), "b": torch.tensor([12.0])}
    plain = TC.ClipGradByGlobalNorm(1.0)._clip_pytree(g)
    axed = TC.ClipGradByGlobalNorm(1.0, axes=("model",))._clip_pytree(g)
    for k in g:
        assert torch.equal(axed[k], plain[k])
    torch.testing.assert_close(plain["b"], torch.tensor([12.0 / 13.0]))


# ----------------------------------------------------------------- eager --

def _eager_pair(name, names=("w", "bias", None), sched=True, clip="global"):
    """Reference Parameters and port parameters from the same values, and
    an optimizer over each (a StepDecay scheduler, a global-norm clip);
    the third parameter has ``optimize_attr`` lr 0.5, a fourth is frozen."""
    p0 = _arrays(0)
    vals = [p0["w"], p0["bias"], p0["emb"], p0["bias"] + 1]
    jps, tps = [], []
    for i, v in enumerate(vals):
        nm = names[i] if i < len(names) else None
        jp = JParam(jnp.asarray(v), name=nm, trainable=i < 3)
        tp = torch.nn.Parameter(torch.tensor(v), requires_grad=i < 3)
        if i == 2:
            jp.optimize_attr = {"learning_rate": 0.5}
            tp.optimize_attr = {"learning_rate": 0.5}
        jps.append(jp)
        tps.append(tp)
    # the port names a parameter by a (name, param) pair
    named = [tp if nm is None else (nm, tp) for tp, nm in
             zip(tps, list(names) + [None] * (len(tps) - len(names)))]
    kw = {}
    mk = {}
    for pkg, lrmod, cmod, ps in (("j", JO.lr, JC, jps),
                                 ("t", TO.lr, TC, named)):
        lr = lrmod.StepDecay(0.05, step_size=2, gamma=0.5) if sched else None
        kw = dict(parameters=ps,
                  grad_clip=None if clip is None else CLIPS[clip](cmod))
        mod = JO if pkg == "j" else TO
        opt = OPTS[name](mod, **kw)
        if lr is not None:
            opt.set_lr_scheduler(lr)
        mk[pkg] = opt
    return jps, tps, mk["j"], mk["t"]


def _eager_steps(jps, tps, jo, to, seed, n):
    for s in range(n):
        r = np.random.RandomState(seed + s)
        for jp, tp in zip(jps[:3], tps[:3]):
            g = (0.3 * r.standard_normal(tp.shape)).astype(np.float32)
            jp._grad = jnp.asarray(g)
            tp.grad = torch.tensor(g)
        jo.step()
        to.step()
        for sched in {id(o._learning_rate): o._learning_rate
                      for o in (jo, to)
                      if isinstance(o._learning_rate,
                                    (JO.lr.LRScheduler,
                                     TO.lr.LRScheduler))}.values():
            sched.step()


def _same_params(jps, tps, msg=""):
    for i, (jp, tp) in enumerate(zip(jps, tps)):
        _close(_t2n(tp), jp._data, msg=f"{msg} param {i}")


@pytest.mark.parametrize("name", sorted(OPTS))
def test_eager_step_matches_reference(name):
    jps, tps, jo, to = _eager_pair(name)
    _eager_steps(jps, tps, jo, to, seed=20, n=3)
    _same_params(jps, tps, name)
    assert torch.equal(tps[3], torch.tensor(_arrays(0)["bias"] + 1))
    jsd, tsd = jo.state_dict(), to.state_dict()
    assert set(tsd) == set(jsd) and tsd["__step__"] == jsd["__step__"] == 3
    assert tsd["LR_Scheduler"] == jsd["LR_Scheduler"]
    for k, v in tsd.items():
        if isinstance(v, torch.Tensor):
            _close(_t2n(v), jsd[k].numpy(), msg=k)
    to.clear_grad()
    assert all(p.grad is None for p in tps)


def _to_numpy_sd(sd):
    return {k: (v if k in ("__step__", "LR_Scheduler")
                else (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                      else np.asarray(v.numpy())))
            for k, v in sd.items()}


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("name", ["adam", "rmsprop_centered", "lars"])
def test_state_dict_across_packages(name, direction):
    """3 eager steps on both, then one side's ``state_dict`` (through
    numpy, the scheduler inside) into a fresh optimizer of the other over
    parameters holding the same values; 2 more steps on both agree."""
    jps, tps, jo, to = _eager_pair(name, names=("w", None, "emb"))
    _eager_steps(jps, tps, jo, to, seed=30, n=3)
    jps2, tps2, jo2, to2 = _eager_pair(name, names=("w", None, "emb"))
    for jp, tp, jp2, tp2 in zip(jps, tps, jps2, tps2):
        jp2._data = jp._data
        with torch.no_grad():
            tp2.copy_(tp)
    if direction == "jax_to_port":
        to2.set_state_dict(_to_numpy_sd(jo.state_dict()))
        jps2, jo2 = jps, jo
    else:
        jo2.set_state_dict(_to_numpy_sd(to.state_dict()))
        tps2, to2 = tps, to
    assert jo2._step_count == to2._step_count == 3
    assert jo2._learning_rate() == to2._learning_rate()
    if name == "adam":    # an unnamed parameter is param_{i} on both sides
        assert "param_1.moment1" in to2.state_dict()
    _eager_steps(jps2, tps2, jo2, to2, seed=40, n=2)
    _same_params(jps2, tps2, name)


def test_eager_surface():
    p = torch.nn.Parameter(torch.ones(3))
    opt = TO.SGD(0.1, parameters=[{"params": [p]}])
    assert opt._parameter_list == [p]
    opt.set_lr(0.5)
    assert opt.get_lr() == 0.5
    with pytest.raises(ValueError, match="parameter list"):
        TO.SGD(0.1).step()
    sched = TO.lr.StepDecay(0.2, step_size=1)
    opt.set_lr_scheduler(sched)
    with pytest.raises(RuntimeError, match="scheduler"):
        opt.set_lr(0.3)
    loss = (p * torch.arange(3.0)).sum()
    assert opt.minimize(loss) == (None, None)
    torch.testing.assert_close(p.detach(), torch.tensor([1.0, 0.8, 0.6]))
    assert opt.minimize_step == opt.step or opt.minimize_step.__func__ is \
        TO.Optimizer.step
    assert TO.LarsMomentum is TO.Lars
    assert TO.Lars._wants_param_name and TO.Lamb._per_tensor_norms
    assert not TO.Adam._wants_param_name


# ------------------------------------------------------------ train step --

TINY = dict(vocab_size=128, hidden_size=64, num_layers=2,
            num_attention_heads=4, max_position_embeddings=64,
            compute_dtype="float32")
B, L = 2, 64


def _hcg():
    from paddle_tpu.distributed import fleet
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                               "pp_degree": 1}
    fleet.init(is_collective=True, strategy=strategy)
    return fleet.get_hybrid_communicate_group()


def _gpt_pair(seed=0):
    paddle.seed(seed)
    jm = JModel(JConfig(**TINY))
    state = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    return jm, state


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [(torch.tensor(rng.randint(0, TINY["vocab_size"], (B, L))),
             torch.tensor(rng.randint(0, TINY["vocab_size"], (B, L))))
            for _ in range(n)]


def test_donate_false_keeps_the_old_state():
    """The kept step leaves the state it was given and the model untouched,
    returns tensors it shares with neither, and follows the donated
    trajectory."""
    _, state = _gpt_pair()
    ta = params_from_numpy(state, GPTConfig(**TINY), device="cpu")
    tb = params_from_numpy(state, GPTConfig(**TINY), device="cpu")
    sa_step, sa = make_gpt_train_step(ta, TO.AdamW(1e-3), remat=True)
    sb_step, sb = make_gpt_train_step(tb, TO.AdamW(1e-3), remat=True,
                                      donate=False)
    own = {n: p.detach().clone() for n, p in tb.named_parameters()}
    ptrs = {p.data_ptr() for p in tb.parameters()}
    la, lb = [], []
    for i, (x, y) in enumerate(_batches(3, seed=1)):
        before = {n: v.clone() for n, v in sb["params"].items()}
        slots = {(n, k): v.clone() for n, s in sb["opt"]["slots"].items()
                 for k, v in s.items()}
        sa, loss_a = sa_step(sa, i, 1e-3, x, y)
        nb, loss_b = sb_step(sb, i, 1e-3, x, y)
        for n, v in sb["params"].items():
            assert torch.equal(v, before[n]), n
        for (n, k), v in slots.items():
            assert torch.equal(sb["opt"]["slots"][n][k], v), (n, k)
        assert nb is not sb and int(nb["opt"]["step"]) == i + 1
        old = {v.data_ptr() for v in sb["params"].values()} | {
            v.data_ptr() for s in sb["opt"]["slots"].values()
            for v in s.values()}
        for v in list(nb["params"].values()) + [
                v for s in nb["opt"]["slots"].values() for v in s.values()]:
            assert v.data_ptr() not in old | ptrs
        sb = nb
        la.append(float(loss_a))
        lb.append(float(loss_b))
    np.testing.assert_allclose(lb, la, rtol=1e-6)
    for n, p in tb.named_parameters():
        assert torch.equal(p.detach(), own[n]), n
        torch.testing.assert_close(sb["params"][n],
                                   dict(ta.named_parameters())[n].detach(),
                                   rtol=1e-5, atol=1e-6)


def test_microbatches_on_one_device_match_reference():
    """``n_microbatches`` is read only on a pipeline axis: on one device
    the step runs the whole batch, as the reference's does."""
    jm, state = _gpt_pair(seed=2)
    jstep, jstate = j_make_step(jm, JO.AdamW(3e-4), _hcg(), n_microbatches=2,
                                remat=False)
    losses = {}
    for nmb in (1, 2):
        tm = params_from_numpy(state, GPTConfig(**TINY), device="cpu")
        step, st = make_gpt_train_step(tm, TO.AdamW(3e-4), n_microbatches=nmb,
                                       remat=False)
        st["opt"] = opt_state_from_numpy(
            jax.tree_util.tree_map(np.asarray, jstate["opt"]), device="cpu")
        out = []
        for i, (x, y) in enumerate(_batches(2, seed=3)):
            st, loss = step(st, i, 3e-4, x, y)
            out.append(float(loss))
        losses[nmb] = out
    jl = []
    for i, (x, y) in enumerate(_batches(2, seed=3)):
        jstate, loss = jstep(jstate, jax.random.key(i), np.float32(3e-4),
                             jnp.asarray(x.numpy()), jnp.asarray(y.numpy()))
        jl.append(float(loss))
    assert losses[1] == losses[2]
    np.testing.assert_allclose(losses[2], jl, rtol=1e-5)
