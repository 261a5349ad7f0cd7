"""Port parity for the LR schedulers (paddle_tpu_torch/optimizer/lr.py):
every schedule of the reference's ``optimizer/lr.py`` stepped 40 times on
both packages with the same arguments.  Both are host-side Python floats
from the same formulas, so every value agrees to 1e-12; ``state_dict``
taken from one package and loaded into the other continues the same
sequence, in both directions."""

import math

import pytest

import paddle_tpu.optimizer.lr as J
import paddle_tpu_torch.optimizer.lr as T

STEPS = 40
TOL = 1e-12
# a loss that falls, stalls, then falls again (ReduceOnPlateau)
METRICS = [1.0 - 0.02 * i if i < 10 or i >= 25 else 0.8 for i in range(STEPS)]

CASES = {
    "noam": lambda m: m.NoamDecay(d_model=64, warmup_steps=10,
                                  learning_rate=2.0),
    "piecewise": lambda m: m.PiecewiseDecay([5, 12, 30], [1.0, 0.5, 0.1,
                                                          0.01]),
    "natural_exp": lambda m: m.NaturalExpDecay(0.5, gamma=0.1),
    "inverse_time": lambda m: m.InverseTimeDecay(0.5, gamma=0.2),
    "polynomial": lambda m: m.PolynomialDecay(0.5, decay_steps=15,
                                              end_lr=0.01, power=2.0),
    "polynomial_cycle": lambda m: m.PolynomialDecay(
        0.5, decay_steps=7, end_lr=0.01, power=1.5, cycle=True),
    "linear_warmup": lambda m: m.LinearWarmup(0.3, warmup_steps=8,
                                              start_lr=0.0, end_lr=0.3),
    "linear_warmup_over_cosine": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(0.3, T_max=20, eta_min=0.01),
        warmup_steps=5, start_lr=0.01, end_lr=0.3),
    "exponential": lambda m: m.ExponentialDecay(0.5, gamma=0.9),
    "multistep": lambda m: m.MultiStepDecay(0.5, milestones=[3, 10, 21],
                                            gamma=0.3),
    "step": lambda m: m.StepDecay(0.5, step_size=6, gamma=0.5),
    "lambda": lambda m: m.LambdaDecay(0.5, lambda e: 1.0 / (1 + e)),
    "multiplicative": lambda m: m.MultiplicativeDecay(0.5,
                                                      lambda e: 0.97),
    "cosine": lambda m: m.CosineAnnealingDecay(0.5, T_max=13, eta_min=0.02),
    "cyclic_triangular": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=5,
                                              step_size_down=7),
    "cyclic_triangular2": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=4,
                                               mode="triangular2"),
    "cyclic_exp_range": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=4,
                                             mode="exp_range",
                                             exp_gamma=0.95),
    "cyclic_scale_fn": lambda m: m.CyclicLR(
        0.01, 0.1, step_size_up=3, scale_fn=lambda x: 1 / (1 + x),
        scale_mode="iterations"),
    "one_cycle_cos": lambda m: m.OneCycleLR(0.1, total_steps=30),
    "one_cycle_linear": lambda m: m.OneCycleLR(0.1, total_steps=30,
                                               anneal_strategy="linear",
                                               phase_pct=0.4),
    "reduce_on_plateau": lambda m: m.ReduceOnPlateau(
        0.5, factor=0.5, patience=3, cooldown=2, min_lr=0.05),
    "reduce_on_plateau_max_abs": lambda m: m.ReduceOnPlateau(
        0.5, mode="max", factor=0.5, patience=2, threshold=0.01,
        threshold_mode="abs"),
}


def _step(sched, i):
    if isinstance(sched, (J.ReduceOnPlateau, T.ReduceOnPlateau)):
        sched.step(METRICS[i])
    else:
        sched.step()


def _run(sched, start=0, n=STEPS):
    out = [sched()]
    for i in range(start, start + n):
        _step(sched, i)
        out.append(sched())
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_schedule_matches_reference(name):
    j, t = CASES[name](J), CASES[name](T)
    jv, tv = _run(j), _run(t)
    assert all(isinstance(v, float) for v in tv)
    for i, (a, b) in enumerate(zip(tv, jv)):
        assert math.isclose(a, b, rel_tol=0, abs_tol=TOL), (name, i, a, b)
    assert t.last_epoch == j.last_epoch
    # the schedule moves at all over its 40 steps
    assert len({round(v, 12) for v in tv}) > 1, name


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("name", ["linear_warmup", "cyclic_triangular2",
                                  "reduce_on_plateau", "multiplicative",
                                  "one_cycle_cos"])
def test_state_dict_round_trips(name, direction):
    """17 steps on one package, its ``state_dict`` into a fresh scheduler
    of the other, then 20 more on both."""
    src_mod, dst_mod = (J, T) if direction == "jax_to_port" else (T, J)
    src = CASES[name](src_mod)
    _run(src, 0, 17)
    sd = src.state_dict()
    assert "lr_lambda" not in sd
    dst = CASES[name](dst_mod)
    dst.set_state_dict(dict(sd))
    assert dst() == src() and dst.last_epoch == src.last_epoch
    a, b = _run(src, 17, 20), _run(dst, 17, 20)
    for x, y in zip(a, b):
        assert math.isclose(x, y, rel_tol=0, abs_tol=TOL), name


def test_first_step_in_constructor():
    """``last_epoch`` -1 steps to 0 in the constructor (ReduceOnPlateau
    takes no first step, as the reference's)."""
    for mod in (J, T):
        assert mod.StepDecay(0.5, 3).last_epoch == 0
        assert mod.StepDecay(0.5, 3, last_epoch=4).last_epoch == 5
        assert mod.ReduceOnPlateau(0.5).last_epoch == 0
