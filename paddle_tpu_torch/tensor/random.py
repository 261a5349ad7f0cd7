"""Random draws (counterpart of ``paddle_tpu/tensor/random.py``).

Every draw takes one key, ``core.rng.next_key()`` (the eager stream's next
split, or the step key's next fold inside ``rng_scope``), or
``make_key(seed)`` for a nonzero ``seed``, and computes ``jax.random``'s
law on it (``core.rng``), so a draw here equals the reference's after the
same ``seed()`` and the same draws before it.  A new tensor lands on
``device``: the ``nn.building`` scope's, else ``cuda`` (raising without a
card); a draw from a tensor lands on its device.

The reference runs with ``jax_enable_x64`` off, so its integer draws are
int32 ones: ``randint``'s int64 is an int32 draw cast, and ``binomial``
and ``multinomial`` give int64 here where the reference gives int32.
``multinomial(replacement=True)`` follows the reference's call of
``jax.random.categorical`` with the sample shape ``(*batch,
num_samples)``: it raises for a 2-D input unless ``num_samples`` equals
the batch, and then lays the samples out samples-major (ROADMAP §C).
"""

from __future__ import annotations

import torch

from ..core import rng
from ..core.dtype import convert_dtype, get_default_dtype
from .creation import _device, _to_shape


def _dt(dtype):
    return get_default_dtype() if dtype is None else convert_dtype(dtype)


def _key(seed):
    return rng.next_key() if seed == 0 else rng.make_key(seed)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None,
            device=None):
    return rng.uniform(_key(seed), _to_shape(shape), _dt(dtype), min, max,
                       _device(device))


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    out = rng.uniform(_key(seed), x.shape, x.dtype, min, max, x.device)
    with torch.no_grad():
        return x.copy_(out)


def rand(shape, dtype=None, name=None, device=None):
    return uniform(shape, dtype, 0.0, 1.0, device=device)


def randn(shape, dtype=None, name=None, device=None):
    return rng.normal(rng.next_key(), _to_shape(shape), _dt(dtype),
                      _device(device))


def standard_normal(shape, dtype=None, name=None, device=None):
    return randn(shape, dtype, device=device)


def _shape_of(v):
    return tuple(v.shape) if isinstance(v, torch.Tensor) else None


def normal(mean=0.0, std=1.0, shape=None, name=None, device=None):
    """``mean + std * z``, z standard normal of ``shape`` (else ``mean``'s
    or ``std``'s shape, else [1]; a 0-d shape counts as none, as in the
    reference) in the default dtype, on a tensor argument's device."""
    if shape is None:
        shape = _shape_of(mean) or _shape_of(std) or [1]
    dev = next((v.device for v in (mean, std)
                if isinstance(v, torch.Tensor)), None) or _device(device)
    z = rng.normal(rng.next_key(), _to_shape(shape), get_default_dtype(),
                   dev)
    return mean + std * z


def normal_(x, mean=0.0, std=1.0, name=None):
    out = normal(mean, std, x.shape, device=x.device)
    with torch.no_grad():
        return x.copy_(out.to(x.dtype))


def gaussian(shape, mean=0.0, std=1.0, seed=0, dtype=None, name=None,
             device=None):
    z = rng.normal(_key(seed), _to_shape(shape), _dt(dtype),
                   _device(device))
    return mean + std * z


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None,
            device=None):
    if high is None:
        low, high = 0, low
    dt = convert_dtype(dtype)
    draw_dt = torch.int32 if torch.iinfo(dt).bits > 32 else dt  # x64 off
    return rng.randint(rng.next_key(), _to_shape(shape), low, high, draw_dt,
                       _device(device)).to(dt)


def randint_like(x, low=0, high=None, dtype=None, name=None):
    return randint(low, high, x.shape, dtype or x.dtype, device=x.device)


def randperm(n, dtype="int64", name=None, device=None):
    return rng.permutation(rng.next_key(), int(n),
                           device=_device(device)).to(convert_dtype(dtype))


def multinomial(x, num_samples=1, replacement=False, name=None):
    """Indices drawn from the rows of probabilities ``x``: with
    replacement, ``core.rng.categorical`` of their logs at the reference's
    sample shape (module docstring); without, the top ``num_samples`` of
    the logs plus one gumbel draw."""
    key = rng.next_key()
    logits = torch.log(torch.clamp_min(x, 1e-30))
    if replacement:
        return rng.categorical(key, logits, axis=-1, shape=(
            *x.shape[:-1], num_samples)).to(torch.int64)
    g = rng.gumbel(key, x.shape, logits.dtype, x.device)
    return rng._top_k(logits + g, num_samples)


def bernoulli(x, name=None):
    """1 where a uniform draw of ``x``'s dtype is below ``x``, else 0."""
    u = rng.uniform(rng.next_key(), x.shape, x.dtype, device=x.device)
    return (u < x).to(x.dtype)


def bernoulli_(x, p=0.5, name=None):
    out = rng.bernoulli(rng.next_key(), p, x.shape, torch.float32, x.device)
    with torch.no_grad():
        return x.copy_(out.to(x.dtype))


def poisson(x, name=None):
    return rng.poisson(rng.next_key(), x.float()).to(x.dtype)


def binomial(count, prob, name=None):
    return rng.binomial(rng.next_key(), count, prob).to(torch.int64)


def exponential_(x, lam=1.0, name=None):
    out = rng.exponential(rng.next_key(), x.shape, x.dtype, x.device) / lam
    with torch.no_grad():
        return x.copy_(out.to(x.dtype))


def check_shape(shape):
    """Validate a shape argument: a list or tuple holds ints or tensors."""
    if isinstance(shape, (list, tuple)):
        for s in shape:
            if not isinstance(s, int) and not hasattr(s, "dtype"):
                raise TypeError(f"shape entries must be ints/Tensors, got "
                                f"{type(s)}")
    return shape


__all__ = ["uniform", "uniform_", "rand", "randn", "standard_normal",
           "normal", "normal_", "gaussian", "randint", "randint_like",
           "randperm", "multinomial", "bernoulli", "bernoulli_", "poisson",
           "binomial", "exponential_", "check_shape"]
