"""Random number state (counterpart of ``paddle_tpu/core/rng.py``).

The reference draws every random mask from a JAX key; the port draws the
same bits from the same keys, so a dropout mask here equals the
reference's bit for bit:

- A key is ``uint32[2]`` key data (numpy), what ``jax.random.key_data``
  gives; torch has no typed keys.  Keys are derived on the host (a few
  scalar threefry blocks); only ``random_bits`` and what it feeds run on
  a device, as plain int64 tensor arithmetic carrying uint32 words (CPU
  torch has no uint32 shifts), on the given device: ``cuda`` unless the
  caller names another (raising without a card), as every entry point of
  the port.
- :func:`split`, :func:`fold_in`, :func:`random_bits` (8, 16, 32 and
  64 bits), :func:`uniform` and :func:`bernoulli` (float16, bfloat16,
  float32 and float64), :func:`normal`, :func:`truncated_normal`,
  :func:`randint`, :func:`permutation`/:func:`shuffle`, :func:`gumbel`,
  :func:`categorical`, :func:`exponential`, :func:`poisson` and
  :func:`binomial` are ``jax.random``'s algorithms under
  ``jax_threefry_partitionable=True`` (jax 0.9's default): block ``i`` of
  a draw is threefry2x32 of the key over the 64-bit counter ``i``
  (row-major), so ``split(k)[i] == fold_in(k, i)``.  The normal laws go
  through :func:`erf_inv`, XLA's polynomial (``torch.erfinv`` rounds
  differently); where XLA contracts a multiply-add into an FMA, the law
  rounds it once too (:func:`_fma`), on the card as on the CPU.
- Named streams, as in the reference: in eager mode each stream owns a
  key that is split on every draw; inside ``rng_scope(key)`` the n-th
  draw is ``fold_in(key, n)``, so the masks of a train step are a pure
  function of its step key and the draw order.
- Inside :func:`row_block` (a mesh train step over data ranks) every
  draw is this rank's rows of the draw over the global batch: its
  counters start at the rank's index times its own draw's numel (one
  broadcast over the batch, inside :func:`batch_broadcast`, at 0).

- ``RNGSequenceTracker`` (``get_rng_state_tracker``): named seeds whose
  ``rng_state(name)`` scope draws from that stream (eager) or from
  ``fold_in(key, hash(name))`` of the step key (inside ``rng_scope``),
  the reference's tracker; the tensor-parallel layers' local and global
  seeds live in it (``parallel_layers/random.py``).
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Optional

import numpy as np
import torch

from . import flags

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


# --------------------------------------------------------------------------
# threefry2x32
# --------------------------------------------------------------------------

def _threefry2x32(k0: int, k1: int, x0, x1):
    """Threefry-2x32, 20 rounds (Salmon et al. 2011), as
    ``jax._src.prng.threefry_2x32`` computes it, of one block (``x0``,
    ``x1`` Python ints) or of int64 tensors of uint32 words (a block an
    element; the tensors are updated in place)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    if not isinstance(x0, torch.Tensor):
        x0, x1 = (x0 + ks[0]) & _M32, (x1 + ks[1]) & _M32
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = (x0 + x1) & _M32
                x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
                x1 ^= x0
            x0 = (x0 + ks[(i + 1) % 3]) & _M32
            x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
        return x0, x1
    x0.add_(ks[0]).bitwise_and_(_M32)
    x1.add_(ks[1]).bitwise_and_(_M32)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_M32)
            hi = x1 >> (32 - r)
            x1.bitwise_left_shift_(r).bitwise_or_(hi).bitwise_and_(_M32)
            x1.bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_M32)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(_M32)
    return x0, x1


def _words(key):
    """The two uint32 words of ``key`` (numpy, a tensor or a list)."""
    if isinstance(key, torch.Tensor):
        key = key.detach().cpu().numpy()
    k = np.asarray(key).astype(np.uint32).reshape(-1)
    if k.shape != (2,):
        raise ValueError(f"a key is uint32[2] key data, got shape "
                         f"{tuple(np.shape(key))}")
    return int(k[0]), int(k[1])


def make_key(seed: int) -> np.ndarray:
    """The key data of ``jax.random.key(seed)``: the seed's high and low
    32-bit words."""
    s = int(seed)
    return np.array([(s >> 32) & _M32, s & _M32], dtype=np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in``: threefry2x32 of ``key`` over the block
    ``(0, data mod 2**32)``."""
    k0, k1 = _words(key)
    return np.array(_threefry2x32(k0, k1, 0, int(data) & _M32),
                    dtype=np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split`` (partitionable): ``uint32[num, 2]``, row ``i``
    the key ``fold_in(key, i)``."""
    k0, k1 = _words(key)
    return np.array([_threefry2x32(k0, k1, i >> 32, i & _M32)
                     for i in range(int(num))], dtype=np.uint32).reshape(
                         int(num), 2)


def _shape(shape):
    return (int(shape),) if isinstance(shape, (int, np.integer)) else \
        tuple(int(d) for d in shape)


def _device(device):
    from .. import resolve_device
    return resolve_device(device)


def _block_words(key, shape, device, offset=None):
    """The two uint32 output words (int64 tensors of ``shape``) of the
    threefry blocks over the row-major counters of ``shape``, from
    ``offset`` (else the enclosing :func:`row_block`'s first counter, else
    0)."""
    k0, k1 = _words(key)
    n = int(np.prod(shape, dtype=np.int64))
    if offset is None:
        offset = _row_offset(shape, n)
    idx = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    hi, lo = idx >> 32, idx & _M32
    b0, b1 = _threefry2x32(k0, k1, hi, lo)
    return b0.reshape(shape), b1.reshape(shape)


def _fma(a, b, c):
    """``a * b + c`` rounded once, as XLA's contracted multiply-add, the
    same on every device: float32 through float64, where the product is
    exact (the sum rounds twice only where float64's sum lies on a float32
    tie); float64 by ``torch.addcmul`` (fused on the CPU; the card's
    kernel may round its product first, so a float64 law is held to an
    ulp there).  ``a`` and ``b`` may be Python floats."""
    if c.dtype == torch.float64:
        return torch.addcmul(c, torch.as_tensor(a, dtype=c.dtype,
                                                device=c.device),
                             torch.as_tensor(b, dtype=c.dtype,
                                             device=c.device))
    a = a.double() if isinstance(a, torch.Tensor) else a
    b = b.double() if isinstance(b, torch.Tensor) else b
    return (a * b + c.double()).to(c.dtype)


def random_bits(key, bit_width: int = 32, shape=(), device=None,
                offset=None):
    """``jax.random.bits``' values as int64 of ``shape`` on ``device``:
    the blocks' two words XORed (32 bits; 8 and 16 bits keep its low
    bits), or their concatenation (64; a value of 2**63 or more is its
    two's-complement int64, what a uint64 array viewed as int64 holds).
    ``offset``: the first counter (else :func:`row_block`'s, else 0).
    ``device``: ``cuda`` by default."""
    shape, device = _shape(shape), _device(device)
    b0, b1 = _block_words(key, shape, device, offset)
    if bit_width == 64:
        b0 = b0 - ((b0 >> 31) << 32)          # the high word, signed
        return b0 * 4294967296 + b1
    if bit_width not in (8, 16, 32):
        raise ValueError(f"bit_width must be 8, 16, 32 or 64, got "
                         f"{bit_width}")
    bits = b0.bitwise_xor_(b1)
    return bits if bit_width == 32 else bits.bitwise_and_(
        (1 << bit_width) - 1)


# 16-bit floats: (bits drawn, mantissa bits, the bit pattern of 1.0)
_HALF_BITS = {torch.bfloat16: (8, 7, 0x3F80), torch.float16: (16, 10, 0x3C00)}


def uniform(key, shape=(), dtype=torch.float32, minval=0.0, maxval=1.0,
            device=None, offset=None):
    """``jax.random.uniform``: the top mantissa bits of a draw (64 bits
    for float64, 32 for float32, 16 for float16, 8 for bfloat16), OR'd
    into 1.0's bit pattern, less 1, scaled to [minval, maxval).
    ``offset``: as :func:`random_bits`.  ``device``: ``cuda`` by
    default."""
    shape, device = _shape(shape), _device(device)
    if dtype == torch.float64:
        b0, b1 = _block_words(key, shape, device, offset)
        fbits = ((b0 << 20) | (b1 >> 12) | 0x3FF0000000000000).view(dtype)
    elif dtype == torch.float32:
        fbits = ((random_bits(key, 32, shape, device, offset) >> 9)
                 | 0x3F800000).to(torch.int32).view(dtype)
    elif dtype in _HALF_BITS:
        nbits, nmant, one = _HALF_BITS[dtype]
        fbits = ((random_bits(key, nbits, shape, device, offset)
                  >> (nbits - nmant)) | one).to(torch.int16).view(dtype)
    else:
        raise ValueError(f"uniform draws a float dtype, not {dtype}")
    floats = fbits - torch.ones((), dtype=dtype, device=device)
    if minval == 0 and maxval == 1:
        return floats                  # the scale and shift are exact
    lo = torch.full((), minval, dtype=dtype, device=device)
    hi = torch.full((), maxval, dtype=dtype, device=device)
    if dtype == torch.bfloat16:
        # XLA rounds a bfloat16 product and sum each to bfloat16
        return torch.maximum(lo, floats * (hi - lo) + lo)
    if dtype == torch.float16:
        # and a float16 multiply-add once, from float32 (the product is
        # exact there)
        return torch.maximum(lo, _fma(floats.float(), (hi - lo).float(),
                                      lo.float()).to(dtype))
    return torch.maximum(lo, _fma(floats, hi - lo, lo))


def bernoulli(key, p=0.5, shape=(), dtype=torch.float32, device=None):
    """``jax.random.bernoulli`` for a scalar ``p`` of ``dtype``:
    ``uniform(key, shape, dtype) < p``, a bool tensor.  ``device``:
    ``cuda`` by default."""
    device = _device(device)
    return uniform(key, shape, dtype, device=device) < torch.full(
        (), p, dtype=dtype, device=device)


# --------------------------------------------------------------------------
# the other laws
# --------------------------------------------------------------------------

# XLA's erf_inv (Giles, "Approximating the erfinv function", 2010): Horner
# coefficients from the highest power, a row a branch.
_ERF_INV_F32 = (
    (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
     0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
     1.50140941),
    (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
     0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))
_ERF_INV_F64 = (
    (-3.6444120640178196996e-21, -1.685059138182016589e-19,
     1.2858480715256400167e-18, 1.115787767802518096e-17,
     -1.333171662854620906e-16, 2.0972767875968561637e-17,
     6.6376381343583238325e-15, -4.0545662729752068639e-14,
     -8.1519341976054721522e-14, 2.6335093153082322977e-12,
     -1.2975133253453532498e-11, -5.4154120542946279317e-11,
     1.051212273321532285e-09, -4.1126339803469836976e-09,
     -2.9070369957882005086e-08, 4.2347877827932403518e-07,
     -1.3654692000834678645e-06, -1.3882523362786468719e-05,
     0.0001867342080340571352, -0.00074070253416626697512,
     -0.0060336708714301490533, 0.24015818242558961693,
     1.6536545626831027356),
    (2.2137376921775787049e-09, 9.0756561938885390979e-08,
     -2.7517406297064545428e-07, 1.8239629214389227755e-08,
     1.5027403968909827627e-06, -4.013867526981545969e-06,
     2.9234449089955446044e-06, 1.2475304481671778723e-05,
     -4.7318229009055733981e-05, 6.8284851459573175448e-05,
     2.4031110387097893999e-05, -0.0003550375203628474796,
     0.00095328937973738049703, -0.0016882755560235047313,
     0.0024914420961078508066, -0.0037512085075692412107,
     0.005370914553590063617, 1.0052589676941592334,
     3.0838856104922207635),
    (-2.7109920616438573243e-11, -2.5556418169965252055e-10,
     1.5076572693500548083e-09, -3.7894654401267369937e-09,
     7.6157012080783393804e-09, -1.4960026627149240478e-08,
     2.9147953450901080826e-08, -6.7711997758452339498e-08,
     2.2900482228026654717e-07, -9.9298272942317002539e-07,
     4.5260625972231537039e-06, -1.9681778105531670567e-05,
     7.5995277030017761139e-05, -0.00021503011930044477347,
     -0.00013871931833623122026, 1.0103004648645343977,
     4.8499064014085844221))


def _horner(rows, branch, w):
    """sum_i rows[branch][i] * w**(n-1-i), each row as long as its own
    degree: a shorter row joins where its length leaves off (rows are
    longest first, ``branch`` the row index of each element)."""
    n = len(rows[0])
    table = torch.tensor([[0.0] * (n - len(r)) + list(r) for r in rows],
                         dtype=w.dtype, device=w.device)        # (R, n)
    start = torch.tensor([n - len(r) for r in rows], device=w.device)[branch]
    p = table[branch, 0]
    for i in range(1, n):
        coef = table[branch, i]
        p = torch.where(i > start, _fma(p, w, coef),
                        torch.where(i == start, coef, p))
    return p


def erf_inv(x):
    """XLA's ``erf_inv`` of a float32 or float64 tensor (a 16-bit one goes
    through float32): ``w = -log1p(-x*x)``, Giles' polynomial in ``w -
    2.5`` below 5 or ``sqrt(w) - 3`` (float32; float64: ``w - 3.125``
    below 6.25, ``sqrt(w) - 3.25`` below 16, else ``sqrt(w) - 5``), times
    ``x``; +-1 gives +-inf."""
    if x.dtype in _HALF_BITS:
        return erf_inv(x.float()).to(x.dtype)
    w = -torch.log1p(x * -x)
    if x.dtype == torch.float32:
        branch = (w >= 5.0).long()
        w = torch.where(branch == 0, w - 2.5, torch.sqrt(w) - 3.0)
        rows = _ERF_INV_F32
    elif x.dtype == torch.float64:
        branch = (w >= 6.25).long() + (w >= 16.0).long()
        sw = torch.sqrt(w)
        w = torch.where(branch == 0, w - 3.125,
                        torch.where(branch == 1, sw - 3.25, sw - 5.0))
        rows = _ERF_INV_F64
    else:
        raise ValueError(f"erf_inv takes a float tensor, not {x.dtype}")
    out = _horner(rows, branch, w) * x
    return torch.where(x.abs() == 1, x * float("inf"), out)


_NMANT = {torch.float64: 52, torch.float32: 23, torch.float16: 10,
          torch.bfloat16: 7}


def _next_below_one(dtype) -> float:
    """``nextafter(-1, 0)`` in ``dtype``."""
    return -(1.0 - 2.0 ** -(_NMANT[dtype] + 1))


def normal(key, shape=(), dtype=torch.float32, device=None):
    """``jax.random.normal``: ``sqrt(2) * erf_inv(u)``, ``u`` uniform on
    [nextafter(-1, 0), 1) in ``dtype``.  ``device``: ``cuda`` by
    default."""
    u = uniform(key, shape, dtype, _next_below_one(dtype), 1.0, device)
    return torch.full((), math.sqrt(2), dtype=dtype,
                      device=u.device) * erf_inv(u)


def truncated_normal(key, lower, upper, shape=(), dtype=torch.float32,
                     device=None):
    """``jax.random.truncated_normal`` in float32 or float64 for scalar
    bounds: ``sqrt(2) * erf_inv(u)``, ``u`` uniform on [erf(lower /
    sqrt(2)), erf(upper / sqrt(2))), clipped inside (lower, upper).
    ``device``: ``cuda`` by default."""
    np_dt = {torch.float32: np.float32, torch.float64: np.float64}.get(dtype)
    if np_dt is None:
        raise ValueError(f"truncated_normal draws float32 or float64, not "
                         f"{dtype}")
    sqrt2 = np_dt(np.sqrt(2))
    lo, hi = np_dt(lower), np_dt(upper)
    a, b = (float(np_dt(math.erf(float(v / sqrt2)))) for v in (lo, hi))
    u = uniform(key, shape, dtype, a, b, device)
    out = torch.full((), float(sqrt2), dtype=dtype,
                     device=u.device) * erf_inv(u)
    return out.clamp(float(np.nextafter(lo, np_dt(np.inf))),
                     float(np.nextafter(hi, np_dt(-np.inf))))


def _mul32(a, m: int):
    """``a * m`` modulo 2**32 for uint32 words ``a`` (an int64 tensor) and
    ``m`` (a Python int), in products that fit an int64."""
    return (a * (m & 0xFFFF) + (((a * (m >> 16)) & 0xFFFF) << 16)) & _M32


def randint(key, shape, minval, maxval, dtype=torch.int32, device=None):
    """``jax.random.randint`` for scalar bounds and a dtype of at most 32
    bits (8- and 16-bit ones draw in int32, as jax does): two draws of 32
    bits from ``split(key)``, ``(hi % span) * (2**32 % span) + lo % span``
    modulo ``span = maxval - minval`` in uint32 arithmetic.  An int64
    draw is the reference's int32 one, cast (it runs with x64 off).
    ``device``: ``cuda`` by default."""
    shape, device = _shape(shape), _device(device)
    info = torch.iinfo(dtype)
    if info.bits > 32:
        raise ValueError(f"randint draws at most 32 bits, not {dtype}: draw "
                         f"int32 and cast")
    minval, maxval = int(minval), int(maxval)
    if info.bits < 32:
        minval = min(max(minval, info.min), info.max)
        maxval = min(max(maxval, info.min), info.max + 1)
    i32 = torch.iinfo(torch.int32)
    out_of_range = maxval > i32.max
    minval = min(max(minval, i32.min), i32.max)
    maxval = min(max(maxval, i32.min), i32.max)
    span = 1 if maxval <= minval else (maxval - minval) & _M32
    if out_of_range and maxval > minval:
        span = (span + 1) & _M32
    k1, k2 = split(key)
    hi = random_bits(k1, 32, shape, device)
    lo = random_bits(k2, 32, shape, device)
    if span == 0:                      # XLA's x % 0 is x
        off = lo
    else:
        mult = ((2 ** 16 % span) ** 2 & _M32) % span
        off = ((_mul32(hi % span, mult) + lo % span) & _M32) % span
    v = (off + (minval & _M32)) & _M32
    return (v - ((v >> 31) << 32)).to(dtype)


def shuffle(key, x, axis: int = 0):
    """``jax.random``'s ``_shuffle``: ceil(3 ln n / ln(2**32 - 1)) rounds
    (n the numel of ``x``) of a stable sort of ``x`` along ``axis`` by
    fresh 32-bit keys, each round's from the second half of a split."""
    n = max(1, x.numel())
    rounds = int(np.ceil(3 * np.log(n) / np.log(2 ** 32 - 1)))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(random_bits(sub, 32, x.shape, x.device),
                           dim=axis, stable=True).indices
        x = torch.gather(x, axis, order)
    return x


def permutation(key, x, axis: int = 0, independent: bool = False,
                device=None):
    """``jax.random.permutation``: an int ``x`` shuffles ``arange(x)``
    (int64 on ``device``, ``cuda`` by default); a 1-d tensor, or any with
    ``independent``, is shuffled along ``axis``; else its slices along
    ``axis`` are taken in the order of a shuffled ``arange``."""
    if not isinstance(x, torch.Tensor):
        return shuffle(key, torch.arange(int(x), device=_device(device)))
    if independent or x.dim() == 1:
        return shuffle(key, x, axis)
    order = shuffle(key, torch.arange(x.shape[axis], device=x.device))
    return torch.index_select(x, axis, order)


def gumbel(key, shape=(), dtype=torch.float32, device=None):
    """``jax.random.gumbel`` (mode "low"): ``-log(-log(u))``, ``u``
    uniform on [tiny, 1).  ``device``: ``cuda`` by default."""
    u = uniform(key, shape, dtype, torch.finfo(dtype).tiny, 1.0, device)
    return -torch.log(-torch.log(u))


def _incompatible(shape, other):
    try:
        return tuple(torch.broadcast_shapes(shape, other)) != tuple(shape)
    except RuntimeError:
        return True


def categorical(key, logits, axis: int = -1, shape=None,
                replace: bool = True):
    """``jax.random.categorical``: the argmax over ``axis`` of ``logits``
    plus a gumbel draw of the sample shape (with replacement), or the
    top ``k`` of one draw over ``logits`` (without).  ``shape`` must end
    with (a broadcast of) the batch shape, ``logits``' without ``axis``;
    its leading dims are the samples'."""
    ndim = logits.dim()
    ax = axis % ndim
    batch = tuple(logits.shape[:ax]) + tuple(logits.shape[ax + 1:])
    shape = batch if shape is None else _shape(shape)
    if _incompatible(shape, batch):
        raise ValueError(f"Incompatible shapes for broadcasting: "
                         f"shapes={[tuple(shape), batch]}")
    prefix = shape[:len(shape) - len(batch)]
    if replace:
        lshape = list(shape[len(shape) - len(batch):])
        lshape.insert(ax, logits.shape[ax])
        g = gumbel(key, (*prefix, *lshape), logits.dtype, logits.device)
        full = logits.reshape((1,) * len(prefix) + tuple(logits.shape))
        return torch.argmax(g + full, dim=ax - ndim)
    k = int(np.prod(prefix, dtype=np.int64))
    if k > logits.shape[ax]:
        raise ValueError(f"Number of samples without replacement ({k}) "
                         f"cannot exceed number of categories "
                         f"({logits.shape[ax]}).")
    noisy = logits + gumbel(key, logits.shape, logits.dtype, logits.device)
    idx = _top_k(torch.movedim(noisy, ax, -1), k)
    return torch.movedim(idx, -1, 0).reshape(shape)


def _top_k(x, k: int):
    """``lax.top_k``'s indices: the ``k`` largest along the last axis,
    ties in index order."""
    return torch.sort(x, dim=-1, descending=True, stable=True
                      ).indices[..., :k]


def exponential(key, shape=(), dtype=torch.float32, device=None):
    """``jax.random.exponential``: ``-log1p(-u)``, ``u`` uniform.
    ``device``: ``cuda`` by default."""
    return -torch.log1p(-uniform(key, shape, dtype, device=device))


def _refuse_rows(law):
    if _scope.rows is not None:
        raise NotImplementedError(
            f"a {law} draw inside a train step over the batch ranks: its "
            f"rejection loop runs until the global batch is done, so a "
            f"rank's rows are not its own loop's (ROADMAP A7b item 8)")


def poisson(key, lam, shape=None, dtype=torch.int32, device=None):
    """``jax.random.poisson``: Knuth's product of uniforms below lam 10,
    Hormann's transformed rejection above, each a loop over the whole
    draw that splits its key every round (as jax's ``while_loop``s; a
    rejection round may replace an earlier accept, so the rounds are the
    global draw's).  ``lam`` is float32.  ``device``: ``lam``'s for a
    tensor, else ``cuda`` by default."""
    _refuse_rows("poisson")
    dev = lam.device if isinstance(lam, torch.Tensor) else _device(device)
    lam = torch.as_tensor(lam, device=dev).float()
    shape = tuple(lam.shape) if shape is None else _shape(shape)
    lam = lam.broadcast_to(shape).contiguous()
    use_knuth = torch.isnan(lam) | (lam < 10)
    lam_k = torch.where(use_knuth, lam, torch.zeros_like(lam))
    lam_r = torch.where(use_knuth, torch.full_like(lam, 1e5), lam)
    # Knuth
    k = torch.zeros(shape, dtype=torch.int64, device=dev)
    log_prod = torch.zeros(shape, dtype=torch.float32, device=dev)
    rkey = key
    while True:
        live = log_prod > -lam_k
        if not bool(live.any()):
            break
        rkey, sub = split(rkey)
        k = k + live.long()
        log_prod = log_prod + torch.log(uniform(sub, shape, device=dev))
    knuth = k - 1
    # transformed rejection
    log_lam = torch.log(lam_r)
    b = _fma(torch.sqrt(lam_r), 2.53, torch.full_like(lam_r, 0.931))
    a = _fma(b, 0.02483, torch.full_like(b, -0.059))
    inv_alpha = 1.1239 + 1.1328 / (b - 3.4)
    v_r = 0.9277 - 3.6224 / (b - 2)
    k_out = torch.full(shape, -1.0, device=dev)
    accepted = torch.zeros(shape, dtype=torch.bool, device=dev)
    rkey = key
    while not bool(accepted.all()):
        rkey, s0, s1 = split(rkey, 3)
        u = uniform(s0, shape, device=dev) - 0.5
        v = uniform(s1, shape, device=dev)
        us = 0.5 - u.abs()
        kk = torch.floor(_fma(2 * a / us + b, u, lam_r) + 0.43)
        s = torch.log(v * inv_alpha / (a / (us * us) + b))
        t = _fma(kk, log_lam, -lam_r) - torch.lgamma(kk + 1)
        accept = ((us >= 0.07) & (v <= v_r)) | (
            ~((kk < 0) | ((us < 0.013) & (v > us))) & (s <= t))
        k_out = torch.where(accept, kk, k_out)
        accepted |= accept
    out = torch.where(use_knuth, knuth, k_out.long())
    return torch.where(lam == 0, torch.zeros_like(out), out).to(dtype)


_STIRLING_TAIL = (0.0810614667953272, 0.0413406959554092, 0.0276779256849983,
                  0.02079067210376509, 0.0166446911898211,
                  0.0138761288230707, 0.0118967099458917, 0.0104112652619720,
                  0.00925546218271273, 0.00833056343336287)


def _stirling_tail(k):
    """jax's ``_stirling_approx_tail``: the table below 10, else the
    series, at k clamped to [0, 9] as jax clamps it."""
    table = torch.tensor(_STIRLING_TAIL, dtype=k.dtype, device=k.device)
    kc = k.clamp(0.0, 9.0)
    kp1sq = (kc + 1) * (kc + 1)
    approx = (1.0 / 12 - (1.0 / 360 - 1.0 / 1260 / kp1sq) / kp1sq) / (kc + 1)
    idx = torch.nan_to_num(torch.floor(kc), nan=0.0).long()   # XLA's NaN -> 0
    return torch.where(k <= 9, table[idx], approx)


def binomial(key, count, prob, shape=None, dtype=torch.float32,
             device=None):
    """``jax.random.binomial``: inversion (a sum of geometric draws) where
    ``count * q <= 10``, BTRS rejection elsewhere (q the smaller of prob
    and 1 - prob), each a loop over the whole draw; NaN for a negative or
    NaN count or a bad prob, inf for an infinite count.  ``device``: the
    tensors', else ``cuda`` by default."""
    _refuse_rows("binomial")
    dev = next((t.device for t in (prob, count)
                if isinstance(t, torch.Tensor)), None) or _device(device)
    fdt = prob.dtype if isinstance(prob, torch.Tensor) and \
        prob.is_floating_point() else torch.float32
    prob = torch.as_tensor(prob, device=dev).to(fdt)
    count = torch.as_tensor(count, device=dev).to(fdt)
    shape = tuple(torch.broadcast_shapes(prob.shape, count.shape)) \
        if shape is None else _shape(shape)
    count = count.broadcast_to(shape).contiguous()
    prob = prob.broadcast_to(shape).contiguous()
    p_lt_half = prob < 0.5
    q = torch.where(p_lt_half, prob, 1.0 - prob)
    count_bad = torch.isnan(count) | (count < 0.0)
    count_inf = torch.isinf(count)
    q_nan, q_neg = torch.isnan(q), q < 0.0
    q = torch.where(q_nan | q_neg, torch.full_like(q, 0.01), q)
    use_inv = count_bad | (count * q <= 10.0)
    count = torch.floor(count)
    count_inv = torch.where(use_inv, count, torch.zeros_like(count))
    count_bt = torch.where(use_inv, torch.full_like(count, 1e4), count)
    q_bt = torch.where(use_inv, torch.full_like(q, 0.5), q)
    samples = torch.where(use_inv,
                          _binomial_inversion(key, count_inv, q, shape),
                          _btrs(key, count_bt, q_bt, shape))
    invalid = q_neg | q_nan | count_bad
    samples = torch.where(invalid, torch.full_like(samples, float("nan")),
                          samples)
    samples = torch.where(count_inf & ~invalid,
                          torch.full_like(samples, float("inf")), samples)
    samples = torch.where(p_lt_half | count_bad | q_nan | count_inf,
                          samples, count - samples)
    return samples.to(dtype)


def _binomial_inversion(key, count, prob, shape):
    log1mp = torch.log1p(-prob)
    num = torch.zeros_like(prob)
    geom_sum = torch.zeros_like(prob)
    while bool((geom_sum <= count).any()):
        sub, key = split(key)
        num = torch.where(geom_sum <= count, num + 1, num)
        u = uniform(sub, shape, prob.dtype, device=prob.device)
        geom_sum = geom_sum + torch.ceil(torch.log(u) / log1mp)
    return num - 1


def _btrs(key, count, prob, shape):
    stddev = torch.sqrt(count * prob * (1 - prob))
    b = _fma(stddev, 2.53, torch.full_like(stddev, 1.15))
    a = _fma(prob, 0.01, _fma(b, 0.0248, torch.full_like(b, -0.0873)))
    c = _fma(count, prob, torch.full_like(b, 0.5))
    v_r = 0.92 - 4.2 / b
    r = prob / (1 - prob)
    alpha = (2.83 + 5.1 / b) * stddev
    m = torch.floor((count + 1) * prob)
    k_out = torch.full_like(prob, -1.0)
    accepted = torch.zeros(shape, dtype=torch.bool, device=prob.device)
    while not bool(accepted.all()):
        key, s0, s1 = split(key, 3)
        u = uniform(s0, shape, prob.dtype, device=prob.device) - 0.5
        v = uniform(s1, shape, prob.dtype, device=prob.device)
        us = 0.5 - u.abs()
        accept1 = (us >= 0.07) & (v <= v_r)
        k = torch.floor(_fma(2 * a / us + b, u, c))
        reject = (k < 0) | (k > count)
        v = torch.log(v * alpha / (a / (us * us) + b))
        ub = ((m + 0.5) * torch.log((m + 1) / (r * (count - m + 1)))
              + (count + 1) * torch.log((count - m + 1) / (count - k + 1))
              + (k + 0.5) * torch.log(r * (count - k + 1) / (k + 1))
              + _stirling_tail(m) + _stirling_tail(count - m)
              - _stirling_tail(k) - _stirling_tail(count - k))
        accept = accept1 | (~reject & (v <= ub))
        k_out = torch.where(accept, k, k_out)
        accepted |= accept
    return k_out


# --------------------------------------------------------------------------
# streams and scopes
# --------------------------------------------------------------------------

class _Stream:
    def __init__(self, seed: int):
        self.seed = seed
        self.key = make_key(seed)

    def next_key(self) -> np.ndarray:
        self.key, sub = split(self.key)
        return sub


class _ScopeState(threading.local):
    def __init__(self):
        self.key = None        # the scope's key, read at the first draw
        self.counter = 0
        self.refusal = None
        self.rows = None       # (index, row count) of a row_block


_scope = _ScopeState()
_streams: Dict[str, _Stream] = {}


def seed(value: int) -> None:
    """``paddle.seed`` parity: reseed every stream deterministically."""
    flags.set_flags({"FLAGS_seed": int(value)})
    _streams.clear()
    _streams["global"] = _Stream(int(value))


def get_stream(name: str = "global") -> _Stream:
    if name not in _streams:
        base = int(flags.flag("FLAGS_seed"))
        offset = np.uint32(abs(hash(name)) % (2**31))
        _streams[name] = _Stream(base + int(offset))
    return _streams[name]


def add_stream(name: str, seed_value: int) -> None:
    _streams[name] = _Stream(int(seed_value))


@contextlib.contextmanager
def _scoped(key, refusal):
    prev = _scope.key, _scope.counter, _scope.refusal
    _scope.key, _scope.counter, _scope.refusal = key, 0, refusal
    try:
        yield
    finally:
        _scope.key, _scope.counter, _scope.refusal = prev


def rng_scope(key, stream: Optional[str] = None):
    """Install ``key`` as the base key: the n-th draw inside is
    ``fold_in(key, n)`` (a ``None`` key: the streams' eager draws).  The
    key is read at the first draw: a caller whose layers draw nothing may
    pass a placeholder such as ``0`` (``tests/test_torch_dp.py`` does to
    ``make_spmd_train_step``), and only a draw would reject it."""
    return _scoped(key, None)


def fold_scope(data: int):
    """Inside an ``rng_scope(key)``, a scope of ``fold_in(key, data)``
    (a micro-batch's draws, as the reference's accumulating step derives
    them); elsewhere nothing changes."""
    if _scope.key is None or _scope.refusal is not None:
        return contextlib.nullcontext()
    return _scoped(fold_in(_scope.key, data), None)


@contextlib.contextmanager
def row_block(index: int, rows: int):
    """Every draw inside is rank ``index``'s block of rows of the draw the
    reference makes over the global batch: the global draw's dim 0 holds
    the ranks' blocks of ``rows`` rows in order, and the counters are
    row-major, so this rank's block is the one counter range
    ``[index * n, (index + 1) * n)``, ``n`` the numel of its own draw.  A
    draw whose dim 0 is not the rank's ``rows`` batch rows raises; one
    broadcast over the batch is made inside :func:`batch_broadcast`."""
    prev = _scope.rows
    _scope.rows = (int(index), int(rows))
    try:
        yield
    finally:
        _scope.rows = prev


@contextlib.contextmanager
def batch_broadcast():
    """Draws inside are broadcast over the batch (a dropout mask of dim 0
    size 1 along an axis it does not draw over): every rank draws the
    reference's whole draw, from counter 0, inside a :func:`row_block`
    too."""
    prev = _scope.rows
    _scope.rows = None
    try:
        yield
    finally:
        _scope.rows = prev


def _row_offset(shape, n: int) -> int:
    if _scope.rows is None:
        return 0
    index, rows = _scope.rows
    if not shape or shape[0] != rows:
        raise NotImplementedError(
            f"a draw of shape {tuple(shape)} inside a train step over the "
            f"batch ranks: its dim 0 is not this rank's {rows} batch rows, "
            f"so its block of the global draw is not known to be one "
            f"counter range (ROADMAP A7b item 8)")
    return index * n


def refuse_draws(reason: str):
    """Any draw inside raises ``NotImplementedError(reason)``: a step
    whose draws could not equal the reference's must not make them."""
    return _scoped(None, reason)


def next_key(stream: str = "global") -> np.ndarray:
    """Draw a key: scope-derived inside ``rng_scope``, else the stream's
    next split."""
    if _scope.refusal is not None:
        raise NotImplementedError(_scope.refusal)
    if _scope.key is not None:
        _scope.counter += 1
        return fold_in(_scope.key, _scope.counter)
    return get_stream(stream).next_key()


def in_rng_scope() -> bool:
    return _scope.key is not None


class RNGSequenceTracker:
    """Model-parallel RNG state tracker (reference ``core/rng.py``
    ``RNGSequenceTracker``; Paddle's parallel_layers/random.py).

    ``rng_state(name)`` scopes draws to the named stream, so a stream
    seeded per rank (the local seed) draws differently on each model rank
    and the global one alike; inside ``rng_scope(key)`` the stream name is
    folded into the scope's key, so the draws stay a pure function of the
    step key."""

    def __init__(self):
        self.seeds = {}

    def add(self, name: str, seed_value: int):
        if name in self.seeds and self.seeds[name] != seed_value:
            raise ValueError(f"seed for {name} already set to "
                             f"{self.seeds[name]}")
        self.seeds[name] = seed_value
        add_stream(name, seed_value)

    @contextlib.contextmanager
    def rng_state(self, name: str = "global_seed"):
        if name not in self.seeds and name not in _streams:
            self.add(name, int(flags.flag("FLAGS_seed"))
                     + abs(hash(name)) % (2**31))
        if _scope.key is not None:
            with _scoped(fold_in(_scope.key, abs(hash(name)) % (2**31)),
                         None):
                yield
            return
        if _scope.refusal is not None:
            yield                       # a draw inside still raises
            return
        saved = _streams.get("global") or get_stream("global")
        _streams["global"] = get_stream(name)
        try:
            yield
        finally:
            _streams["global"] = saved


_tracker = RNGSequenceTracker()


def get_rng_state_tracker() -> RNGSequenceTracker:
    return _tracker


def get_rng_state():
    """``paddle.get_rng_state``-ish: the key data of every stream."""
    return {name: s.key.copy() for name, s in _streams.items()}


def set_rng_state(state) -> None:
    for name, data in state.items():
        get_stream(name).key = np.array(_words(data), dtype=np.uint32)


__all__ = ["make_key", "fold_in", "split", "random_bits", "uniform",
           "bernoulli", "erf_inv", "normal", "truncated_normal", "randint",
           "shuffle", "permutation", "gumbel", "categorical", "exponential",
           "poisson", "binomial", "seed", "get_stream", "add_stream", "rng_scope",
           "fold_scope", "row_block", "batch_broadcast", "refuse_draws",
           "next_key", "in_rng_scope", "RNGSequenceTracker",
           "get_rng_state_tracker", "get_rng_state", "set_rng_state"]
