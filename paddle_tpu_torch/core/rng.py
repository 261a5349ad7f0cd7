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
- :func:`split`, :func:`fold_in`, :func:`random_bits` (32 and 64
  bits), :func:`uniform` and :func:`bernoulli` (float32 and float64) are
  ``jax.random``'s under ``jax_threefry_partitionable=True`` (jax 0.9's
  default): block ``i`` of a draw is threefry2x32 of the key over the
  64-bit counter ``i`` (row-major), so ``split(k)[i] == fold_in(k, i)``.
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


def _block_words(key, shape, device):
    """The two uint32 output words (int64 tensors of ``shape``) of the
    threefry blocks over the row-major counters of ``shape``, from the
    enclosing :func:`row_block`'s first counter (else 0)."""
    k0, k1 = _words(key)
    n = int(np.prod(shape, dtype=np.int64))
    offset = _row_offset(shape, n)
    idx = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    hi, lo = idx >> 32, idx & _M32
    b0, b1 = _threefry2x32(k0, k1, hi, lo)
    return b0.reshape(shape), b1.reshape(shape)


def random_bits(key, bit_width: int = 32, shape=(), device=None):
    """``jax.random.bits``' values as int64 of ``shape`` on ``device``:
    the blocks' two words XORed (32 bits), or their concatenation (64; a
    value of 2**63 or more is its two's-complement int64, what a uint64
    array viewed as int64 holds).  ``device``: ``cuda`` by default."""
    shape, device = _shape(shape), _device(device)
    b0, b1 = _block_words(key, shape, device)
    if bit_width == 64:
        b0 = b0 - ((b0 >> 31) << 32)          # the high word, signed
        return b0 * 4294967296 + b1
    if bit_width != 32:
        raise ValueError(f"bit_width must be 32 or 64, got {bit_width}")
    return b0.bitwise_xor_(b1)


def uniform(key, shape=(), dtype=torch.float32, minval=0.0, maxval=1.0,
            device=None):
    """``jax.random.uniform`` in float32 or float64: the top mantissa bits
    of a draw as wide as ``dtype``, OR'd into 1.0's bit pattern, less 1,
    scaled to [minval, maxval).  ``device``: ``cuda`` by default."""
    shape, device = _shape(shape), _device(device)
    if dtype == torch.float64:
        b0, b1 = _block_words(key, shape, device)
        fbits = ((b0 << 20) | (b1 >> 12) | 0x3FF0000000000000).view(dtype)
    elif dtype == torch.float32:
        fbits = ((random_bits(key, 32, shape, device) >> 9) | 0x3F800000
                 ).to(torch.int32).view(dtype)
    else:
        raise ValueError(f"uniform draws float32 or float64, not {dtype}")
    floats = fbits - torch.ones((), dtype=dtype, device=device)
    lo = torch.full((), minval, dtype=dtype, device=device)
    hi = torch.full((), maxval, dtype=dtype, device=device)
    # one rounding, as XLA contracts the multiply-add into an FMA
    return torch.maximum(lo, torch.addcmul(lo, floats, hi - lo))


def bernoulli(key, p=0.5, shape=(), dtype=torch.float32, device=None):
    """``jax.random.bernoulli`` for a scalar ``p`` of ``dtype``:
    ``uniform(key, shape, dtype) < p``, a bool tensor.  ``device``:
    ``cuda`` by default."""
    device = _device(device)
    return uniform(key, shape, dtype, device=device) < torch.full(
        (), p, dtype=dtype, device=device)


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
           "bernoulli", "seed", "get_stream", "add_stream", "rng_scope",
           "fold_scope", "row_block", "batch_broadcast", "refuse_draws",
           "next_key", "in_rng_scope", "RNGSequenceTracker",
           "get_rng_state_tracker", "get_rng_state", "set_rng_state"]
