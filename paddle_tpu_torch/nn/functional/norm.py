"""Normalization functionals (counterpart of
``paddle_tpu/nn/functional/norm.py``): ``batch_norm``, ``layer_norm``,
``instance_norm``, ``group_norm``, ``local_response_norm`` and
``normalize``.

XLA computed these for the reference with no Pallas kernel, so they are
plain PyTorch in the reference's order of dtypes: a 16-bit input keeps
its dtype through ``(x - mean) * rsqrt(var + eps)``, with the statistics
taken in fp32 and rounded to it (``jnp.mean``/``jnp.var``'s upcast).

Inside :func:`batch_stats_over` (the mesh train steps' forward) a batch
norm's training statistics cover the global batch: the per-channel sums
are all-reduced over the batch ranks, as the reference's GSPMD step
computes them over the whole batch.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch

_HALF = (torch.bfloat16, torch.float16)

#: the batch-statistics all-reduces made in this process (forward; the
#: backward makes as many of the same bytes) and their bytes
BATCH_STATS = {"all_reduces": 0, "bytes": 0}


class _BatchScope(threading.local):
    def __init__(self):
        self.group = None
        self.refusal = None


_batch = _BatchScope()


@contextlib.contextmanager
def batch_stats_over(group, refusal=None):
    """Take a batch norm's training statistics over the rows of every rank
    of ``group`` (``collective.Group``; each rank holds an equal share of
    the batch): the per-channel sums are summed over the group with a
    summed gradient (``collective.sum_over_group``).  ``refusal``: a
    batch norm in training mode raises ``NotImplementedError`` with it
    (rows split in a way these sums cannot cover)."""
    prev = _batch.group, _batch.refusal
    _batch.group, _batch.refusal = group, refusal
    try:
        yield
    finally:
        _batch.group, _batch.refusal = prev


def _channel_shape(x, ch):
    shape = [1] * x.dim()
    shape[ch] = x.shape[ch]
    return shape


def _global_stats(a, axes, shape, group):
    """The mean and biased variance over ``axes`` of every rank's rows,
    in ``a``'s dtype (fp32 for a 16-bit input): the sums over the group,
    then a second pass of squared deviations around the global mean, as
    ``jnp.var`` takes it (every rank holds as many rows)."""
    from ...distributed.collective import sum_over_group
    count = a.numel() // math.prod(shape) * group.nranks

    def total(t):
        BATCH_STATS["all_reduces"] += 1
        BATCH_STATS["bytes"] += t.numel() * t.element_size()
        return sum_over_group(t, group)
    mean = total(a.sum(axes)) / count
    d = a - mean.reshape(shape)
    return mean, total((d * d).sum(axes)) / count


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5, data_format="NCHW",
               use_global_stats=None, name=None):
    """Batch norm in the reference's order of dtypes.

    With batch statistics (training, unless ``use_global_stats``) the
    mean and the biased variance over every dim but the channel are taken
    in fp32 for a 16-bit input and rounded to its dtype (as ``jnp.mean``
    and ``jnp.var`` do); inside :func:`batch_stats_over` they cover every
    rank's rows.  ``(x - mean) * rsqrt(var + eps)`` runs in the input's
    dtype, then the weight and bias promote it.  The running statistics
    are updated in place, with no gradient: ``new = momentum * old + (1 -
    momentum) * batch``, cast to the buffer's dtype; ``copy_`` reaches a
    buffer that ``torch.func.functional_call`` swapped in.  Otherwise the
    running statistics normalize."""
    ch = 1 if data_format[1] == "C" else x.dim() - 1
    shape = _channel_shape(x, ch)
    if training and use_global_stats is not True:
        if _batch.refusal is not None:
            raise NotImplementedError(_batch.refusal)
        axes = [i for i in range(x.dim()) if i != ch]
        a = x.float() if x.dtype in _HALF else x
        group = _batch.group
        if group is not None and group.nranks > 1:
            mean, var = _global_stats(a, axes, shape, group)
            mean, var = mean.to(x.dtype), var.to(x.dtype)
        else:
            mean = a.mean(axes).to(x.dtype)
            var = a.var(axes, correction=0).to(x.dtype)
        if running_mean is not None:
            with torch.no_grad():
                running_mean.copy_(momentum * running_mean
                                   + (1 - momentum) * mean.detach())
                running_var.copy_(momentum * running_var
                                  + (1 - momentum) * var.detach())
    else:
        mean, var = running_mean, running_var
    out = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape)
                                                  + epsilon)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def _stats(a, axes):
    """``jnp.mean`` and ``jnp.var`` (biased) over ``axes``, kept: fp32
    for a 16-bit input, rounded back to its dtype."""
    w = a.float() if a.dtype in _HALF else a
    return (w.mean(axes, keepdim=True).to(a.dtype),
            w.var(axes, correction=0, keepdim=True).to(a.dtype))


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """Normalize over the last ``len(normalized_shape)`` dims; the weight
    and bias are cast to the input's dtype (the reference outside
    ``amp.auto_cast``, which the port does not have yet)."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    nd = len(list(normalized_shape))
    axes = list(range(x.dim() - nd, x.dim()))
    m, v = _stats(x, axes)
    out = (x - m) * torch.rsqrt(v + epsilon)
    if weight is not None:
        out = out * weight.to(out.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Normalize each sample's channel over its spatial dims.  As in the
    reference, the running statistics, ``use_input_stats`` and
    ``momentum`` are accepted and not read."""
    if data_format[1] == "C":
        axes, ch = list(range(2, x.dim())), 1
    else:
        axes, ch = list(range(1, x.dim() - 1)), x.dim() - 1
    m, v = _stats(x, axes)
    out = (x - m) * torch.rsqrt(v + eps)
    shape = _channel_shape(x, ch)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    """Normalize each sample over groups of ``C / num_groups`` channels
    and the spatial dims."""
    if data_format[1] == "C":
        n, c = x.shape[0], x.shape[1]
        g = x.reshape((n, num_groups, c // num_groups) + tuple(x.shape[2:]))
        axes, ch = list(range(2, g.dim())), 1
    else:
        n, c = x.shape[0], x.shape[-1]
        g = x.reshape((n,) + tuple(x.shape[1:-1])
                      + (num_groups, c // num_groups))
        axes, ch = list(range(1, x.dim() - 1)) + [x.dim()], x.dim() - 1
    m, v = _stats(g, axes)
    out = ((g - m) * torch.rsqrt(v + epsilon)).reshape(x.shape)
    shape = _channel_shape(x, ch)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """Paddle 2.x's LRN: ``x / (k + alpha * mean)^beta``, the mean of
    ``x^2`` over a window of ``size`` channels (padded ``size // 2``
    below, ``(size - 1) // 2`` above)."""
    ch = 1 if data_format[1] == "C" else x.dim() - 1
    sq = torch.movedim(x * x, ch, -1)
    lo, hi = size // 2, (size - 1) // 2
    padded = torch.nn.functional.pad(sq, (lo, hi))
    c = sq.shape[-1]
    win = padded[..., 0:c]
    for i in range(1, size):
        win = win + padded[..., i:i + c]
    win = torch.movedim(win / size, -1, ch)
    return x / torch.pow(k + alpha * win, beta)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """``x / max(||x||_p, epsilon)`` along ``axis``."""
    n = torch.linalg.vector_norm(x, ord=p, dim=axis, keepdim=True)
    return x / torch.clamp(n, min=epsilon)


__all__ = ["batch_norm", "batch_stats_over", "layer_norm", "instance_norm",
           "group_norm", "local_response_norm", "normalize"]
