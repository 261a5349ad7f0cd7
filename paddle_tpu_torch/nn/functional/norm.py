"""Normalization functionals (counterpart of
``paddle_tpu/nn/functional/norm.py``): ``batch_norm``."""

from __future__ import annotations

import torch

_HALF = (torch.bfloat16, torch.float16)


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5, data_format="NCHW",
               use_global_stats=None, name=None):
    """Batch norm in the reference's order of dtypes.

    With batch statistics (training, unless ``use_global_stats``) the
    mean and the biased variance over every dim but the channel are taken
    in fp32 for a 16-bit input and rounded to its dtype (as ``jnp.mean``
    and ``jnp.var`` do); ``(x - mean) * rsqrt(var + eps)`` runs in the
    input's dtype, then the weight and bias promote it.  The running
    statistics are updated in place, with no gradient:
    ``new = momentum * old + (1 - momentum) * batch``, cast to the
    buffer's dtype; ``copy_`` reaches a buffer that
    ``torch.func.functional_call`` swapped in.  Otherwise the running
    statistics normalize."""
    ch = 1 if data_format[1] == "C" else x.dim() - 1
    shape = [1] * x.dim()
    shape[ch] = x.shape[ch]
    if training and use_global_stats is not True:
        axes = [i for i in range(x.dim()) if i != ch]
        a = x.float() if x.dtype in _HALF else x
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


__all__ = ["batch_norm"]
