"""``paddle_tpu_torch.tensor`` (counterpart of ``paddle_tpu/tensor``): the
functional tensor namespace over torch tensors — ``creation``, ``math``,
``logic``, ``manipulation``, ``random``, ``search``, ``stat`` and
``einsum``, and this file's ``cast``, ``shape``, ``rank``, ``unbind``,
``real``, ``imag``, the dtype predicates and ``set_printoptions``.

The reference patches these functions onto its ``Tensor`` as methods;
the port's tensors are plain ``torch.Tensor``s and get no patched methods
(ROADMAP §C): call ``paddle_tpu_torch.gather(x, i)``, or torch's own
method where one exists.  ``linalg`` waits for ROADMAP A8b-1's next
slice.
"""

from __future__ import annotations

import torch

from ..core.dtype import convert_dtype
from .creation import (  # noqa: F401
    arange, assign, clone, diag, diagflat, empty, empty_like, eye, full,
    full_like, linspace, logspace, meshgrid, numel, ones, ones_like, tril,
    triu, zeros, zeros_like)
from .einsum import einsum  # noqa: F401
from .logic import (  # noqa: F401
    bitwise_and, bitwise_left_shift, bitwise_not, bitwise_or,
    bitwise_right_shift, bitwise_xor, equal, greater_equal, greater_than,
    is_empty, is_tensor, less_equal, less_than, logical_and, logical_not,
    logical_or, logical_xor, not_equal)
from .manipulation import (  # noqa: F401
    as_complex, as_real, atleast_1d, atleast_2d, atleast_3d,
    broadcast_tensors, broadcast_to, chunk, concat, crop, expand, expand_as,
    flatten, flip, gather, gather_nd, index_add, index_put, index_sample,
    index_select, masked_fill, masked_select, moveaxis, pad, put_along_axis,
    repeat_interleave, reshape, reshape_, roll, rot90, scatter, scatter_,
    scatter_nd, scatter_nd_add, shard_index, slice, split, squeeze, squeeze_,
    stack, strided_slice, swapaxes, t, take_along_axis, tensordot, tile,
    transpose, unique, unique_consecutive, unsqueeze, unsqueeze_, unstack,
    view, view_as)
from .math import *  # noqa: F401,F403
from .random import (  # noqa: F401
    bernoulli, bernoulli_, binomial, check_shape, exponential_, gaussian,
    multinomial, normal, normal_, poisson, rand, randint, randint_like,
    randn, randperm, standard_normal, uniform, uniform_)
from .search import (  # noqa: F401
    argmax, argmin, argsort, bucketize, index_fill, kthvalue, masked_fill_,
    mode, nonzero, searchsorted, sort, topk, where, where_)
from .stat import (  # noqa: F401
    mean, median, nanmedian, nanquantile, quantile, std, var)


def rank(x):
    """The number of axes, a 0-d int64 tensor on ``x``'s device."""
    return torch.tensor(x.dim(), dtype=torch.int64, device=x.device)


def shape(x):
    """The shape, a 1-d int64 tensor on ``x``'s device."""
    return torch.tensor(list(x.shape), dtype=torch.int64, device=x.device)


def is_floating_point(x):
    return x.is_floating_point()


def is_integer(x):
    return not (x.is_floating_point() or x.is_complex()
                or x.dtype == torch.bool)


def is_complex(x):
    return x.is_complex()


def cast(x, dtype):
    return x.to(convert_dtype(dtype))


def real(x, name=None):
    return torch.real(x) if x.is_complex() else x


def imag(x, name=None):
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


def unbind(x, axis=0, name=None):
    return unstack(x, axis)


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """Printing options of tensor reprs: torch's
    (``torch.set_printoptions``)."""
    torch.set_printoptions(precision=precision, threshold=threshold,
                           edgeitems=edgeitems, linewidth=linewidth,
                           sci_mode=sci_mode)
