"""``paddle_tpu_torch.nn.functional`` (counterpart of
``paddle_tpu/nn/functional``): the activations, the common functionals,
the convolutions, the losses, the normalizations and the poolings, and
the reference's six functions of this file (``scaled_dot_product_attention``
over ``ops.attention``, ``sequence_mask``, ``diag_embed``,
``temporal_shift``, ``npu_identity``, ``sparse_attention``).  Of
``extras``, ``hsigmoid_loss`` and ``margin_cross_entropy`` wait for
ROADMAP A8b-1's next slice."""

from __future__ import annotations

import math

import torch

from .activation import (  # noqa: F401
    celu, elu, gelu, glu, gumbel_softmax, hardshrink, hardsigmoid, hardswish,
    hardtanh, leaky_relu, log_sigmoid, log_softmax, maxout, mish, prelu, relu,
    relu6, relu_, rrelu, selu, sigmoid, silu, softmax, softmax_, softplus,
    softshrink, softsign, swish, tanh, tanhshrink, thresholded_relu)
from .common import (  # noqa: F401
    affine_grid, alpha_dropout, bilinear, channel_shuffle, cosine_similarity,
    dropout, dropout2d, dropout3d, embedding, fold, grid_sample, interpolate,
    label_smooth, linear, one_hot, pad, pixel_shuffle, pixel_unshuffle,
    unfold, upsample)
from .conv import (  # noqa: F401
    conv1d, conv1d_transpose, conv2d, conv2d_transpose, conv3d,
    conv3d_transpose)
from .extras import (  # noqa: F401
    class_center_sample, elu_, gather_tree, max_unpool2d, tanh_, zeropad2d)
from .loss import (  # noqa: F401
    binary_cross_entropy, binary_cross_entropy_with_logits,
    cosine_embedding_loss, cross_entropy, ctc_loss, dice_loss,
    hinge_embedding_loss, kl_div, l1_loss, log_loss, margin_ranking_loss,
    mse_loss, nll_loss, npair_loss, sigmoid_focal_loss, smooth_l1_loss,
    softmax_with_cross_entropy, square_error_cost, triplet_margin_loss)
from .norm import (  # noqa: F401
    batch_norm, batch_stats_over, group_norm, instance_norm, layer_norm,
    local_response_norm, normalize)
from .pooling import (  # noqa: F401
    adaptive_avg_pool1d, adaptive_avg_pool2d, adaptive_avg_pool3d,
    adaptive_max_pool1d, adaptive_max_pool2d, adaptive_max_pool3d,
    avg_pool1d, avg_pool2d, avg_pool3d, max_pool1d, max_pool2d, max_pool3d)


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """``mask[..., j] = j < x[...]`` over ``maxlen`` (default: the
    largest length) columns."""
    from ...core.dtype import convert_dtype
    m = int(x.max()) if maxlen is None else int(maxlen)
    iota = torch.arange(m, device=x.device)
    return (iota < x.unsqueeze(-1)).to(convert_dtype(dtype))


def diag_embed(input, offset=0, dim1=-2, dim2=-1):
    """Each last-dim vector of ``input`` on the ``offset`` diagonal of a
    square matrix placed at dims ``dim1``, ``dim2``."""
    n = input.shape[-1]
    size = n + abs(offset)
    out = input.new_zeros(tuple(input.shape[:-1]) + (size, size))
    idx = torch.arange(n, device=input.device)
    out[..., idx + max(-offset, 0), idx + max(offset, 0)] = input
    nd = out.dim()
    d1, d2 = dim1 % nd, dim2 % nd
    if (d1, d2) != (nd - 2, nd - 1):
        out = torch.movedim(out, (nd - 2, nd - 1), (d1, d2))
    return out


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None,
                   data_format="NCHW"):
    """TSM: of (N * T, C, H, W), the first ``C * shift_ratio`` channels
    shift one segment later, the next as many one earlier (zeros in)."""
    NT, C, H, W = x.shape
    a = x.reshape(NT // seg_num, seg_num, C, H, W)
    fold_c = int(C * shift_ratio)
    out = torch.zeros_like(a)
    out[:, 1:, :fold_c] = a[:, :-1, :fold_c]
    out[:, :-1, fold_c:2 * fold_c] = a[:, 1:, fold_c:2 * fold_c]
    out[:, :, 2 * fold_c:] = a[:, :, 2 * fold_c:]
    return out.reshape(NT, C, H, W)


def npu_identity(x, format=-1):
    return x


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """Attention of (B, H, L, D) tensors restricted to the CSR pattern
    (offsets (B, H, L + 1), columns (B, H, nnz)), on the dense scores with
    -1e30 outside it; the two masks are not read, as in the
    reference."""
    B, H, L, D = query.shape
    scale = torch.full((), 1.0 / math.sqrt(D), dtype=query.dtype,
                       device=query.device)
    scores = torch.einsum("bhld,bhmd->bhlm", query, key) * scale
    offs = sparse_csr_offset.to(torch.int64)
    cols = sparse_csr_columns.to(torch.int64)
    if offs.dim() == 1:
        offs, cols = offs[None, None], cols[None, None]
    nnz = cols.shape[-1]
    pos = torch.arange(nnz, device=cols.device).expand(
        offs.shape[:-1] + (nnz,)).contiguous()
    rows = torch.searchsorted(offs.contiguous(), pos, right=True) - 1
    mask = torch.zeros(offs.shape[:-1] + (L, L), dtype=torch.bool,
                       device=query.device)
    mask.view(-1, L * L).scatter_(
        1, (rows * L + cols).reshape(-1, nnz), True)
    mask = mask.expand(B, H, L, L)
    scores = torch.where(mask, scores, torch.full(
        (), -1e30, dtype=scores.dtype, device=scores.device))
    return torch.einsum("bhlm,bhmd->bhld", torch.softmax(scores, -1), value)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """Attention of (B, L, H, D) tensors through
    ``ops.attention.masked_attention`` (the flash kernels for no mask or a
    key-padding mask)."""
    from ...ops.attention import masked_attention
    return masked_attention(query, key, value, attn_mask, dropout_p,
                            is_causal, training)
