"""Transformer layers (counterpart of ``paddle_tpu/nn/layer/transformer.py``).

``MultiHeadAttention`` computes its attention through
``ops.attention.masked_attention`` (the reference's SDPA entry): with no
mask or a key-padding mask ((B, 1, 1, Lk), (1, 1, 1, Lk) or (B, 1, Lk))
at a length that tiles by 128, that is the flash kernels (``csrc/flash_attention.cu``
on a card, their plain versions on the CPU); any other mask, or another
length, the dense path.  Parameter names and shapes are the reference's
(``self_attn.q_proj.weight`` is (in, out)), so its ``state_dict`` loads
by name (``nn.params_from_numpy``).  Kept from the reference:

- a bool mask becomes 0 where True and -1e9 where False, in the
  projections' dtype;
- ``need_weights=True`` takes a dense einsum path that returns the
  weights and applies the attention dropout to the *output*, not the
  weights (ROADMAP §C);
- ``TransformerEncoder``/``TransformerDecoder`` copy the first layer's
  initial weights into every other layer: they do not draw new ones.
"""

from __future__ import annotations

import collections
import copy
import math

import torch

from .. import functional as F
from .base import Layer, build_device
from .common import Dropout, Linear
from .containers import LayerList
from .norm import LayerNorm


def _convert_attn_mask(mask, dtype):
    if mask is None:
        return None
    if mask.dtype == torch.bool:
        zero = torch.zeros((), dtype=dtype, device=mask.device)
        return torch.where(mask, zero, torch.full((), -1e9, dtype=dtype,
                                                  device=mask.device))
    return mask.to(dtype)


class MultiHeadAttention(Layer):
    """Multi-head attention over (B, L, embed_dim) inputs; the output
    projection's input is the heads' outputs concatenated."""

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dropout, self.need_weights = dropout, need_weights
        self.head_dim = embed_dim // num_heads
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(kdim, embed_dim, weight_attr, bias_attr)
        self.v_proj = Linear(vdim, embed_dim, weight_attr, bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def _split_heads(self, x):
        B, L, _ = x.shape
        return x.reshape(B, L, self.num_heads, self.head_dim)

    def gen_cache(self, key, value=None, type=Cache):
        """A ``StaticCache`` of the projected ``key``/``value`` (cross
        attention), or an empty incremental ``Cache`` (B, 0, H, D)."""
        if type == MultiHeadAttention.StaticCache:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value if value is not None
                                              else key))
            return self.StaticCache(k, v)
        w = self.q_proj.weight
        shape = (key.shape[0], 0, self.num_heads, self.head_dim)
        return self.Cache(torch.zeros(shape, dtype=w.dtype, device=w.device),
                          torch.zeros(shape, dtype=w.dtype, device=w.device))

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._split_heads(self.q_proj(query))            # B, L, H, D
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value))
            if isinstance(cache, self.Cache):
                k = torch.cat([cache.k, k], 1)
                v = torch.cat([cache.v, v], 1)
                cache = self.Cache(k, v)
        mask = _convert_attn_mask(attn_mask, self.q_proj.weight.dtype)
        if self.need_weights:
            out, weights = self._attention_with_weights(q, k, v, mask)
        else:
            from ...ops.attention import masked_attention
            out = masked_attention(
                q, k, v, attn_mask=mask, dropout_p=self.dropout,
                training=self.training)
            weights = None
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self.embed_dim))
        outs = [out]
        if self.need_weights:
            outs.append(weights)
        if cache is not None and not isinstance(cache, self.StaticCache):
            outs.append(cache)
        return out if len(outs) == 1 else tuple(outs)

    def _attention_with_weights(self, q, k, v, mask):
        scale = torch.full((), 1.0 / math.sqrt(q.shape[-1]), dtype=q.dtype,
                           device=q.device)
        scores = torch.einsum("blhd,bmhd->bhlm", q, k) * scale
        if mask is not None:
            scores = scores + mask
        w = torch.softmax(scores, -1)
        out = torch.einsum("bhlm,bmhd->blhd", w, v)
        if self.dropout and self.training:
            out = F.dropout(out, self.dropout, training=True)
        return out, w


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([encoder_layer] + [
            copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, new_cache = mod(output, src_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             weight_attr=weight_attr,
                                             bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
            incremental_cache = None
        else:
            tgt, incremental_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                                    cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
            static_cache = None
        else:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask, cache[1])
            static_cache = cache[1]
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incremental_cache,
                                                static_cache))

    def gen_cache(self, memory):
        incremental = self.self_attn.gen_cache(memory)
        static = self.cross_attn.gen_cache(memory, memory,
                                           MultiHeadAttention.StaticCache)
        return incremental, static


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([decoder_layer] + [
            copy.deepcopy(decoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, new_cache = mod(output, memory, tgt_mask,
                                        memory_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        cache = [layer.gen_cache(memory) for layer in self.layers]
        if do_zip:
            cache = list(zip(*cache))
        return cache


class Transformer(Layer):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None):
        super().__init__()
        self.d_model, self.nhead = d_model, nhead
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            enc_norm = LayerNorm(d_model) if normalize_before else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            dec_norm = LayerNorm(d_model) if normalize_before else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              dec_norm)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length):
        """(length, length) float32: 0 on and below the diagonal, -inf
        above, on the build scope's device (else ``cuda``)."""
        return torch.triu(torch.full((length, length), -math.inf,
                                     dtype=torch.float32,
                                     device=build_device()), 1)


__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]
