"""GPT model family (counterpart of ``paddle_tpu/models/gpt.py``): the
ragged serving path (embedding, the mixed prefill+decode layer stack over
block pools, the tied head), the KV-cache path (``prefill``,
``decode_step`` over dense caches or ``PagedKV`` pools, ``generate`` from
the mixin) and the single-device training path
(``embed_fn`` → ``scan_blocks`` over flash-attention blocks →
``head_loss_fn``, and ``make_gpt_train_step``) over one device or a
hybrid mesh of data, pipe, sharding, sep and model ranks (the pipe axis
through ``distributed.pipeline_engine``: the blocks split over the pipe
ranks, the embedding on the first stage, the tied head on the last).

The parameters keep the reference's names and stacked ``[L, …]`` layout
(``stacked_param_names``), so a numpy state dict moves between the two
packages with no mapping (``params_from_numpy``).  Parameters are fp32;
matmuls run in ``config.compute_dtype`` with LayerNorm statistics in fp32,
as in the reference.

Over a mesh (:class:`MeshContext`, built by ``make_gpt_train_step``) a
rank holds the reference's ``addressable_shards[r]`` of every parameter
(the ``_dims_mapping`` below: ``wte`` split over the vocabulary, ``qkv``
and ``fc1`` over their output columns, ``proj`` and ``fc2`` over their
input rows) and computes Megatron's way:

- ``model`` (mp): each rank computes its nh/mp heads and its I/mp MLP
  columns; the column-parallel inputs go through ``copy_to_group`` and the
  row-parallel ``proj`` and ``fc2`` products end in an all-reduce
  (``reduce_from_group``); the embedding is a masked lookup of the rank's
  vocabulary rows, all-reduced; the tied head gives each rank its
  vocabulary columns of the logits and the loss reduces the max, the sum
  and the target logit over the group (``ops/loss.py``), never gathering
  the logits.  The reference's ``qkv`` shard is 3H/mp contiguous columns
  (rank 0 at mp 2 holds all of q and half of k): the state keeps it, and
  the step gathers the compute-dtype weight once and takes each rank's
  heads' q, k and v columns (the gather's gradient is reduce-scattered
  back; each column has one user, so the sums are exact).
- ``sep``: each rank embeds its sequence chunk at its global positions,
  and attention runs as ring, Ulysses (``ops/ring_attention.py``) or,
  with no ``sequence_parallel`` mode, over the gathered sequence.
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import resolve_device
from ..ops.attention import flash_attention
from ..ops.loss import (softmax_cross_entropy_mean,
                        vocab_parallel_cross_entropy_mean)
from ..ops.ragged_paged_attention import ragged_plan
from ._decode import (CausalDecoderMixin, PagedKV, cached_attention,
                      dequantize_cache, ragged_attention, ragged_write,
                      write_cache)

_COMPUTE_DTYPES = ("float32", "bfloat16", "float16")


class GPTConfig:
    """The reference's GPT config.  ``hidden_dropout_prob``,
    ``attention_probs_dropout_prob`` and ``use_flash_attention`` are kept
    and not read (the reference's GPT block applies no dropout and always
    calls ``flash_attention``); ``scan_unroll`` has no effect on the port's
    Python loop over layers.  ``sequence_parallel`` ("ring" or "ulysses")
    selects the attention over the ``sep`` ranks of a mesh; None gathers
    the sequence for attention, as the reference's GSPMD does."""

    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_attention_heads=12, intermediate_size=None,
                 max_position_embeddings=1024, hidden_dropout_prob=0.0,
                 attention_probs_dropout_prob=0.0, initializer_range=0.02,
                 layer_norm_epsilon=1e-5, compute_dtype="bfloat16",
                 use_flash_attention=True, tie_word_embeddings=True,
                 sequence_parallel=None, scan_unroll=1,
                 hidden_act="gelu_approx", kv_cache_dtype=None):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.max_position_embeddings = max_position_embeddings
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.initializer_range = initializer_range
        self.layer_norm_epsilon = layer_norm_epsilon
        if compute_dtype not in _COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of "
                             f"{_COMPUTE_DTYPES}, got {compute_dtype!r}")
        self.compute_dtype = compute_dtype
        self.use_flash_attention = use_flash_attention
        self.tie_word_embeddings = tie_word_embeddings
        self.scan_unroll = scan_unroll
        # GPT-2's canonical activation is the tanh approximation
        if hidden_act not in ("gelu", "gelu_approx"):
            raise ValueError(f"hidden_act must be 'gelu' or 'gelu_approx', "
                             f"got {hidden_act!r}")
        self.hidden_act = hidden_act
        # None → KV pool in compute_dtype; "int8" → (values, scales) pools
        if kv_cache_dtype not in (None, "int8"):
            raise ValueError(f"kv_cache_dtype must be None or 'int8', "
                             f"got {kv_cache_dtype!r}")
        self.kv_cache_dtype = kv_cache_dtype
        if sequence_parallel not in (None, "ring", "ulysses"):
            raise ValueError(f"sequence_parallel must be None, 'ring' or "
                             f"'ulysses', got {sequence_parallel!r}")
        self.sequence_parallel = sequence_parallel


# canonical sizes (GPT-3 paper / fleet configs)
GPT_CONFIGS = {
    "gpt2-small": dict(hidden_size=768, num_layers=12, num_attention_heads=12),
    "gpt2-medium": dict(hidden_size=1024, num_layers=24, num_attention_heads=16),
    "gpt2-large": dict(hidden_size=1280, num_layers=36, num_attention_heads=20),
    "gpt3-1.3B": dict(hidden_size=2048, num_layers=24, num_attention_heads=16),
    "gpt3-2.7B": dict(hidden_size=2560, num_layers=32, num_attention_heads=32),
    "gpt3-6.7B": dict(hidden_size=4096, num_layers=32, num_attention_heads=32),
    "gpt3-13B": dict(hidden_size=5120, num_layers=40, num_attention_heads=40),
}


def gpt_preset(name: str, **overrides) -> GPTConfig:
    cfg = dict(GPT_CONFIGS[name])
    cfg.update(overrides)
    return GPTConfig(**cfg)


def _layer(pool, l):
    """Layer ``l``'s view of a stacked pool or cache (int8 pairs and
    ``PagedKV`` included; the table is shared across layers); writes
    through the view land in the stack."""
    if isinstance(pool, PagedKV):
        return PagedKV(_layer(pool.pool, l), pool.table)
    return tuple(p[l] for p in pool) if isinstance(pool, tuple) else pool[l]


class StackedDecoder(CausalDecoderMixin, nn.Module):
    """What the port's causal LMs share: stacked ``blocks_*`` parameters
    with a pre-LN fused-QKV attention half, weights cast to
    ``config.compute_dtype`` (``_cw``), and the KV-cache paths (the ragged
    pack, ``prefill``, ``decode_step``) as a loop over layers.  A subclass
    defines the block's second half, ``_block_post_attn(l, h, att)``, and
    names its config's class (``config_class``)."""

    config_class = None

    @classmethod
    def from_numpy(cls, np_state, config, device=None):
        """The model built from a numpy state dict keyed by the reference's
        parameter names (``load_numpy_state``), on ``device``."""
        dev = resolve_device(device)
        return load_numpy_state(cls(config, device="meta").to_empty(
            device=dev), np_state)

    @staticmethod
    def _initializers(dev, std, generator):
        """(normal, zeros, ones): fp32 parameter makers on ``dev``;
        ``normal(shape, s=std)`` draws N(0, s) from ``generator`` (default
        seeded 0; nothing is drawn on the meta device)."""
        if generator is None and dev.type != "meta":
            generator = torch.Generator(device=dev).manual_seed(0)

        def normal(shape, s=std):
            t = torch.empty(shape, dtype=torch.float32, device=dev)
            if dev.type != "meta":
                t.normal_(0.0, s, generator=generator)
            return nn.Parameter(t)

        def zeros(shape):
            return nn.Parameter(torch.zeros(shape, device=dev))

        def ones(shape):
            return nn.Parameter(torch.ones(shape, device=dev))

        return normal, zeros, ones

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.config.compute_dtype)

    def _cw(self, name, l=None):
        """Parameter ``name`` (layer ``l``'s slice of a stacked one) in the
        compute dtype.  Where autograd records (training), the slice is cast
        on every call, as in the reference, so the gradient flows back to
        the fp32 parameter.  Otherwise (serving, under ``no_grad``) the
        whole parameter is cast once and reused until it changes (in place
        or by a move), with the same values."""
        p = getattr(self, name)
        dt = self.compute_dtype
        if p.dtype == dt:
            return p if l is None else p[l]
        if torch.is_grad_enabled() and p.requires_grad:
            return (p if l is None else p[l]).to(dt)
        stamp = (p.data_ptr(), p._version, dt)
        hit = self._casts.get(name)
        if hit is None or hit[0] != stamp:
            hit = self._casts[name] = (stamp, p.detach().to(dt))
        return hit[1] if l is None else hit[1][l]

    # ----------------------------------------------------------- blocks --

    def _block_ln(self, x, w, b, dt):
        # written out (population variance, rsqrt in fp32), not
        # F.layer_norm, so fp32 parity with the reference stays tight
        x32 = x.float()
        m = x32.mean(-1, keepdim=True)
        v = (x32 - m).square().mean(-1, keepdim=True)
        return ((x32 - m) * torch.rsqrt(v + self.config.layer_norm_epsilon)
                * w + b).to(dt)

    def _block_qkv(self, l, h, par=None):
        """Layer ``l``'s pre-LN + QKV projection; q, k, v (B, L, nh, hd)
        (nh/mp heads, this rank's, under a model-parallel ``par``)."""
        c = self.config
        B, Lq, H = h.shape
        hd = H // c.num_attention_heads
        a_in = self._block_ln(h, self.blocks_ln1_w[l], self.blocks_ln1_b[l],
                              h.dtype)
        if par is not None and par.heads_split:
            qkv = par.copy(a_in) @ par.qkv_w[l] + par.qkv_b[l]
        else:
            qkv = a_in @ self._cw("blocks_qkv_w", l) \
                + self._cw("blocks_qkv_b", l)
        q, k, v = qkv.split(qkv.shape[-1] // 3, -1)
        nh = q.shape[-1] // hd
        return (q.reshape(B, Lq, nh, hd), k.reshape(B, Lq, nh, hd),
                v.reshape(B, Lq, nh, hd))

    def _attn_residual(self, l, h, att, par=None):
        """Layer ``l``'s output projection + residual (a row-parallel
        product all-reduced over the model ranks under ``par``)."""
        B, Lq, H = h.shape
        out = att.reshape(B, Lq, -1) @ self._cw("blocks_proj_w", l)
        if par is not None and par.heads_split:
            out = par.reduce(out)
        return h + out + self._cw("blocks_proj_b", l)

    def _block_post_attn(self, l, h, att):
        raise NotImplementedError

    def _block_decode_ragged(self, l, h, pck, pcv, table, row_seq, row_pos,
                             pad_lens, plan):
        """Layer ``l`` for a flattened ragged pack: h (1, T, H); pck/pcv
        are this layer's block pools; ``plan`` the attention kernel's work
        list (the CPU's plain version reads none).  Each row's k/v is
        written to its pool position BEFORE attention, so a prefill
        chunk's rows attend each other's fresh keys."""
        q, k, v = self._block_qkv(l, h)                    # (1, T, nh, hd)
        ragged_write(pck, k[0], table, row_seq, row_pos)
        ragged_write(pcv, v[0], table, row_seq, row_pos)
        att = ragged_attention(q[0].contiguous(), pck, pcv, table, row_seq,
                               row_pos, pad_lens, plan)
        return self._block_post_attn(l, h, att[None])

    @torch.no_grad()
    def decode_ragged(self, h, pools, table, row_seq, row_pos, pad_lens,
                      plan=None):
        """All layers for one mixed ragged step: h (1, T, H) from
        ``_embed_ragged``; ``pools`` = (pool_k, pool_v) stacked over layers
        (int8 ``(values, scales)`` pairs included), updated IN PLACE; table
        (S, C) int32 shared across layers; row metadata as
        ``ops/ragged_paged_attention.ragged_rows``; ``plan`` the attention
        kernel's ``ragged_plan`` of these rows, built here on a card when
        None.  Every layer shares it.  Returns (h, pools)."""
        ck, cv = pools
        if plan is None and h.device.type == "cuda":
            plan = ragged_plan(row_seq, row_pos, pad_lens)
        for l in range(self.config.num_layers):
            h = self._block_decode_ragged(l, h, _layer(ck, l), _layer(cv, l),
                                          table, row_seq, row_pos, pad_lens,
                                          plan)
        return h, pools

    # --------------------------------------------------- KV-cache decode --

    def _block_decode(self, l, h, ck, cv, t, pad_lens=None):
        """Layer ``l`` for new tokens at positions [t, t+k): h (B, k, H);
        ck/cv are this layer's caches ((B, max_len, nh, hd), int8 pairs or
        ``PagedKV``), written in place at t BEFORE attention over cache
        positions <= t (later slots — and left-pad slots, when pad_lens is
        set — masked)."""
        q, k, v = self._block_qkv(l, h)
        write_cache(ck, k, t)
        write_cache(cv, v, t)
        dt = q.dtype
        att = cached_attention(q, dequantize_cache(ck, dt),
                               dequantize_cache(cv, dt), t,
                               pad_lens=pad_lens)
        return self._block_post_attn(l, h, att)

    @torch.no_grad()
    def prefill(self, input_ids, max_len: int, pad_lens=None):
        """Run the prompt through all layers: the final hidden states
        (B, P, H) and fresh caches (L, B, max_len, nh, hd) filled at
        positions [0, P) (int8 configs quantize, then pad).  With
        ``pad_lens`` (left-padded prompts) embedding positions shift and
        pad keys are masked."""
        c = self.config
        B, P = input_ids.shape
        if pad_lens is None:
            h, key_mask = self.embed_fn(input_ids), None
        else:
            h = self._prefill_embed(input_ids, pad_lens)
            key_mask = self._prefill_key_mask(P, pad_lens)
        ck, cv = self.init_cache(B, max_len)
        for l in range(c.num_layers):
            q, k, v = self._block_qkv(l, h)
            att = flash_attention(q, k, v, causal=True, key_mask=key_mask)
            h = self._block_post_attn(l, h, att)
            write_cache(_layer(ck, l), k, 0)
            write_cache(_layer(cv, l), v, 0)
        return h, (ck, cv)

    @torch.no_grad()
    def decode_step(self, h, caches, t, pad_lens=None):
        """All layers for new tokens at [t, t+k): h (B, k, H); ``caches`` =
        (ck, cv) stacked over layers — dense, int8 pairs, or ``PagedKV``
        over stacked pools — updated IN PLACE.  Returns (h, caches)."""
        ck, cv = caches
        for l in range(self.config.num_layers):
            h = self._block_decode(l, h, _layer(ck, l), _layer(cv, l), t,
                                   pad_lens=pad_lens)
        return h, caches

    def embed_fn(self, input_ids, key=None, par=None):
        """Token plus position embeddings in the compute dtype.  With
        ``par`` (a :class:`MeshContext`) the ids are this rank's chunk,
        embedded at its global positions, and a ``wte`` split over the
        model ranks is looked up masked and all-reduced."""
        Lq = input_ids.shape[-1]
        pos = torch.arange(Lq, device=input_ids.device)
        if par is None:
            emb = F.embedding(input_ids.long(), self.wte)
        else:
            pos = pos + par.sep_rank * Lq
            emb = par.vocab_lookup(input_ids, self.wte)
        return (emb + self.wpe[pos]).to(self.compute_dtype)


class GPTModel(StackedDecoder):
    """Decoder-only transformer with stacked block parameters.

    ``device`` defaults to ``cuda``; ``generator`` (a ``torch.Generator``
    on that device, default seeded 0) draws the N(0, initializer_range)
    weights, with proj/fc2 at ``initializer_range / sqrt(2L)``."""

    config_class = GPTConfig

    def __init__(self, config: GPTConfig, *, device=None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.config = c = config
        L, H, V = c.num_layers, c.hidden_size, c.vocab_size
        I = c.intermediate_size
        std = c.initializer_range
        normal, zeros, ones = self._initializers(dev, std, generator)
        self.wte = normal([V, H])
        self.wpe = normal([c.max_position_embeddings, H])
        self.blocks_ln1_w = ones([L, H])
        self.blocks_ln1_b = zeros([L, H])
        self.blocks_qkv_w = normal([L, H, 3 * H])
        self.blocks_qkv_b = zeros([L, 3 * H])
        self.blocks_proj_w = normal([L, H, H], std / math.sqrt(2 * L))
        self.blocks_proj_b = zeros([L, H])
        self.blocks_ln2_w = ones([L, H])
        self.blocks_ln2_b = zeros([L, H])
        self.blocks_fc1_w = normal([L, H, I])
        self.blocks_fc1_b = zeros([L, I])
        self.blocks_fc2_w = normal([L, I, H], std / math.sqrt(2 * L))
        self.blocks_fc2_b = zeros([L, H])
        self.lnf_w = ones([H])
        self.lnf_b = zeros([H])
        if not c.tie_word_embeddings:
            self.lm_head = normal([H, V])
        self._casts = {}
        mark_dims_mapping(self)

    @staticmethod
    def stacked_param_names():
        return [f"blocks_{n}" for n in ("ln1_w", "ln1_b", "qkv_w", "qkv_b",
                                        "proj_w", "proj_b", "ln2_w", "ln2_b",
                                        "fc1_w", "fc1_b", "fc2_w", "fc2_b")]

    def _block_post_attn(self, l, h, att, par=None):
        """Layer ``l``'s output projection + residual + MLP half (this
        rank's I/mp columns, then an all-reduce, under a model-parallel
        ``par``)."""
        h = self._attn_residual(l, h, att, par)
        m_in = self._block_ln(h, self.blocks_ln2_w[l], self.blocks_ln2_b[l],
                              h.dtype)
        mlp_split = par is not None and par.mlp_split
        if mlp_split:
            m_in = par.copy(m_in)
        approx = "tanh" if self.config.hidden_act == "gelu_approx" else "none"
        ff = F.gelu(m_in @ self._cw("blocks_fc1_w", l)
                    + self._cw("blocks_fc1_b", l), approximate=approx)
        out = ff @ self._cw("blocks_fc2_w", l)
        if mlp_split:
            out = par.reduce(out)
        return h + out + self._cw("blocks_fc2_b", l)

    # ------------------------------------------------------------- head --

    def _head_logits(self, h, par=None):
        """Logits in the compute dtype: this rank's vocabulary columns
        when ``par`` splits the head over the model ranks."""
        c = self.config
        x32 = h.float()
        m = x32.mean(-1, keepdim=True)
        v = (x32 - m).square().mean(-1, keepdim=True)
        h = (x32 - m) * torch.rsqrt(v + c.layer_norm_epsilon) * self.lnf_w \
            + self.lnf_b
        w = (self._cw("wte").T if c.tie_word_embeddings
             else self._cw("lm_head"))
        h = h.to(self.compute_dtype)
        if par is not None and par.head_split:
            h = par.copy(h)
        return h @ w

    def head_fn(self, h):
        return self._head_logits(h).float()

    def decode_logits(self, h):
        """fp32 logits for the decode paths."""
        return self.head_fn(h)

    # --------------------------------------------------------- training --
    # The reference's pure functions take a params pytree; here they read
    # the module's own parameters, which the train step updates in place.

    def block_fn(self, l, h, key=None, par=None):
        """Layer ``l``: pre-LN causal flash attention, then the MLP half
        (over ``par``'s sequence and model ranks when given)."""
        q, k, v = self._block_qkv(l, h, par)
        att = (flash_attention(q, k, v, causal=True) if par is None
               else par.attention(q, k, v))
        return self._block_post_attn(l, h, att, par)

    def head_loss_fn(self, h, labels, par=None):
        """Fused CE on compute-dtype logits (never an fp32 (B, L, V)
        log-prob tensor); over vocabulary-split logits when ``par`` splits
        the head (the same mean, on every model rank)."""
        logits = self._head_logits(h, par)
        if par is not None and par.head_split:
            return vocab_parallel_cross_entropy_mean(logits, labels, par.mp)
        return softmax_cross_entropy_mean(logits, labels)

    def scan_blocks(self, h, key=None, remat=True, par=None):
        """All layers in order.  ``remat``: False saves every activation;
        True recomputes each block in the backward (``torch.utils.
        checkpoint``); "dots" saves the matmul outputs and recomputes the
        rest (a selective-checkpoint policy, the counterpart of the
        reference's ``dots_with_no_batch_dims_saveable``)."""
        if remat not in (False, True, "dots"):
            raise ValueError(f"remat must be False, True or 'dots', got "
                             f"{remat!r}")
        kw = {}
        if remat == "dots":
            kw["context_fn"] = _save_dots_context
        for l in range(self.config.num_layers):
            if remat:
                h = checkpoint(self.block_fn, l, h, key, par,
                               use_reentrant=False, **kw)
            else:
                h = self.block_fn(l, h, key, par)
        return h

    def forward(self, input_ids):
        """fp32 logits (B, L, V), no recompute."""
        h = self.scan_blocks(self.embed_fn(input_ids), remat=False)
        return self.head_fn(h)


class GPTForPretraining(GPTModel):
    """LM head + loss: mean CE through ``log_softmax`` of the fp32 logits,
    as the reference's ``GPTForPretraining``."""

    def forward(self, input_ids, labels=None):
        logits = super().forward(input_ids)
        if labels is None:
            return logits
        logp = torch.log_softmax(logits, -1)
        return -logp.gather(-1, labels.long()[..., None]).mean()


_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default)


def _save_dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _save_dots_context():
    return create_selective_checkpoint_contexts(_save_dots_policy)


#: the reference's model-axis layout of GPT's parameters
#: (``paddle_tpu/models/gpt.py:124-147``): vocabulary-parallel ``wte``,
#: column-parallel ``qkv``/``fc1``, row-parallel ``proj``/``fc2``
DIMS_MAPPING = {"wte": {0: "model"}, "blocks_qkv_w": {2: "model"},
                "blocks_qkv_b": {1: "model"}, "blocks_proj_w": {1: "model"},
                "blocks_fc1_w": {2: "model"}, "blocks_fc1_b": {1: "model"},
                "blocks_fc2_w": {1: "model"}, "lm_head": {1: "model"}}


def mark_dims_mapping(model, mapping=None):
    """Set the reference's ``_dims_mapping`` on ``model``'s parameters
    (what ``sharding_rules.build_param_specs`` reads): ``mapping``, GPT's
    ``DIMS_MAPPING`` by default."""
    mapping = DIMS_MAPPING if mapping is None else mapping
    for n, p in model.named_parameters():
        if n in mapping:
            p._dims_mapping = dict(mapping[n])
    return model


class MeshContext:
    """What one rank of a data × sharding × sep × model mesh computes a
    model of stacked ``blocks_*`` with (module docstring): its model and
    sep groups, which parts ``specs`` (the parameters' partition specs)
    split over the model ranks, and the attention over the sep ranks (the
    config's ``sequence_parallel``, if it has one).  GPT, BERT and
    ERNIE-MoE share it: ``vocab`` names the embedding table looked up
    (``wte``, BERT's ``word_emb``), ``head`` the head's weight (default
    the tied ``wte``, or ``lm_head`` when the config unties it), ``bias``
    a head bias split with it (BERT's ``mlm_bias``), ``mlp`` the
    column- and row-parallel MLP weights (None where the FFN is not split:
    ERNIE's experts).  The head-aligned QKV weight and bias of a step are
    set by :meth:`bind`."""

    def __init__(self, mesh, specs, config, vocab="wte", head=None,
                 bias=None, mlp=("blocks_fc1_w", "blocks_fc2_w")):
        from ..distributed.sharding_rules import _entry_axes

        def split(name):
            return any("model" in _entry_axes(e)
                       for e in specs.get(name, ()))

        if head is None:
            head = ("wte" if getattr(config, "tie_word_embeddings", True)
                    else "lm_head")
        self.mp = mesh.axis_group("model")
        self.sep = mesh.axis_group("sep")
        self.sep_rank = mesh.coord.get("sep", 0)
        self.mode = getattr(config, "sequence_parallel", None)
        split_mp = self.mp.nranks > 1
        self.vocab_split = split_mp and split(vocab)
        self.head_split = split_mp and split(head)
        self.heads_split = split_mp and split("blocks_qkv_w")
        self.mlp_split = split_mp and mlp is not None and split(mlp[0])
        nh = config.num_attention_heads
        if self.heads_split and nh % self.mp.nranks:
            raise ValueError(
                f"num_attention_heads ({nh}) must divide by the model degree "
                f"({self.mp.nranks}): a rank computes whole heads")
        if self.heads_split != split("blocks_proj_w") or (
                mlp is not None and self.mlp_split != split(mlp[1])) or (
                bias is not None and self.head_split != split(bias)):
            raise ValueError("the column- and row-parallel halves of a "
                             "block, and a head and its bias, must split "
                             "alike over the model ranks")
        self.qkv_w = self.qkv_b = None

    def copy(self, x):
        from ..distributed.collective import copy_to_group
        return copy_to_group(x, self.mp)

    def reduce(self, x):
        from ..distributed.collective import reduce_from_group
        return reduce_from_group(x, self.mp)

    def bind(self, model):
        """A copy holding this step's QKV weight and bias: the compute-dtype
        shards gathered over the model ranks, this rank's heads' q, k and
        v columns kept (the reference's shard is contiguous 3H/mp columns;
        module docstring)."""
        if not self.heads_split:
            return self
        from ..distributed.collective import gather_along
        R, m = self.mp.nranks, self.mp.rank

        def heads(t):
            full = gather_along(t, t.dim() - 1, self.mp)   # (..., 3H)
            lead = full.shape[:-1]
            blk = full.reshape(*lead, 3, R, full.shape[-1] // (3 * R))
            return blk[..., m, :].reshape(*lead, -1)

        bound = copy.copy(self)
        bound.qkv_w = heads(model._cw("blocks_qkv_w"))
        bound.qkv_b = heads(model._cw("blocks_qkv_b"))
        return bound

    def vocab_lookup(self, ids, wte):
        """fp32 embeddings of ``ids``: a masked lookup of this rank's
        vocabulary rows, all-reduced over the model ranks, when they
        split ``wte``."""
        if not self.vocab_split:
            return F.embedding(ids.long(), wte)
        from ..distributed.fleet.meta_parallel.parallel_layers.mp_layers \
            import vocab_parallel_embedding
        return vocab_parallel_embedding(ids, wte, self.mp)

    def attention(self, q, k, v):
        """Causal attention of this rank's (B, Lc, heads, hd) blocks: over
        the sep ranks by ``mode`` (ring, Ulysses, or the gathered
        sequence), else ``flash_attention``."""
        if self.sep.nranks <= 1:
            return flash_attention(q, k, v, causal=True)
        from ..ops import ring_attention as RA
        if self.mode is None:
            return RA.gathered_attention(q, k, v, causal=True,
                                         group=self.sep)
        return RA.sequence_parallel_attention(q, k, v, causal=True,
                                              mode=self.mode, group=self.sep)


def _mesh_degrees(hcg):
    """Parallel degrees of ``hcg`` (None, or a hybrid group with Paddle's
    ``get_*_world_size`` getters): {axis: degree}."""
    if hcg is None:
        return {}
    getters = {"dp": "get_data_parallel_world_size",
               "mp": "get_model_parallel_world_size",
               "pp": "get_pipe_parallel_world_size",
               "sharding": "get_sharding_parallel_world_size",
               "sep": "get_sep_parallel_world_size"}
    return {axis: int(getattr(hcg, g)()) for axis, g in getters.items()
            if hasattr(hcg, g)}


def _check_degrees(hcg, runs=()):
    """The model and sep degrees of a model not in ``runs`` wait for their
    slice (BERT's and ERNIE-MoE's sequence parallelism: ROADMAP A7b); a
    pipe degree runs everywhere (GPT's pipeline; BERT and ERNIE-MoE, as
    the reference, hold the pipe axis replicated).  Returns the hybrid
    group's mesh (None without one)."""
    degrees = _mesh_degrees(hcg)
    for axis in ("mp", "sep"):
        if axis not in runs and degrees.get(axis, 1) > 1:
            raise NotImplementedError(
                f"{axis} degree {degrees[axis]} waits for ROADMAP A7b "
                f"(BERT's and ERNIE-MoE's sequence parallelism)")
    return None if hcg is None else hcg.mesh


def _refuse_composed(hcg, what):
    """ZeRO and update sharding compose with the data and sharding axes
    only: over model or sep ranks they raise (ROADMAP A7b)."""
    degrees = _mesh_degrees(hcg)
    if degrees.get("mp", 1) > 1 or degrees.get("sep", 1) > 1:
        raise NotImplementedError(
            f"{what} with a model or sep degree waits for ROADMAP A7b "
            f"(ZeRO and update sharding composed with tensor and sequence "
            f"parallelism); this step runs them over data and sharding")


def _rank_batch_info(mesh):
    """``instrument_train_step``'s (examples, tokens) for a rank that takes
    1/R of the rows it is given and 1/S of their sequence (None on one
    rank): a model group and a pipe group count their tokens once (on
    their first rank), and a sep group its examples once."""
    if mesh is None or mesh.size <= 1:
        return None
    from ..telemetry import _default_batch_info
    R = mesh.batch_group()[0].nranks
    S = mesh.shape.get("sep", 1)
    first = mesh.coord.get("model", 0) == 0 and \
        mesh.coord.get("pipe", 0) == 0
    first_sep = mesh.coord.get("sep", 0) == 0

    def info(args, kwargs):
        ex, tok = _default_batch_info(args)
        return (ex // R if first and first_sep else 0,
                tok // (R * S) if first else 0)
    return info


def _mesh_context(model, mesh, params0, mapping=None, **names):
    """The :class:`MeshContext` of ``model`` over ``mesh`` (None off a
    model or sep mesh; ``names`` its parameter names) after marking
    ``mapping`` (GPT's by default), and the sequence dim the step splits
    (1, or None without sep ranks)."""
    if mesh is None or (mesh.shape.get("model", 1) <= 1
                        and mesh.shape.get("sep", 1) <= 1):
        return None, None
    from ..distributed.sharding_rules import build_param_specs
    mark_dims_mapping(model, mapping)
    par = MeshContext(mesh, build_param_specs(params0, mesh, model),
                      model.config, **names)
    return par, (1 if par.sep.nranks > 1 else None)


def _gpt_loss(model, par, remat):
    def loss_of(params, key, x, labels):
        # ``params`` are the tensors ``model`` holds for this call (its own
        # parameters, or the state's swapped in)
        p = None if par is None else par.bind(model)
        h = model.scan_blocks(model.embed_fn(x, key, p), key, remat=remat,
                              par=p)
        return model.head_loss_fn(h, labels, p)
    return loss_of


def make_gpt_train_step(model: GPTModel, optimizer, hcg=None,
                        n_microbatches: int = 1, remat=True,
                        donate: bool = True, zero_stage: int = 0,
                        dynamic_loss_scale: bool = False,
                        virtual_pp_degree=None, monitor=None, grad_comm=None,
                        update_sharding: bool = False):
    """The GPT train step: ``step(state, key, lr, input_ids, labels) ->
    (state, loss)``.  ``hcg`` None (one device) or a hybrid group over
    data, sharding, sep and model degrees: each rank is given the global
    batch, takes its rows (and, over sep ranks, its sequence chunk), holds
    its shards of the parameters (model axis) and slots, and the loss is
    the global mean (``distributed.spmd``; module docstring for the model
    and sep axes).

    - ``zero_stage`` > 0 routes through ``distributed.zero`` (slots and
      fp32 masters sharded, grads reduce-scattered at stage 2, params
      sharded at stage 3, ``found_inf`` and ``dynamic_loss_scale``);
      ``step.layout`` is then the state's checkpoint ``Layout``;
    - ``update_sharding`` shards the weight update over the data ranks
      (``distributed.update_sharding``, arXiv:2004.13336);
    - otherwise the mesh step (slots ZeRO-1-sharded over "sharding" as
      the reference's specs give them).

    ``grad_comm`` ("fp32"/"bf16"/"int8_ef" or a policy): local mode in the
    mesh and ZeRO steps, wire mode under ``update_sharding``.  With
    ``donate`` (the default) ``state["params"]`` are the model's own
    parameters (their shards under ZeRO-3 or the model axis), updated in
    place.  ``key`` is accepted and not read: GPT's block applies no
    dropout.  ``monitor`` wraps the step in ``instrument_train_step``
    (with ``comm`` events under a compressing policy; each rank counts its
    own rows).  ``dynamic_loss_scale`` outside ZeRO, ``virtual_pp_degree``
    and ``n_microbatches`` are ignored, as in the reference off its
    pipeline branch.  ZeRO or update sharding with a model or sep degree
    raises (ROADMAP A7b).

    A pipe degree S > 1 takes the pipeline (``distributed.
    pipeline_engine.make_stacked_pipeline_step``): the blocks split over
    the pipe ranks, 1F1B over ``max(n_microbatches, S)`` micro-batches,
    interleaved over ``virtual_pp_degree`` chunks (default the hybrid
    group's), composed with data and model degrees.  There, as in the
    reference, a ``grad_comm`` other than fp32, ZeRO and
    ``dynamic_loss_scale`` raise ``NotImplementedError`` and a
    ``sequence_parallel`` mode over sep ranks ``ValueError``; update
    sharding, and sep ranks without a mode, raise too."""
    from ..distributed.grad_comm import comm_info, resolve_policy
    from ..distributed.spmd import make_gspmd_step_from_loss
    from ..telemetry import instrument_train_step

    if _mesh_degrees(hcg).get("pp", 1) > 1:
        return _gpt_pipeline_step(model, optimizer, hcg, n_microbatches,
                                  remat, donate, zero_stage,
                                  dynamic_loss_scale, virtual_pp_degree,
                                  monitor, grad_comm, update_sharding)
    if zero_stage > 0 and update_sharding:
        raise ValueError(
            "update_sharding composes the plain-DP regime; zero_stage>0 "
            "already shards the optimizer state over 'sharding' — pick one")
    if zero_stage > 0 or update_sharding:
        _refuse_composed(hcg, f"zero_stage {zero_stage}" if zero_stage
                         else "update_sharding")
    mesh = _check_degrees(hcg, runs=("mp", "sep"))
    policy = resolve_policy(grad_comm)
    params0 = dict(model.named_parameters())
    par, seq_dim = _mesh_context(model, mesh, params0)
    loss_of = _gpt_loss(model, par, remat)

    if zero_stage > 0:
        from ..distributed.zero import make_zero_train_step
        inner, state0 = make_zero_train_step(
            loss_of, params0, optimizer, mesh, layer=model,
            zero_stage=zero_stage, dynamic_loss_scale=dynamic_loss_scale,
            donate=donate, grad_comm=policy)
        name = "zero"
    elif update_sharding:
        from ..distributed.update_sharding import \
            make_dp_update_sharded_train_step
        from ..distributed.zero import _as_mesh
        # batch layout: (key, x, labels) — the key rides whole
        inner, state0 = make_dp_update_sharded_train_step(
            loss_of, params0, optimizer, _as_mesh(mesh), donate=donate,
            grad_comm=policy, replicated_args=(0,), layer=model)
        name = "dp_update_sharded"
    else:
        inner, state0 = make_gspmd_step_from_loss(
            loss_of, params0, optimizer, mesh, layer=model, donate=donate,
            grad_comm=policy, seq_dim=seq_dim)
        name = "gpt"
    inner = instrument_train_step(inner, monitor, name,
                                  batch_info=_rank_batch_info(mesh),
                                  comm=comm_info(params0, policy))

    def step(state, key, lr, x, labels):
        return inner(state, lr, key, x, labels)

    if hasattr(inner, "layout"):
        step.layout = inner.layout
    return step, state0


def _gpt_pipeline_step(model, optimizer, hcg, n_microbatches, remat,
                       donate, zero_stage, dynamic_loss_scale,
                       virtual_pp_degree, monitor, grad_comm,
                       update_sharding):
    """``make_gpt_train_step``'s pipe branch (reference
    ``paddle_tpu/models/gpt.py:461-485``): its refusals, then the stacked
    pipeline step with the embedding on the first global stage and the
    tied head on the last."""
    from ..distributed.grad_comm import resolve_policy
    from ..distributed.pipeline_engine import make_stacked_pipeline_step
    policy = resolve_policy(grad_comm)
    degrees = _mesh_degrees(hcg)
    S = degrees["pp"]
    if policy.name != "fp32":
        raise NotImplementedError(
            "grad_comm with pp_degree>1 is not wired yet: the stacked "
            "pipeline step owns its own exchange schedule; use "
            "pp_degree=1 for compressed gradient collectives")
    if zero_stage > 0 or dynamic_loss_scale:
        raise NotImplementedError(
            "zero_stage/dynamic_loss_scale with pp_degree>1 is not wired "
            "yet: the stacked pipeline step manages its own state layout. "
            "Use pp_degree=1 for ZeRO")
    if degrees.get("sep", 1) > 1:
        if model.config.sequence_parallel:
            raise ValueError(
                "sequence_parallel with pp_degree>1 is not supported yet: "
                "the pipeline's stages cannot nest the 'sep' ring; set "
                "sep_degree=1 or pp_degree=1")
        raise NotImplementedError(
            "sep ranks beside a pipe degree wait for ROADMAP A7b (the "
            "reference holds the sequence whole over them)")
    if update_sharding:
        raise NotImplementedError(
            "update_sharding with pp_degree>1: the pipeline step keeps its "
            "own state layout (ROADMAP §C)")
    if virtual_pp_degree is None:
        getter = getattr(hcg, "get_virtual_pipeline_degree", None)
        virtual_pp_degree = getter() if getter else 1
    mesh = hcg.mesh
    params0 = dict(model.named_parameters())
    par, _ = _mesh_context(model, mesh, params0)
    step, state0 = make_stacked_pipeline_step(
        lambda x, key: model.embed_fn(x, key, par), model.block_fn,
        lambda h, labels: model.head_loss_fn(h, labels, par), params0,
        optimizer, hcg, model.config.num_layers, max(n_microbatches, S),
        model.stacked_param_names(), layer=model, donate=donate,
        remat=remat, virtual_pp_degree=virtual_pp_degree, monitor=monitor,
        bind=None if par is None else (lambda: par.bind(model)),
        batch_info=_rank_batch_info(mesh))
    return step, state0


def make_sharded_gpt_train_step(cfg: GPTConfig, optimizer, hcg,
                                zero_stage: int = 0, seed: int = 0,
                                remat=True, donate: bool = True,
                                monitor=None, grad_comm=None, device=None):
    """The GPT train step with the model built here from ``seed`` on
    ``device`` (default cuda) and each rank keeping its shards of the
    state (``zero_stage`` as sharding SPECS only: 3 shards the parameters;
    the contractual ZeRO extras ride ``make_gpt_train_step``), over data,
    sharding and model degrees.  The reference initialises each device's
    shard directly; here each rank builds the whole model once (the same
    seed on every rank) and keeps its blocks (``ROADMAP.md`` §C).
    ``grad_comm`` runs in local mode (a stateful policy adds a flat
    ``"comm_e"``).  A ``sequence_parallel`` mode or a sep degree raises,
    as in the reference (``ROADMAP.md`` §C); ZeRO specs with a model
    degree raise (ROADMAP A7b).  Returns ``(step, state0)`` with
    ``step(state, lr, key, x, labels)``."""
    from .. import resolve_device
    from ..distributed.grad_comm import comm_info, resolve_policy
    from ..distributed.spmd import make_gspmd_sharded_init_step
    from ..telemetry import instrument_train_step

    if cfg.sequence_parallel is not None or \
            _mesh_degrees(hcg).get("sep", 1) > 1:
        raise NotImplementedError(
            "sharded init does not run sequence parallelism, as the "
            "reference's does not (ROADMAP §C, the refusals that stay): use "
            "make_gpt_train_step over sep ranks")
    if zero_stage > 0:
        _refuse_composed(hcg, f"zero_stage {zero_stage}")
    mesh = _check_degrees(hcg, runs=("mp",))
    dev = resolve_device(device)
    model = GPTModel(cfg, device=dev,
                     generator=torch.Generator(dev).manual_seed(seed))

    def build(seed):
        return dict(model.named_parameters())

    par, _ = _mesh_context(model, mesh, build(seed))
    policy = resolve_policy(grad_comm)
    step, state0 = make_gspmd_sharded_init_step(
        _gpt_loss(model, par, remat), build, optimizer, mesh, model,
        zero_stage=zero_stage, donate=donate, seed=seed, grad_comm=policy)
    return instrument_train_step(
        step, monitor, "gpt_sharded", batch_info=_rank_batch_info(mesh),
        comm=comm_info(build(seed), policy)), state0


def params_from_numpy(np_state, config: GPTConfig, device=None) -> GPTModel:
    """Build the port's model from a numpy state dict keyed by the
    reference's parameter names (``{n: np.asarray(p._data) for n, p in
    model.named_parameters()}`` of a ``paddle_tpu`` GPT)."""
    return GPTModel.from_numpy(np_state, config, device)


def load_numpy_state(model: nn.Module, np_state) -> nn.Module:
    """Copy a numpy state dict keyed by the model's parameter names into
    ``model`` (fp32, shapes checked, every name present); returns it."""
    names = {n for n, _ in model.named_parameters()}
    if names != set(np_state):
        raise ValueError(f"state dict names differ: missing "
                         f"{sorted(names - set(np_state))}, unexpected "
                         f"{sorted(set(np_state) - names)}")
    with torch.no_grad():
        for n, p in model.named_parameters():
            arr = np.array(np_state[n], dtype=np.float32)   # a copy
            if arr.shape != tuple(p.shape):
                raise ValueError(f"{n}: shape {arr.shape} != "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(arr))
    return model
