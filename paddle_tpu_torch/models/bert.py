"""BERT model family (counterpart of ``paddle_tpu/models/bert.py``): the
post-LN encoder over stacked block parameters, the MLM and NSP heads, and
the one-device pretraining step ``make_bert_train_step``.

The parameters keep the reference's names and stacked ``[L, …]`` layout
(``word_emb`` … ``nsp_b``, ``stacked_param_names``), so a numpy state dict
moves between the two packages with no mapping (``params_from_numpy``).
Parameters are fp32; matmuls run in ``config.compute_dtype`` with LayerNorm
statistics in fp32, as in the reference.  Each block's two residual +
LayerNorm epilogues go through ``ops.fused.fused_ln_residual_dropout``
when ``FLAGS_use_fused_ln`` is on (the fused kernels), else through the
plain ``_ln`` — the flag keeps the reference's default, off.

Over ``model`` ranks (``make_bert_train_step`` with an ``mp`` degree) a
rank holds the reference's ``addressable_shards[r]`` of every parameter
(``DIMS_MAPPING``) and computes Megatron's way, through
``gpt.MeshContext``: the vocabulary-split ``word_emb`` lookup (``pos_emb``
and ``type_emb`` stay whole), QKV through the head-aligned gather of the
column-split ``blocks_qkv_w``, attention at nh/mp heads with the padding
key mask unchanged, ``fc1`` column-parallel, and ``proj`` and ``fc2``
row-parallel, their partial products all-reduced *before* the epilogue
adds the bias (once) and the residual and applies the LN, fused or
plain.  The MLM head gives each rank its vocabulary columns of the logits
(``word_emb`` and ``mlm_bias`` split alike) and the loss is the weighted
mean over the vocabulary shards (``ops/loss.py``); the pooler, NSP and
``mlm_dense`` stay whole.  A vocabulary the degree does not divide leaves
``word_emb`` and ``mlm_bias`` whole, as the reference's rule does, and
the head computes whole logits on every rank.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..core.flags import flag
from ..ops.attention import dense_attention, flash_attention
from ..ops.fused import fused_ln_residual_dropout
from ..ops.loss import (softmax_cross_entropy_weighted_mean,
                        vocab_parallel_cross_entropy_weighted_mean)
from .gpt import (_COMPUTE_DTYPES, _check_degrees, _mesh_context,
                  _rank_batch_info, _refuse_composed, load_numpy_state,
                  mark_dims_mapping)


class BertConfig:
    """The reference's BERT config.  ``hidden_dropout_prob`` and
    ``attention_probs_dropout_prob`` are kept and not read (the reference's
    encoder applies no dropout); ``scan_unroll`` has no effect on the
    port's Python loop over layers."""

    def __init__(self, vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=None,
                 max_position_embeddings=512, type_vocab_size=2,
                 hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                 initializer_range=0.02, layer_norm_eps=1e-12,
                 compute_dtype="bfloat16", use_flash_attention=True,
                 scan_unroll=1, hidden_act="gelu"):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.initializer_range = initializer_range
        self.layer_norm_eps = layer_norm_eps
        if compute_dtype not in _COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of "
                             f"{_COMPUTE_DTYPES}, got {compute_dtype!r}")
        self.compute_dtype = compute_dtype
        self.use_flash_attention = use_flash_attention
        # "gelu" = the exact erf form (BERT's default); "gelu_approx" = tanh
        if hidden_act not in ("gelu", "gelu_approx"):
            raise ValueError(f"hidden_act must be 'gelu' or 'gelu_approx', "
                             f"got {hidden_act!r}")
        self.hidden_act = hidden_act
        self.scan_unroll = scan_unroll


BERT_CONFIGS = {
    "bert-base": dict(hidden_size=768, num_hidden_layers=12,
                      num_attention_heads=12),
    "bert-large": dict(hidden_size=1024, num_hidden_layers=24,
                       num_attention_heads=16),
}


def bert_preset(name: str, **overrides) -> BertConfig:
    cfg = dict(BERT_CONFIGS[name])
    cfg.update(overrides)
    return BertConfig(**cfg)


class BertModel(nn.Module):
    """Bidirectional encoder with stacked block parameters.

    ``device`` defaults to ``cuda``; ``generator`` (a ``torch.Generator``
    on that device, default seeded 0) draws the N(0, initializer_range)
    weights, with proj/fc2 at ``initializer_range / sqrt(2L)``.  The
    reference's pure functions take a params pytree; these read the
    module's own parameters, which the train step updates in place."""

    def __init__(self, config: BertConfig, *, device=None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.config = c = config
        L, H, V = c.num_hidden_layers, c.hidden_size, c.vocab_size
        I = c.intermediate_size
        std = c.initializer_range
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

        self.word_emb = normal([V, H])
        self.pos_emb = normal([c.max_position_embeddings, H])
        self.type_emb = normal([c.type_vocab_size, H])
        self.emb_ln_w = ones([H])
        self.emb_ln_b = zeros([H])
        # stacked encoder blocks, post-LN (the original BERT residual order)
        self.blocks_qkv_w = normal([L, H, 3 * H])
        self.blocks_qkv_b = zeros([L, 3 * H])
        self.blocks_proj_w = normal([L, H, H], std / math.sqrt(2 * L))
        self.blocks_proj_b = zeros([L, H])
        self.blocks_ln1_w = ones([L, H])
        self.blocks_ln1_b = zeros([L, H])
        self.blocks_fc1_w = normal([L, H, I])
        self.blocks_fc1_b = zeros([L, I])
        self.blocks_fc2_w = normal([L, I, H], std / math.sqrt(2 * L))
        self.blocks_fc2_b = zeros([L, H])
        self.blocks_ln2_w = ones([L, H])
        self.blocks_ln2_b = zeros([L, H])
        # pooler + heads
        self.pooler_w = normal([H, H])
        self.pooler_b = zeros([H])
        self.mlm_dense_w = normal([H, H])
        self.mlm_dense_b = zeros([H])
        self.mlm_ln_w = ones([H])
        self.mlm_ln_b = zeros([H])
        self.mlm_bias = zeros([V])
        self.nsp_w = normal([H, 2])
        self.nsp_b = zeros([2])
        mark_dims_mapping(self, DIMS_MAPPING)

    @staticmethod
    def stacked_param_names():
        return [f"blocks_{n}" for n in ("qkv_w", "qkv_b", "proj_w", "proj_b",
                                        "ln1_w", "ln1_b", "fc1_w", "fc1_b",
                                        "fc2_w", "fc2_b", "ln2_w", "ln2_b")]

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.config.compute_dtype)

    def _cw(self, name, l=None):
        """Parameter ``name`` (layer ``l``'s slice of a stacked one) cast to
        the compute dtype on every use, so the gradient reaches the fp32
        parameter, as the reference's ``.astype(dt)``."""
        p = getattr(self, name)
        return (p if l is None else p[l]).to(self.compute_dtype)

    def _gelu(self, x):
        approx = "tanh" if self.config.hidden_act == "gelu_approx" else "none"
        return F.gelu(x, approximate=approx)

    # ------------------------------------------------------------ blocks --

    def _ln(self, x, w, b):
        """LayerNorm in fp32 with the population variance (``jnp.var``);
        returns fp32."""
        x32 = x.float()
        m = x32.mean(-1, keepdim=True)
        v = (x32 - m).square().mean(-1, keepdim=True)
        return (x32 - m) * torch.rsqrt(v + self.config.layer_norm_eps) * w + b

    def embed_fn(self, input_ids, token_type_ids=None, par=None):
        """Word, position and type embeddings, LN'd, in the compute dtype
        (a ``word_emb`` split over ``par``'s model ranks is looked up
        masked and all-reduced)."""
        pos = torch.arange(input_ids.shape[-1], device=input_ids.device)
        words = (F.embedding(input_ids.long(), self.word_emb) if par is None
                 else par.vocab_lookup(input_ids, self.word_emb))
        h = words + self.pos_emb[pos]
        if token_type_ids is None:
            h = h + self.type_emb[0]
        else:
            h = h + F.embedding(token_type_ids.long(), self.type_emb)
        return self._ln(h, self.emb_ln_w, self.emb_ln_b).to(self.compute_dtype)

    def epilogue(self, x, residual, ln_w, ln_b, bias):
        """LN(residual + x + bias) in the compute dtype: the fused kernels
        when ``FLAGS_use_fused_ln`` is on (residual_out is discarded), else
        the plain ``_ln``."""
        dt = x.dtype
        if flag("FLAGS_use_fused_ln"):
            return fused_ln_residual_dropout(
                x, residual, ln_w, ln_b, bias=bias,
                eps=self.config.layer_norm_eps)[0].to(dt)
        return self._ln(residual + x + bias.to(dt), ln_w, ln_b).to(dt)

    def block_fn(self, l, h, attn_mask=None, par=None):
        """Layer ``l``: non-causal attention (flash, with the padding mask
        as its key mask), then the MLP, each closed by ``epilogue``; under
        a model-parallel ``par`` this rank's heads and MLP columns, the
        row-parallel products all-reduced before the epilogue."""
        c = self.config
        B, Lq, H = h.shape
        hd = H // c.num_attention_heads
        heads = par is not None and par.heads_split
        mlp = par is not None and par.mlp_split
        if heads:
            qkv = par.copy(h) @ par.qkv_w[l] + par.qkv_b[l]
        else:
            qkv = h @ self._cw("blocks_qkv_w", l) \
                + self._cw("blocks_qkv_b", l)
        nh = qkv.shape[-1] // (3 * hd)
        q, k, v = (t.reshape(B, Lq, nh, hd)
                   for t in qkv.split(nh * hd, -1))
        if c.use_flash_attention:
            att = flash_attention(q, k, v, causal=False, key_mask=attn_mask)
        else:
            att = dense_attention(q, k, v, mask=attn_mask, causal=False)
        out = att.reshape(B, Lq, nh * hd) @ self._cw("blocks_proj_w", l)
        h = self.epilogue(par.reduce(out) if heads else out, h,
                          self.blocks_ln1_w[l], self.blocks_ln1_b[l],
                          self.blocks_proj_b[l])
        ff = self._gelu((par.copy(h) if mlp else h)
                        @ self._cw("blocks_fc1_w", l)
                        + self._cw("blocks_fc1_b", l))
        out = ff @ self._cw("blocks_fc2_w", l)
        return self.epilogue(par.reduce(out) if mlp else out, h,
                             self.blocks_ln2_w[l], self.blocks_ln2_b[l],
                             self.blocks_fc2_b[l])

    def scan_blocks(self, h, attn_mask=None, remat=True, par=None):
        """All layers in order; ``remat`` True recomputes each block in the
        backward (``torch.utils.checkpoint``), as ``jax.checkpoint``."""
        if remat not in (False, True):
            raise ValueError(f"remat must be False or True, got {remat!r}")
        for l in range(self.config.num_hidden_layers):
            if remat:
                h = checkpoint(self.block_fn, l, h, attn_mask, par,
                               use_reentrant=False)
            else:
                h = self.block_fn(l, h, attn_mask, par)
        return h

    def encode(self, input_ids, token_type_ids=None, attn_mask=None,
               remat=False, par=None):
        h = self.embed_fn(input_ids, token_type_ids, par)
        return self.scan_blocks(h, attn_mask, remat=remat, par=par)

    # ------------------------------------------------------------- heads --

    def pool_fn(self, h):
        return torch.tanh(h[:, 0] @ self._cw("pooler_w")
                          + self._cw("pooler_b"))

    def _mlm_logits(self, h, par=None):
        """MLM logits in the compute dtype (the fused CE reduces in fp32):
        this rank's vocabulary columns when ``par`` splits the head."""
        x = self._gelu(h @ self._cw("mlm_dense_w") + self._cw("mlm_dense_b"))
        x = self._ln(x, self.mlm_ln_w, self.mlm_ln_b).to(self.compute_dtype)
        if par is not None and par.head_split:
            x = par.copy(x)
        return x @ self._cw("word_emb").T + self._cw("mlm_bias")

    def mlm_logits(self, h):
        """fp32 MLM logits for external use (eval, inspection)."""
        return self._mlm_logits(h).float()

    @staticmethod
    def _additive_mask(attention_mask):
        """(B, L) 1 = keep / 0 = pad → additive (B, 1, 1, L) mask, or None."""
        if attention_mask is None:
            return None
        return (1.0 - attention_mask.float())[:, None, None, :] * -1e30

    def pretrain_loss_fn(self, input_ids, mlm_labels, nsp_labels=None,
                         token_type_ids=None, attention_mask=None,
                         remat=False, mlm_scale=None, par=None):
        """MLM (ignore label -100, any negative label) + optional NSP.
        ``mlm_scale`` multiplies the MLM mean (the data-parallel step's
        share of the global valid-label count); ``par`` a model-parallel
        ``gpt.MeshContext`` (module docstring)."""
        h = self.encode(input_ids, token_type_ids,
                        attn_mask=self._additive_mask(attention_mask),
                        remat=remat, par=par)
        logits = self._mlm_logits(h, par)
        valid = mlm_labels >= 0
        safe = torch.where(valid, mlm_labels, torch.zeros_like(mlm_labels))
        if par is not None and par.head_split:
            mlm_loss = vocab_parallel_cross_entropy_weighted_mean(
                logits, safe, valid.float(), par.mp)
        else:
            mlm_loss = softmax_cross_entropy_weighted_mean(logits, safe,
                                                           valid.float())
        if mlm_scale is not None:
            mlm_loss = mlm_loss * mlm_scale
        if nsp_labels is None:
            return mlm_loss
        pooled = self.pool_fn(h).float()
        nsp_logp = torch.log_softmax(pooled @ self.nsp_w + self.nsp_b, -1)
        nsp_loss = -nsp_logp.gather(-1, nsp_labels.long()[:, None]).mean()
        return mlm_loss + nsp_loss

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        """(h, pooled) in the compute dtype, no recompute."""
        h = self.encode(input_ids, token_type_ids,
                        attn_mask=self._additive_mask(attention_mask))
        return h, self.pool_fn(h)


#: the reference's model-axis layout of BERT's parameters
#: (``paddle_tpu/models/bert.py:90-119``): vocabulary-parallel
#: ``word_emb`` and ``mlm_bias``, column-parallel ``qkv``/``fc1``,
#: row-parallel ``proj``/``fc2``
DIMS_MAPPING = {"word_emb": {0: "model"}, "blocks_qkv_w": {2: "model"},
                "blocks_qkv_b": {1: "model"}, "blocks_proj_w": {1: "model"},
                "blocks_fc1_w": {2: "model"}, "blocks_fc1_b": {1: "model"},
                "blocks_fc2_w": {1: "model"}, "mlm_bias": {0: "model"}}


def _bert_mesh_context(model, mesh, params0):
    par, _ = _mesh_context(model, mesh, params0, DIMS_MAPPING,
                           vocab="word_emb", head="word_emb",
                           bias="mlm_bias")
    return par


def _bert_loss(model, mesh, remat, par=None):
    """The MLM + NSP loss on this rank's rows (``attention_mask``, the
    (B, L) padding mask, is optional: the reference's step takes none).
    Over several ranks each rank's MLM mean is scaled by its share of the
    global valid-label count (one all-reduce of the counts over the batch
    ranks), so the mean over the ranks is the reference's weighted mean
    over the whole batch.  ``par``: the model-parallel context."""
    from ..distributed.collective import ReduceOp, all_reduce
    group = None if mesh is None or mesh.size <= 1 else \
        mesh.batch_group()[0]

    def loss_of(params, input_ids, mlm_labels, nsp_labels,
                attention_mask=None):
        scale = None
        if group is not None:
            n = (mlm_labels >= 0).sum().float()
            total = all_reduce(n.clone(), ReduceOp.SUM, group)
            scale = n * group.nranks / torch.clamp(total, min=1.0)
        return model.pretrain_loss_fn(
            input_ids, mlm_labels, nsp_labels,
            attention_mask=attention_mask, remat=remat, mlm_scale=scale,
            par=None if par is None else par.bind(model))

    return loss_of


def make_bert_train_step(model: BertModel, optimizer, hcg=None,
                         remat: bool = True, donate: bool = True,
                         zero_stage: int = 0, grad_comm=None, monitor=None):
    """The MLM + NSP pretraining step: ``step(state, lr, input_ids,
    mlm_labels, nsp_labels[, attention_mask]) -> (state, loss)``, with
    ``state = {"params", "opt", "buffers"}`` and ``state["params"]`` the
    model's own parameters (this rank's blocks over model ranks), updated
    in place with the optimizer slots (``distributed.spmd``);
    ``donate=False`` leaves the given state and the model untouched and
    returns a fresh state.  ``hcg`` None or a hybrid group over data,
    sharding and model degrees (each rank is given the global batch and
    takes its rows; the loss is the global weighted mean; module
    docstring for the model axis).  ``zero_stage`` > 0 routes through
    ``distributed.zero`` (the reference's BERT step takes no such
    argument: its ZeRO is the sharded-init specs,
    ``make_sharded_bert_train_step``), and raises with a model degree
    (ROADMAP A7b).  A sep degree raises (ROADMAP A7b); a pipe degree is
    held replicated, as the reference's step holds it."""
    from ..distributed.grad_comm import comm_info, resolve_policy
    from ..distributed.spmd import make_gspmd_step_from_loss
    from ..telemetry import instrument_train_step

    if zero_stage > 0:
        _refuse_composed(hcg, f"zero_stage {zero_stage}")
    mesh = _check_degrees(hcg, runs=("mp",))
    policy = resolve_policy(grad_comm)
    params0 = dict(model.named_parameters())
    loss_of = _bert_loss(model, mesh, remat,
                         _bert_mesh_context(model, mesh, params0))
    if zero_stage > 0:
        from ..distributed.zero import make_zero_train_step
        step, state0 = make_zero_train_step(
            loss_of, params0, optimizer, mesh, layer=model,
            zero_stage=zero_stage, donate=donate, grad_comm=policy)
    else:
        step, state0 = make_gspmd_step_from_loss(
            loss_of, params0, optimizer, mesh, layer=model, donate=donate,
            grad_comm=policy)
    return instrument_train_step(step, monitor, "bert",
                                 batch_info=_rank_batch_info(mesh),
                                 comm=comm_info(params0, policy)), state0


def make_sharded_bert_train_step(cfg: BertConfig, optimizer, hcg,
                                 zero_stage: int = 0, seed: int = 0,
                                 remat: bool = True, donate: bool = True,
                                 device=None, monitor=None):
    """BERT pretraining with the model built here from ``seed`` on
    ``device`` (default cuda) and each rank keeping its shards (see
    ``models.gpt.make_sharded_gpt_train_step``: ``zero_stage`` as sharding
    specs, raising with a model degree), over data, sharding and model
    degrees.  Returns ``(step, state0)`` with ``step(state, lr,
    input_ids, mlm_labels, nsp_labels[, attention_mask])``."""
    from ..distributed.spmd import make_gspmd_sharded_init_step
    from ..telemetry import instrument_train_step

    if zero_stage > 0:
        _refuse_composed(hcg, f"zero_stage {zero_stage}")
    mesh = _check_degrees(hcg, runs=("mp",))
    dev = resolve_device(device)
    model = BertModel(cfg, device=dev,
                      generator=torch.Generator(dev).manual_seed(seed))

    def build(seed):
        return dict(model.named_parameters())

    step, state0 = make_gspmd_sharded_init_step(
        _bert_loss(model, mesh, remat,
                   _bert_mesh_context(model, mesh, build(seed))),
        build, optimizer, mesh, model, zero_stage=zero_stage, donate=donate,
        seed=seed)
    return instrument_train_step(step, monitor, "bert_sharded",
                                 batch_info=_rank_batch_info(mesh)), state0


def params_from_numpy(np_state, config: BertConfig, device=None) -> BertModel:
    """Build the port's BERT from a numpy state dict keyed by the
    reference's parameter names (``{n: np.asarray(p._data) for n, p in
    model.named_parameters()}`` of a ``paddle_tpu`` BERT)."""
    dev = resolve_device(device)
    return load_numpy_state(BertModel(config, device="meta").to_empty(
        device=dev), np_state)
