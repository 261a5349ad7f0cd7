"""ERNIE-style MoE transformer (counterpart of
``paddle_tpu/models/ernie_moe.py``): a decoder-only transformer whose every
block's FFN is a top-k routed mixture of experts (``ops/moe.py``).

The parameters keep the reference's names and stacked layout, the
experts' with a leading (L, E) — ``blocks_expert_w1`` (L, E, H, I) — so a
numpy state dict moves between the two packages with no mapping
(``params_from_numpy``).  Training routes with the configured capacity
through the index dispatch and adds ``aux_loss_weight`` times the
load-balance loss summed over layers.  Generation and serving route with
no drop: ``prefill`` and the decode paths (``decode_step``,
``decode_ragged``) through ``moe_ffn_gather``.  The reference's prefill
takes the index dispatch at the capacity factor E/k; with no drop the two
compute the same numbers, and at C >= T the index form runs the same E·T
expert rows as the gather's every-expert form.  The attention half,
the KV-cache loops and the weight casts are ``gpt.StackedDecoder``'s, so
the model serves through the four engines and ``generate()`` by the same
contract as ``GPTModel``.

Training runs over a hybrid group of ``data`` (the expert axis,
``config.expert_axis``'s default) and ``model`` ranks, alone or together
(:func:`make_ernie_moe_train_step`).  A rank holds the reference's
``addressable_shards[r]`` of every parameter (``DIMS_MAPPING``): the
attention half splits over the model ranks as GPT's does
(``gpt.MeshContext``: the head-aligned QKV gather, ``proj``
row-parallel), ``wte`` over the vocabulary (the tied head's loss is
``ops/loss.py``'s vocabulary-parallel mean), and the experts over the
data ranks (``{1: "data"}``: rank j holds experts [j·E/R, (j+1)·E/R) of
every layer).  The MoE half is replicated over the model ranks: every
model rank routes the same tokens and holds the same experts.  Routing is
one routing of the global batch and the experts run on every rank's
slots (``ops/moe.py``); the expert weights' gradients reach the step
already summed over the ranks' tokens (``distributed/spmd.py``).
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..ops.attention import flash_attention
from ..ops.loss import softmax_cross_entropy_mean
from ..ops.moe import moe_ffn, moe_ffn_gather, moe_ffn_indices
from ..ops.loss import vocab_parallel_cross_entropy_mean
from .gpt import (_COMPUTE_DTYPES, StackedDecoder, _check_degrees,
                  _mesh_context, _mesh_degrees, _rank_batch_info,
                  _refuse_composed, mark_dims_mapping)


class ErnieMoeConfig:
    """The reference's config.  ``expert_axis`` names the mesh axis of the
    experts ("data"; an axis the batch is not split over raises, ROADMAP
    A7b); ``scan_unroll`` has no effect on the port's loop over layers."""

    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_attention_heads=12, num_experts=8, top_k=2,
                 expert_hidden_size=None, capacity_factor=1.25,
                 max_position_embeddings=1024, initializer_range=0.02,
                 layer_norm_epsilon=1e-5, compute_dtype="bfloat16",
                 aux_loss_weight=0.01, expert_axis="data", scan_unroll=1,
                 index_dispatch=True):
        if compute_dtype not in _COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of "
                             f"{_COMPUTE_DTYPES}, got {compute_dtype!r}")
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_attention_heads = num_attention_heads
        self.num_experts = num_experts
        self.top_k = top_k
        self.expert_hidden_size = expert_hidden_size or 4 * hidden_size
        self.capacity_factor = capacity_factor
        self.max_position_embeddings = max_position_embeddings
        self.initializer_range = initializer_range
        self.layer_norm_epsilon = layer_norm_epsilon
        self.compute_dtype = compute_dtype
        self.aux_loss_weight = aux_loss_weight
        self.expert_axis = expert_axis
        self.scan_unroll = scan_unroll
        self.index_dispatch = index_dispatch


class ErnieMoeModel(StackedDecoder):
    """Causal LM with a routed MoE FFN in every block.

    ``device`` defaults to ``cuda``; ``generator`` (a ``torch.Generator``
    on that device, default seeded 0) draws the N(0, initializer_range)
    weights, with proj and expert_w2 at ``initializer_range / sqrt(2L)``."""

    config_class = ErnieMoeConfig

    def __init__(self, config: ErnieMoeConfig, *, device=None,
                 generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.config = c = config
        L, H, V, E = c.num_layers, c.hidden_size, c.vocab_size, c.num_experts
        I = c.expert_hidden_size
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
        self.blocks_gate_w = normal([L, H, E])
        self.blocks_expert_w1 = normal([L, E, H, I])
        self.blocks_expert_b1 = zeros([L, E, I])
        self.blocks_expert_w2 = normal([L, E, I, H], std / math.sqrt(2 * L))
        self.blocks_expert_b2 = zeros([L, E, H])
        self.lnf_w = ones([H])
        self.lnf_b = zeros([H])
        self._casts = {}
        mark_dims_mapping(self, dims_mapping(c))

    @staticmethod
    def stacked_param_names():
        return [f"blocks_{n}" for n in
                ("ln1_w", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b",
                 "ln2_w", "ln2_b", "gate_w", "expert_w1", "expert_b1",
                 "expert_w2", "expert_b2")]

    def _experts(self, l):
        """Layer ``l``'s gate (fp32, the router runs in fp32) and expert
        weights in the compute dtype."""
        return (self.blocks_gate_w[l],
                *(self._cw(f"blocks_expert_{n}", l)
                  for n in ("w1", "b1", "w2", "b2")))

    def _moe_residual(self, l, h, mesh=None):
        """Training's ln2 + routed FFN at the configured capacity +
        residual; returns (h, aux)."""
        c = self.config
        B, Lq, H = h.shape
        m_in = self._block_ln(h, self.blocks_ln2_w[l], self.blocks_ln2_b[l],
                              h.dtype)
        ffn = moe_ffn_indices if c.index_dispatch else moe_ffn
        out, aux = ffn(m_in.reshape(B * Lq, H), *self._experts(l), k=c.top_k,
                       capacity_factor=c.capacity_factor, mesh=mesh,
                       expert_axis=c.expert_axis)
        return h + out.reshape(B, Lq, H), aux

    def _block_post_attn(self, l, h, att):
        """The serving paths' second half (prefill and decode):
        projection + residual, then ln2, the capacity-free gather FFN and
        its residual."""
        h = self._attn_residual(l, h, att)
        B, Lq, H = h.shape
        m_in = self._block_ln(h, self.blocks_ln2_w[l], self.blocks_ln2_b[l],
                              h.dtype)
        out = moe_ffn_gather(m_in.reshape(B * Lq, H), *self._experts(l),
                             k=self.config.top_k)
        return h + out.reshape(B, Lq, H)

    # --------------------------------------------------------- training --
    # As GPTModel's, these read the module's own parameters (or the
    # state's, swapped in by a train step that does not donate, or this
    # rank's blocks over a mesh).

    def block_fn(self, l, h, mesh=None, par=None):
        """Layer ``l``: pre-LN causal flash attention (this rank's nh/mp
        heads under a model-parallel ``par``), then the routed FFN (over
        ``mesh``'s batch and expert ranks); returns (h, aux_loss)."""
        q, k, v = self._block_qkv(l, h, par)
        att = (flash_attention(q, k, v, causal=True) if par is None
               else par.attention(q, k, v))
        h = self._attn_residual(l, h, att, par)
        return self._moe_residual(l, h, mesh=mesh)

    def scan_blocks(self, h, mesh=None, remat=True, par=None):
        """All layers in order; returns (h, aux summed over layers in
        fp32).  ``remat`` recomputes each block in the backward
        (``torch.utils.checkpoint``); routing has no jitter here, so the
        recompute routes the same, and over a mesh it repeats the block's
        collectives in the same order on every rank."""
        if remat not in (False, True):
            raise ValueError(f"remat must be False or True, got {remat!r}")
        aux_sum = torch.zeros((), dtype=torch.float32, device=h.device)
        for l in range(self.config.num_layers):
            if remat:
                h, aux = checkpoint(self.block_fn, l, h, mesh, par,
                                    use_reentrant=False)
            else:
                h, aux = self.block_fn(l, h, mesh, par)
            aux_sum = aux_sum + aux
        return h, aux_sum

    def _head_logits(self, h, dtype=None, par=None):
        """Final LN in fp32, then the tied head in ``dtype`` (default the
        compute dtype): this rank's vocabulary columns when ``par`` splits
        the head."""
        c = self.config
        x32 = h.float()
        m = x32.mean(-1, keepdim=True)
        v = (x32 - m).square().mean(-1, keepdim=True)
        hn = (x32 - m) * torch.rsqrt(v + c.layer_norm_epsilon) * self.lnf_w \
            + self.lnf_b
        dt = self.compute_dtype if dtype is None else dtype
        w = self._cw("wte") if dt == self.compute_dtype else self.wte.to(dt)
        hn = hn.to(dt)
        if par is not None and par.head_split:
            hn = par.copy(hn)
        return hn @ w.T

    def head_loss_fn(self, h, labels, aux_sum=0.0, par=None):
        """Fused CE on compute-dtype logits (over vocabulary-split logits
        when ``par`` splits the head) + ``aux_loss_weight · aux``."""
        logits = self._head_logits(h, par=par)
        if par is not None and par.head_split:
            nll = vocab_parallel_cross_entropy_mean(logits, labels, par.mp)
        else:
            nll = softmax_cross_entropy_mean(logits, labels)
        return nll + self.config.aux_loss_weight * aux_sum

    def forward(self, input_ids, labels=None):
        """fp32 logits (B, L, V), or the loss with ``labels``; no
        recompute."""
        h, aux = self.scan_blocks(self.embed_fn(input_ids), remat=False)
        if labels is None:
            return self._head_logits(h, dtype=torch.float32)
        return self.head_loss_fn(h, labels, aux)

    def decode_logits(self, h):
        """fp32 logits for the decode paths (the head in fp32, as the
        reference's)."""
        return self._head_logits(h, dtype=torch.float32)


def dims_mapping(config: ErnieMoeConfig):
    """The reference's layout of ERNIE-MoE's parameters
    (``paddle_tpu/models/ernie_moe.py:78-100``): vocabulary-parallel
    ``wte``, column-parallel ``qkv``, row-parallel ``proj``, and the
    experts over ``config.expert_axis``."""
    experts = {1: config.expert_axis}
    return {"wte": {0: "model"}, "blocks_qkv_w": {2: "model"},
            "blocks_qkv_b": {1: "model"}, "blocks_proj_w": {1: "model"},
            "blocks_expert_w1": experts, "blocks_expert_b1": experts,
            "blocks_expert_w2": experts, "blocks_expert_b2": experts}


def _check_ernie_mesh(cfg, hcg, zero_stage=0):
    """What waits for ROADMAP A7b on ERNIE-MoE's steps: sep degrees, an
    expert axis the batch is not split over, a sharding degree beside a
    split expert axis, ZeRO with a split expert axis (A7b item 3) or with
    model ranks.  Returns the hybrid group's mesh."""
    degrees = _mesh_degrees(hcg)
    axis_degree = {"data": degrees.get("dp", 1),
                   "model": degrees.get("mp", 1),
                   "sharding": degrees.get("sharding", 1),
                   "sep": degrees.get("sep", 1)}
    split = axis_degree.get(cfg.expert_axis, 1) > 1
    if split and cfg.expert_axis != "data":
        raise NotImplementedError(
            f"an expert axis the batch is not split over "
            f"({cfg.expert_axis!r}) waits for ROADMAP A7b")
    if split and axis_degree["sharding"] > 1:
        raise NotImplementedError(
            "a sharding degree beside a split expert axis waits for ROADMAP "
            "A7b")
    if zero_stage > 0:
        if split:
            raise NotImplementedError(
                f"zero_stage {zero_stage} with an expert axis waits for "
                f"ROADMAP A7b item 3 (ZeRO composed with expert "
                f"parallelism)")
        _refuse_composed(hcg, f"zero_stage {zero_stage}")
    return _check_degrees(hcg, runs=("mp",))


def _ernie_loss(model, mesh, par, remat):
    moe_mesh = None if mesh is None or mesh.size <= 1 else mesh

    def loss_of(params, input_ids, labels):
        # ``params`` are the tensors ``model`` holds for this call (its own
        # parameters, the state's swapped in, or this rank's blocks)
        p = None if par is None else par.bind(model)
        h, aux = model.scan_blocks(model.embed_fn(input_ids, par=p),
                                   mesh=moe_mesh, remat=remat, par=p)
        return model.head_loss_fn(h, labels, aux, par=p)
    return loss_of


def make_ernie_moe_train_step(model: ErnieMoeModel, optimizer, hcg=None,
                              remat: bool = True, donate: bool = True,
                              monitor=None):
    """The ERNIE-MoE train step: ``step(state, lr, input_ids, labels) ->
    (state, loss)`` with ``state = {"params", "opt", "buffers"}``; with
    ``donate`` the model's own parameters (this rank's blocks over a
    mesh), updated in place, else a fresh state each step
    (``distributed.spmd``).  ``hcg`` None (one device) or a hybrid group
    over data (the expert axis) and model degrees: each rank is given the
    global batch and takes its rows, holds its shards (module docstring),
    and the loss is the global mean.  ``monitor`` (a ``telemetry.
    TrainMonitor``) wraps the step as ``make_gpt_train_step``'s does,
    counting each token once.  A sep degree raises, and so do the
    layouts ``_check_ernie_mesh`` names (ROADMAP A7b); a pipe degree is
    held replicated, as the reference's step holds it."""
    from ..distributed.spmd import make_gspmd_step_from_loss
    from ..telemetry import instrument_train_step

    mesh = _check_ernie_mesh(model.config, hcg)
    # a model built on the meta device and moved (``from_numpy``) lost
    # the marks its constructor set
    mark_dims_mapping(model, dims_mapping(model.config))
    params0 = dict(model.named_parameters())
    par, _ = _mesh_context(model, mesh, params0, dims_mapping(model.config),
                           mlp=None)
    step, state0 = make_gspmd_step_from_loss(
        _ernie_loss(model, mesh, par, remat), params0, optimizer, mesh,
        layer=model, donate=donate)
    return instrument_train_step(step, monitor, "ernie_moe",
                                 batch_info=_rank_batch_info(mesh)), state0


def make_sharded_ernie_moe_train_step(cfg: ErnieMoeConfig, optimizer, hcg,
                                      zero_stage: int = 0, seed: int = 0,
                                      remat: bool = True, donate: bool = True,
                                      device=None, monitor=None):
    """The ERNIE-MoE step with the model built here from ``seed`` on
    ``device`` (default cuda) and each rank keeping its shards of the
    state (``zero_stage`` as sharding specs), over the degrees
    :func:`make_ernie_moe_train_step` takes.  The reference initialises
    each device's shard directly; here each rank builds the whole model
    once (the same seed on every rank) and keeps its blocks
    (``ROADMAP.md`` §C).  A ``zero_stage`` above 0 with a split expert
    axis or model ranks raises (ROADMAP A7b).  Returns ``(step,
    state0)``."""
    from .. import resolve_device
    from ..distributed.spmd import make_gspmd_sharded_init_step
    from ..telemetry import instrument_train_step

    mesh = _check_ernie_mesh(cfg, hcg, zero_stage)
    dev = resolve_device(device)
    model = ErnieMoeModel(cfg, device=dev,
                          generator=torch.Generator(dev).manual_seed(seed))

    def build(seed):
        return dict(model.named_parameters())

    par, _ = _mesh_context(model, mesh, build(seed), dims_mapping(cfg),
                           mlp=None)
    step, state0 = make_gspmd_sharded_init_step(
        _ernie_loss(model, mesh, par, remat), build, optimizer, mesh, model,
        zero_stage=zero_stage, donate=donate, seed=seed)
    return instrument_train_step(step, monitor, "ernie_moe_sharded",
                                 batch_info=_rank_batch_info(mesh)), state0


def params_from_numpy(np_state, config: ErnieMoeConfig,
                      device=None) -> ErnieMoeModel:
    """Build the port's ERNIE-MoE from a numpy state dict keyed by the
    reference's parameter names (``{n: np.asarray(p._data) for n, p in
    model.named_parameters()}`` of a ``paddle_tpu`` ERNIE-MoE)."""
    return ErnieMoeModel.from_numpy(np_state, config, device)
