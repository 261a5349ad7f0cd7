"""Pipeline-parallel train steps (counterpart of
``paddle_tpu/distributed/pipeline_engine.py``; reference: the 1F1B
machinery of ``pipeline_parallel.py`` ``forward_backward_pipeline`` and
``p2p_communication.py``).

Each pipe rank is a process holding its stage (``topology``: rank r at flat
mesh position r) and running ``spmd.run_pipeline``'s 1F1B schedule
(interleaved when ``virtual_pp_degree`` V > 1): the first global stage
embeds, the last computes the loss, activations and their gradients move
by point-to-point exchanges over the pipe group.

1. **Stacked stages** (:func:`make_stacked_pipeline_step`, GPT's): the
   stacked block parameters split on dim 0 over "pipe"
   (``sharding_rules.override_leading_axis``); with V > 1 they are stored
   chunk-interleaved from init (:func:`interleave_layers`), so rank d's
   contiguous shard is its V chunks and the step re-lays nothing out.  The
   parameters the stacked split leaves whole (``wte``, ``wpe``, the final
   LayerNorm, an untied head) are held by every pipe rank; their gradients
   (zeros on a rank that does not read them) are summed over the pipe
   group, so the tied ``wte`` gets its embedding and head gradients and
   every pipe rank applies the same update to the same values.
2. **PipelineLayer** (:func:`make_pipeline_train_step`): a pipe rank holds
   only its stage's layers (``parallel_layers.pp_layers``); a
   ``SharedLayerDesc`` weight's gradient is summed over the ranks that use
   it.  The reference runs these stages serially under GSPMD.

In both, each micro-batch's loss is weighted by 1/M (its share of the
tokens: M equal micro-batches), the returned loss is the global mean on
every rank, the gradients are then averaged over the data × sharding × sep
ranks, and each rank updates its own parameters and slots.  Over more
than one rank a random draw and a batch norm in training mode raise
(``spmd._MESH_DRAWS``, ``_PIPE_BATCH_STATS``: ROADMAP A7b item 8).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .sharding_rules import (_entry_axes, build_param_specs, local_shard,
                             override_leading_axis, replicated_spec,
                             spec_shards)
from .spmd import (_MESH_DRAWS, _Thunk, _clone_tree, _global_loss,
                   _mean_all, _rows, _slot_specs, run_pipeline)
from .topology import GRAD_AXES


def _layer_perm(L: int, n_stages: int, n_chunks: int):
    S, V = n_stages, n_chunks
    lpc = L // (S * V)
    return np.array([(v * S + d) * lpc + i
                     for d in range(S) for v in range(V) for i in range(lpc)])


def _take(x, perm):
    if isinstance(x, torch.Tensor):
        return x[torch.as_tensor(perm, device=x.device)]
    return x[perm]


def interleave_layers(x, n_stages: int, n_chunks: int):
    """A [L, ...] layer stack (tensor or array) in chunk-interleaved
    storage order: position d*(V*lpc) + v*lpc + i holds layer
    (v*S + d)*lpc + i, so a "pipe"-split dim 0 gives rank d exactly its V
    schedule chunks.  Inverse: :func:`deinterleave_layers`."""
    return _take(x, _layer_perm(x.shape[0], n_stages, n_chunks))


def deinterleave_layers(x, n_stages: int, n_chunks: int):
    """Inverse of :func:`interleave_layers` (a state trained with
    ``virtual_pp_degree`` > 1 back to the plain layer order)."""
    perm = _layer_perm(x.shape[0], n_stages, n_chunks)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(x.shape[0])
    return _take(x, inv)


def _run_blocks(block_fn, n: int, h, key, ctx, remat):
    """Layers 0..n-1 of the held stack; ``remat`` as GPT's
    ``scan_blocks``: True recomputes each block, "dots" saves its matmul
    outputs."""
    kw = {}
    if remat == "dots":
        from ..models.gpt import _save_dots_context
        kw["context_fn"] = _save_dots_context
    for l in range(n):
        if remat:
            h = checkpoint(block_fn, l, h, key, ctx, use_reentrant=False,
                           **kw)
        else:
            h = block_fn(l, h, key, ctx)
    return h


def _pipe_step(optimizer, mesh, layer, state0, n_chunks, leaves_of, fwd,
               head, n_microbatches, donate, reduce_grads, clip_grads,
               layout=None):
    """The step both builders share: ``step(state, key, lr, x, labels) ->
    (state, loss)``.

    - ``leaves_of(params) -> (leaves, uses, maps, assemble)``: the tensors
      this step differentiates, the indices chunk v reads, chunk v's
      ``{name: tensor}`` swapped into ``layer``, and the map from the
      leaves' gradients to ``{name: gradient}``;
    - ``fwd(v, x, m, key)``, ``head(y, labels) -> loss`` (inside the
      swap);
    - ``reduce_grads(grads)``: the sums over pipe ranks, in place;
    - ``clip_grads(clip, grads)``: the optimizer's clip over this rank's
      gradients with whole-model semantics."""
    from .collective import broadcast
    pipe = mesh.axis_group("pipe")
    S, V, M = pipe.nranks, n_chunks, n_microbatches
    rows, bidx = mesh.batch_group()
    ggroup, _ = mesh.batch_group(GRAD_AXES)
    R, G = rows.nranks, ggroup.nranks
    holder = _Thunk(layer)
    last = pipe.ranks[S - 1]

    def step(state, key, lr, x, labels):
        if not donate:
            state = _clone_tree(state)
        x, labels = _rows((x, labels), R, bidx)
        if x.shape[0] % M:
            raise ValueError(f"a rank's {x.shape[0]} rows do not split into "
                             f"{M} micro-batches")
        xs, ys = x.chunk(M), labels.chunk(M)
        leaves, uses, maps, assemble = leaves_of(state["params"])

        def call(v, thunk):
            return torch.func.functional_call(
                holder, {f"layer.{n}": t for n, t in maps[v].items()},
                (thunk,))

        _, loss, grads, _ = run_pipeline(
            lambda v, h, m: fwd(v, h, m, key), leaves, uses, xs, S, V, pipe,
            lambda y, m: head(y, ys[m]) / M, call)
        grads = assemble(grads)
        reduce_grads(grads)
        grads = _mean_all(grads, ggroup, G)
        dev = x.device
        loss = (loss if loss is not None
                else torch.zeros((), device=dev)).float().contiguous()
        loss = broadcast(loss, src=last, group=pipe)
        with torch.no_grad():
            params = state["params"]
            grads = clip_grads(optimizer._grad_clip, grads)
            new_p, new_opt = optimizer._apply_update(
                grads, {"step": state["opt"]["step"],
                        "slots": state["opt"]["slots"]}, params, lr=lr)
            slots = state["opt"]["slots"]
            for n, s in new_opt["slots"].items():
                for k, v in s.items():
                    if v is not slots[n][k]:
                        slots[n][k].copy_(v)
            state["opt"]["step"] = new_opt["step"]
            for n, v in new_p.items():
                if v is not params[n]:
                    params[n].copy_(v.to(params[n].dtype))
        return state, _global_loss(loss, ggroup, G)

    def refusing(state, key, lr, x, labels):
        from ..core import rng
        from ..nn.functional.norm import batch_stats_over
        with rng.refuse_draws(_MESH_DRAWS), \
                batch_stats_over(None, _PIPE_BATCH_STATS):
            return step(state, key, lr, x, labels)

    out = step if mesh.size <= 1 else refusing
    if layout is not None:
        out.layout = layout
    return out


_PIPE_BATCH_STATS = ("a batch norm in training mode inside a pipeline train "
                     "step over more than one rank waits for ROADMAP A7b "
                     "item 8: a stage sees one rank's micro-batch, not the "
                     "global batch the reference normalises")


def _sum_over(grads, names, group):
    """``grads[n]`` for ``n`` in ``names`` summed over ``group`` (one
    flat fp32 all-reduce), in place."""
    from .collective import ReduceOp, all_reduce
    names = sorted(names)
    if group.nranks <= 1 or not names:
        return
    flat = torch.cat([grads[n].reshape(-1).float() for n in names])
    all_reduce(flat, ReduceOp.SUM, group)
    off = 0
    for n in names:
        g = grads[n]
        grads[n] = flat[off:off + g.numel()].view(g.shape).to(g.dtype)
        off += g.numel()


def _layout(state0, p_specs, s_specs, mesh):
    from .checkpoint import Layout
    rep = replicated_spec()
    specs = {"params": dict(p_specs),
             "opt": {"step": rep, "slots": {
                 n: {k: (s_specs[n] if v.dim() > 0 else rep)
                     for k, v in sl.items()}
                 for n, sl in state0["opt"]["slots"].items()}},
             "buffers": {}}
    return Layout(specs, mesh)


def make_stacked_pipeline_step(embed_fn: Callable, block_fn: Callable,
                               head_loss_fn: Callable, params0, optimizer,
                               hcg, n_layers: int, n_microbatches: int,
                               stacked_keys, layer=None, donate: bool = True,
                               remat=True, virtual_pp_degree: int = 1,
                               monitor=None, bind=None, batch_info=None):
    """The stacked-stage pipelined train step over ``hcg``'s mesh
    (module docstring, 1).

    - ``embed_fn(x, key)`` -> h (the first global stage),
      ``block_fn(l, h, key, ctx)`` -> h (layer l of the held stack),
      ``head_loss_fn(h, labels)`` -> scalar loss (the last global stage):
      they read ``layer``'s parameters, which the step swaps for this
      rank's (``torch.func.functional_call``; the port's functions read a
      module, the reference's take a params pytree);
    - ``params0``: ``layer``'s parameters by name; ``stacked_keys`` those
      whose dim 0 is the ``n_layers`` layers, split over "pipe";
    - ``bind()`` -> ctx, called once a chunk's forward (GPT's QKV gather
      over the model ranks); ``remat`` as GPT's ``scan_blocks``;
    - ``virtual_pp_degree`` V > 1: the interleaved schedule (S*V chunks,
      rank d holding chunks v*S + d, stored chunk-interleaved);
    - ``n_microbatches`` M: each rank's rows split into M.

    Returns ``(step, state0)``, ``step(state, key, lr, x, labels) ->
    (state, loss)`` with ``step.layout`` the state's checkpoint
    ``Layout``; the state holds this rank's blocks (dim 0 over "pipe",
    model-axis splits as ``_dims_mapping`` gives them) of the parameters
    and their slots."""
    from ..telemetry import instrument_train_step
    if layer is None:
        raise ValueError("the port's stage functions read layer's "
                         "parameters: pass layer=")
    mesh = hcg.mesh
    S = mesh.shape.get("pipe", 1)
    V = max(int(virtual_pp_degree), 1) if S > 1 else 1
    if n_layers % (S * V):
        raise ValueError(f"n_layers ({n_layers}) must divide by pp degree "
                         f"* virtual_pp_degree ({S} * {V})")
    M = n_microbatches
    if V > 1 and M % S:
        raise ValueError(f"n_microbatches ({M}) must be a multiple of the "
                         f"pp degree ({S}) when virtual_pp_degree > 1")
    stacked = [k for k in params0 if k in set(stacked_keys)]
    if V > 1:
        params0 = {k: (interleave_layers(p.detach(), S, V) if k in stacked
                       else p) for k, p in params0.items()}
    for name, p in layer.named_parameters():
        if name in stacked:
            p._pipe_stacked = True
    p_specs = build_param_specs(params0, mesh, layer, 0)
    if S > 1:
        for k in stacked:
            p_specs[k] = override_leading_axis(p_specs[k], params0[k].dim(),
                                               "pipe")
    s_specs = _slot_specs(p_specs, params0, mesh, 0)
    params = {n: (local_shard(p.detach(), p_specs[n], mesh)
                  if spec_shards(p_specs[n], mesh) else p)
              for n, p in params0.items()}
    state0 = {"params": params, "opt": optimizer.init_state(params),
              "buffers": {}}
    lpc = n_layers // (S * V)
    d = mesh.coord.get("pipe", 0)
    G = S * V
    whole = [n for n in params if n not in stacked]
    model_split = {n for n in params if mesh.shape.get("model", 1) > 1
                   and any("model" in _entry_axes(e) for e in p_specs[n])}

    def leaves_of(ps):
        leaves, uses, maps = [], [], []
        shared = [ps[n].detach().requires_grad_() for n in whole]
        for v in range(V):
            chunk = [ps[n][v * lpc:(v + 1) * lpc].detach().requires_grad_()
                     for n in stacked]
            g = v * S + d
            base = len(leaves)
            leaves += chunk
            use = list(range(base, base + len(chunk)))
            if g in (0, G - 1):
                use += list(range(V * len(stacked),
                                  V * len(stacked) + len(whole)))
            uses.append(use)
            maps.append({**dict(zip(stacked, chunk)),
                         **dict(zip(whole, shared))})
        leaves += shared

        def assemble(gs):
            out = {}
            for i, n in enumerate(stacked):
                out[n] = torch.cat([
                    torch.zeros_like(leaves[v * len(stacked) + i])
                    if gs[v * len(stacked) + i] is None
                    else gs[v * len(stacked) + i] for v in range(V)])
            for j, n in enumerate(whole):
                k = V * len(stacked) + j
                out[n] = torch.zeros_like(leaves[k]) if gs[k] is None \
                    else gs[k]
            return out
        return leaves, uses, maps, assemble

    def fwd(v, x, m, key):
        g = v * S + d
        h = embed_fn(x, key) if g == 0 else x
        ctx = bind() if bind is not None else None
        return _run_blocks(block_fn, lpc, h, key, ctx, remat)

    pipe = mesh.axis_group("pipe")

    def reduce_grads(grads):
        _sum_over(grads, whole, pipe)

    def clip_grads(clip, grads):
        if clip is None:
            return grads
        if S > 1 and model_split:
            raise NotImplementedError(
                "a gradient clip over tensors split over both the pipe and "
                "model axes waits for ROADMAP A7b")
        if S > 1:
            return clip._clip_shards(grads, set(stacked), pipe)
        if model_split:
            return clip._clip_shards(grads, model_split,
                                     mesh.axis_group("model"))
        return clip._clip_pytree(grads)

    step = _pipe_step(optimizer, mesh, layer, state0, V, leaves_of, fwd,
                      head_loss_fn, M, donate, reduce_grads, clip_grads,
                      _layout(state0, p_specs, s_specs, mesh))
    wrapped = instrument_train_step(step, monitor, "pipeline",
                                    batch_info=batch_info)
    wrapped.layout = step.layout
    return wrapped, state0


def make_pipeline_train_step(pipeline_layer, loss_fn, optimizer, hcg,
                             accumulate_steps: int = 1, monitor=None,
                             donate: bool = True):
    """The train step of a ``PipelineLayer`` (module docstring, 2):
    ``step(state, key, lr, inputs, labels) -> (state, loss)`` with
    ``loss = loss_fn(layer(inputs), labels)`` (each a tensor, or the
    reference's list of one) the global mean over
    ``accumulate_steps`` micro-batches of each rank's rows.  This rank
    holds and updates its stage's layers (the state's parameters are the
    layer's own, updated in place under ``donate``); a shared layer's
    weight gradient is summed over the stages that use it.  Returns
    ``(step, state0)``."""
    from ..nn.clip import ClipGradByGlobalNorm
    from ..telemetry import instrument_train_step
    from .collective import ReduceOp, all_reduce
    mesh = hcg.mesh
    S = mesh.shape.get("pipe", 1)
    d = mesh.coord.get("pipe", 0)
    params0 = dict(pipeline_layer.named_parameters())
    state0 = {"params": params0, "opt": optimizer.init_state(params0),
              "buffers": {}}
    names = list(params0)
    shared = pipeline_layer._shared_groups()   # [(names, group, first)]
    pipe = mesh.axis_group("pipe")

    def leaves_of(ps):
        leaves = [ps[n].detach().requires_grad_(ps[n].requires_grad)
                  for n in names]

        def assemble(gs):
            return {n: torch.zeros_like(t) if gi is None else gi
                    for n, t, gi in zip(names, leaves, gs)
                    if t.requires_grad}
        return leaves, [list(range(len(leaves)))], \
            [dict(zip(names, leaves))], assemble

    def fwd(v, x, m, key):
        return pipeline_layer.forward_stage(x, d)

    def head(y, labels):
        return loss_fn(y, labels)

    def reduce_grads(grads):
        for ns, group, _ in shared:
            _sum_over(grads, ns, group)

    not_first = {n for ns, _, first in shared if not first for n in ns}

    def clip_grads(clip, grads):
        if clip is None:
            return grads
        if not isinstance(clip, ClipGradByGlobalNorm) or S <= 1:
            return clip._clip_pytree(grads)
        # each shared weight counts once: on the first stage using it
        sq = sum((g.float().square().sum() for n, g in grads.items()
                  if n not in not_first),
                 torch.zeros((), device=next(iter(grads.values())).device))
        all_reduce(sq, ReduceOp.SUM, pipe)
        return clip._scaled(grads, sq)

    inner = _pipe_step(optimizer, mesh, pipeline_layer, state0, 1,
                       leaves_of, fwd, head, max(int(accumulate_steps), 1),
                       donate, reduce_grads, clip_grads)

    def step(state, key, lr, inputs, labels):
        return inner(state, key, lr, _one(inputs), _one(labels))
    return instrument_train_step(step, monitor, "pipeline"), state0


def _one(batch):
    """The tensor of a batch given as the reference's list of one."""
    if isinstance(batch, (list, tuple)):
        if len(batch) != 1:
            raise ValueError(f"a pipeline stage takes one input tensor and "
                             f"the loss one label tensor, got {len(batch)}")
        return batch[0]
    return batch
