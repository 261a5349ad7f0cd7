"""The train steps over a mesh of data × sharding × sep × model ranks
(counterpart of
``paddle_tpu/distributed/spmd.py`` ``make_spmd_train_step``,
``_make_gspmd_step``, ``make_gspmd_step_from_loss``, ``shard_batch`` and
``make_gspmd_sharded_init_step``).

The reference jits one program over its mesh and lets GSPMD place the
collectives.  Here every rank runs the step on its own process
(``topology.ProcessMesh``) and the collectives are explicit:

- every rank is given the GLOBAL batch and takes its rows (dim 0 split
  over the data × sharding ranks in rank order: ``mesh.batch_group()``,
  the ranks at this rank's model and sep coordinates; under gradient
  accumulation its share of each micro-batch of the global rows) and,
  over sep ranks, its chunk of the sequence (``seq_dim`` split in sep
  order); its forward takes a batch norm's statistics over the batch
  group's rows and draws its rows' block of each global draw, so what it
  computes is the reference's GSPMD forward on those rows;
- a parameter the model axis splits is held and computed on as this
  rank's block (the model's own collectives run the tensor parallelism;
  its gradient is the block's), and everything below treats the block
  as the whole tensor (``sharding_rules.without_axis``);
- so is a parameter whose spec splits a dim over the data axis (an
  expert weight, ``{1: "data"}``): one rank holds it, every rank's tokens
  already gave it gradient through the expert exchange's backward, and
  each rank's loss is its own mean, so its gradient is that sum over the
  grad ranks' count, with no all-reduce over the axis that splits it
  (still a mean over any grad axis that does not);
- the loss is the mean over the data × sharding × sep ranks of each
  rank's mean (equal counts: the global mean; the model ranks compute
  the same loss); the gradients are the mean over those ranks (one flat
  all-reduce; under a sharded parameter or ZeRO-2 layout a
  reduce-scatter into the slot layout instead);
- ``grad_comm`` runs in LOCAL mode on the mean-reduced fp32 gradient, as
  in the reference's GSPMD steps (``grad_comm.py``);
- each rank updates its shard of the optimizer slots (the ``sharding``
  axis of the slot specs, ZeRO-1 as the reference's specs give it) and
  the parameters are all-gathered back where their spec replicates them.

A mesh of one rank (or none) takes the one-device step: the loss and its
gradients, then ``optimizer.update``, with nothing to communicate.  ZeRO
and its stage-2/3 layouts compose with the data and sharding axes only
(over model or sep ranks, or with expert weights held over the data
axis, they raise: ROADMAP A7b).  A pipe axis no spec splits is held
replicated (each pipe rank computes the same step, as the reference's
GSPMD does).

The pipe axis runs through the schedules at the end of this module
(:func:`spmd_pipeline`, :func:`spmd_pipeline_interleaved`, their shared
:func:`run_pipeline`) and ``pipeline_engine``'s steps.  The reference's
``ensure_varying`` marks a carry for JAX's varying-manual-axes checker and
has no counterpart here (``ROADMAP.md`` §C).
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch
from torch import nn

from ..core import rng
from ..nn.functional.norm import batch_stats_over
from .sharding_rules import (PartitionSpec, _entry_axes, _flatten_with_path,
                             _map_with_path, batch_spec,
                             build_param_specs, build_state_shardings,
                             gather_full, local_shard, replicated_spec,
                             spec_shards, without_axis)
from .topology import GRAD_AXES

#: the axes a parameter may be held on as this rank's block and computed
#: on there: the model axis (tensor parallelism) and the data axis
#: (expert parallelism); "sharding" in a spec is ZeRO's, gathered
HELD_AXES = ("model", "data")


class _Thunk(nn.Module):
    """Holds ``layer`` so ``torch.func.functional_call`` can swap its
    parameters for the duration of one call of a thunk."""

    def __init__(self, layer):
        super().__init__()
        self.layer = layer

    def forward(self, fn):
        return fn()


# --------------------------------------------------------------------------
# the pieces every step shares
# --------------------------------------------------------------------------

def _rows(batch, R: int, idx: int, skip=(), dim: int = 0):
    """This rank's block of the batch: each tensor with a dim ``dim``
    (nested in lists, tuples and dicts too) split into ``R`` equal blocks
    along it, block ``idx`` kept (dim 0: a rank's rows; dim 1 over the
    sep ranks: its sequence chunk); positions in ``skip`` ride whole."""
    def one(x):
        if isinstance(x, torch.Tensor) and x.dim() > dim:
            if x.shape[dim] % R:
                raise ValueError(f"dim {dim} of a batch ({x.shape[dim]}) "
                                 f"does not split over {R} ranks")
            n = x.shape[dim] // R
            return x.narrow(dim, idx * n, n)
        if isinstance(x, (list, tuple)):
            return type(x)(one(v) for v in x)
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        return x
    if R <= 1:
        return tuple(batch)
    return tuple(x if i in skip else one(x) for i, x in enumerate(batch))


def _held_block(t, spec, mesh):
    """This rank's block of ``t`` along the dims ``spec`` puts on a held
    axis (``HELD_AXES``; ``t`` itself when none is split)."""
    only = PartitionSpec(*(tuple(a for a in _entry_axes(e)
                                 if a in HELD_AXES) or None for e in spec))
    if not spec_shards(only, mesh):
        return t
    return local_shard(t.detach(), only, mesh)


def _without_held(spec):
    return without_axis(without_axis(spec, "model"), "data")


def _trainable(params0, layer):
    """The names the step differentiates: a layer's parameters that
    require grad; every name of a functional (plain tensor) tree."""
    if layer is None:
        return list(params0)
    return [n for n, p in params0.items() if p.requires_grad]


def _grad(obj, tensors):
    """The gradients of ``obj`` by ``tensors``: zeros for one the loss
    does not read (GoogLeNet's aux heads under a loss of its main
    logits), as ``jax.grad`` gives."""
    grads = torch.autograd.grad(obj, tensors, allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g
                 for t, g in zip(tensors, grads))


def _loss_and_grads(loss_of, leaves, trainable, holder, batch, scale=None,
                    accumulate_steps: int = 1, buffers=None, local=None):
    """(detached loss, {name: grad}) of ``loss_of(leaves, *batch)``.  With
    ``holder`` (the layer) whose own parameters are not ``leaves``, or
    with ``buffers`` (named tensors to stand in for the layer's buffers),
    ``torch.func.functional_call`` swaps them in for the forward and the
    backward (a recomputed block reads the same tensors; a layer that
    updates a buffer in place updates the given one).  ``scale``
    multiplies the loss before the backward (ZeRO's loss scale).  With
    ``accumulate_steps`` the rows split into that many micro-batches,
    whose losses and gradients are averaged; each reads clones of
    ``buffers`` and the given ones stay as they are (the reference's
    accumulating step returns its buffers unchanged).  ``local(b)``: this
    rank's rows of a (micro-)batch ``b`` of the global rows and the
    context its forward and backward run in (the mesh step's); None
    takes ``b`` as it is."""
    own = holder is None or all(
        leaves.get(n) is p for n, p in holder.layer.named_parameters())
    if buffers is not None and holder is not None and all(
            buffers.get(n) is b for n, b in holder.layer.named_buffers()):
        buffers = None          # the layer's own: nothing to swap in

    def run(*b):
        loss = loss_of(leaves, *b)
        obj = loss if scale is None else loss * scale
        return loss.detach(), _grad(obj, [leaves[n] for n in trainable])

    def call(b, bufs):
        rows, ctx = local(b) if local is not None else (
            b, contextlib.nullcontext())
        with ctx:
            if own and bufs is None:
                return run(*rows)
            return torch.func.functional_call(
                holder, {f"layer.{n}": t
                         for n, t in {**leaves, **(bufs or {})}.items()},
                (lambda: run(*rows),))

    if accumulate_steps <= 1:
        loss, g = call(batch, buffers)
        return loss, dict(zip(trainable, g))
    if holder is not None and buffers is None:
        buffers = dict(holder.layer.named_buffers())
    loss, acc = None, None
    for m in range(accumulate_steps):
        with rng.fold_scope(m):      # the reference's fold_in(key, m)
            lm, gm = call(_rows(batch, accumulate_steps, m),
                          _clone_tree(buffers) if buffers else None)
        loss = lm if loss is None else loss + lm
        acc = list(gm) if acc is None else [a + b for a, b in zip(acc, gm)]
    return loss / accumulate_steps, {n: a / accumulate_steps
                                     for n, a in zip(trainable, acc)}


def _mean_all(grads: Dict[str, torch.Tensor], group, R: int):
    """The gradients' mean over ``group``: one flat fp32 all-reduce
    (float64 where a gradient is float64, as the reference reduces it in
    its own dtype under x64)."""
    from .collective import ReduceOp, all_reduce
    if R <= 1 or not grads:
        return grads
    names = sorted(grads)
    dt = torch.float64 if any(g.dtype == torch.float64
                              for g in grads.values()) else torch.float32
    flat = torch.cat([grads[n].reshape(-1).to(dt) for n in names])
    all_reduce(flat, ReduceOp.SUM, group)
    flat /= R
    out, off = {}, 0
    for n in names:
        g = grads[n]
        out[n] = flat[off:off + g.numel()].view(g.shape).to(g.dtype)
        off += g.numel()
    return out


def _sharded_dim(spec, mesh, axis="sharding"):
    """The dim ``spec`` splits over ``axis`` (None if none)."""
    for d, e in enumerate(spec):
        if e == axis and mesh.shape.get(axis, 1) > 1:
            return d
    return None


def _reduce_scatter_grads(grads, s_specs, mesh, group, R: int):
    """The gradients' mean, each landing in its slot layout: a tensor
    whose slot spec splits a dim over "sharding" is summed over the data
    group and reduce-scattered over the sharding group along that dim
    (the ZeRO-2 contract); the rest go through one flat all-reduce."""
    from .collective import ReduceOp, all_reduce, reduce_scatter_dim
    data = mesh.axis_group("data")
    shard = mesh.axis_group("sharding")
    out, rest = {}, {}
    for n in sorted(grads):
        d = _sharded_dim(s_specs[n], mesh)
        if d is None:
            rest[n] = grads[n]
            continue
        g = grads[n].float().contiguous()
        if data.nranks > 1:
            all_reduce(g, ReduceOp.SUM, data)
        out[n] = reduce_scatter_dim(g, d, shard) / R
    out.update(_mean_all(rest, group, R))
    return out


def _clip_shards(clip, grads, specs, mesh, model_split=(),
                 expert_split=()):
    """The optimizer's clip over gradients held as shards under ``specs``
    (or as model-axis blocks: ``model_split``; data-axis expert blocks:
    ``expert_split``), with whole-tensor semantics (``nn/clip.py``)."""
    if clip is None:
        return grads
    split = {n for n in grads if _sharded_dim(specs[n], mesh) is not None}
    held = [(names, axis) for names, axis in
            ((split, "sharding"), ({n for n in model_split if n in grads},
                                   "model"),
             ({n for n in expert_split if n in grads}, "data")) if names]
    if len(held) > 1:
        raise NotImplementedError(
            "a gradient clip over tensors split over more than one of the "
            "sharding, model and expert axes waits for ROADMAP A7b")
    if not held:
        return clip._clip_pytree(grads)
    names, axis = held[0]
    return clip._clip_shards(grads, names, mesh.axis_group(axis))


def _mean_held(grads, mesh, G: int):
    """The expert blocks' gradients: each already sums every rank's
    tokens over the axis that splits it; all-reduced over the other grad
    axes and divided by the grad ranks' count ``G``."""
    from .collective import ReduceOp, all_reduce
    if not grads:
        return grads
    group, _ = mesh.batch_group(tuple(a for a in GRAD_AXES
                                      if a not in HELD_AXES))
    out = {}
    for n, g in grads.items():
        g = g.float()
        if group.nranks > 1:
            g = all_reduce(g.contiguous(), ReduceOp.SUM, group)
        out[n] = (g / G).to(grads[n].dtype)
    return out


def _rank_loss_and_grads(loss_of, params, p_specs, p_split, mesh, holder,
                         trainable, batch, scale=None,
                         accumulate_steps: int = 1, buffers=None,
                         local=None):
    """(loss, grads) of this rank's rows of the global ``batch``
    (``local``, ``_loss_and_grads``'): the parameters ``p_split`` names
    are all-gathered for the forward and the backward, and the gathered
    copies die with the call (ZeRO-3); ``buffers`` stand in for the
    layer's."""
    full = {n: (gather_full(t, p_specs[n], mesh) if p_split[n] else t)
            for n, t in params.items()}
    leaves = {n: (t if (holder is not None and t.requires_grad
                        and not p_split[n]) else
                  t.detach().requires_grad_(n in trainable))
              for n, t in full.items()}
    return _loss_and_grads(loss_of, leaves, trainable, holder, batch, scale,
                           accumulate_steps, buffers, local)


def _found_inf(grads, group):
    """Whether a gradient is non-finite on any rank of ``group``: each
    rank's flag MAX-reduced, so a step is skipped on every rank or on
    none (a rank's shards may all be finite while another's are not)."""
    from .collective import ReduceOp, all_reduce
    bad = torch.stack([(~torch.isfinite(g)).any()
                       for g in grads.values()]).any().to(torch.int32)
    all_reduce(bad, ReduceOp.MAX, group)
    return bad > 0


def _clone_tree(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree


def _global_loss(loss, group, R: int):
    """The mean of the ranks' losses, in fp32 (float64 for a float64
    loss, as the reference keeps it under x64)."""
    from .collective import ReduceOp, all_reduce
    out = loss.detach().clone()
    if out.dtype != torch.float64:
        out = out.float()
    if R > 1:
        all_reduce(out, ReduceOp.SUM, group)
        out /= R
    return out


# --------------------------------------------------------------------------
# the step over a mesh
# --------------------------------------------------------------------------

def _make_mesh_step(loss_of, params0, optimizer, mesh, layer, p_specs,
                    s_specs, policy, donate: bool = True, *, zero=None,
                    accumulate_steps: int = 1, comm_spec=None, seq_dim=None,
                    held=()):
    """The shared step over ``mesh`` (module docstring).  ``zero`` None
    is the GSPMD counterpart; a dict adds ZeRO's contract
    (``master_keys``, ``dynamic``, ``init_scale``, ``growth_interval``,
    ``backoff``, ``growth``, ``stage``): fp32 masters, the loss scale,
    ``found_inf`` (MAX-reduced over the world: a non-finite step is
    skipped on every rank) and the stage-2 reduce-scatter.
    ``comm_spec``: the spec of the flat ``comm_e`` residual.
    ``seq_dim``: the batch tensors' sequence dim the sep ranks split.
    ``held``: the names of ``params0`` that already are this rank's blocks
    (tensor-parallel layers, an expert layer after ``set_mesh``).
    Returns ``(step, state0)`` with
    ``step(state, lr, *batch) -> (state, loss)``; off ZeRO,
    ``step.layout`` is the state's checkpoint ``Layout`` (each leaf's spec
    over the whole mesh, the model axis included)."""
    from .grad_comm import apply_policy_local

    group, bidx = mesh.batch_group()
    ggroup, _ = mesh.batch_group(GRAD_AXES)
    R, G = group.nranks, ggroup.nranks
    S = mesh.shape.get("sep", 1)

    def on(axis):
        return {n for n in params0 if mesh.shape.get(axis, 1) > 1 and any(
            axis in _entry_axes(e) for e in p_specs[n])}

    model_split, expert_split = on("model"), on("data")
    trainable = _trainable(params0, layer)
    whole_specs = (dict(p_specs), dict(s_specs))
    # from here on a held block stands for its whole tensor
    params0 = {n: (p if n in held else _held_block(p, p_specs[n], mesh))
               for n, p in params0.items()}
    p_specs = {n: _without_held(sp) for n, sp in p_specs.items()}
    s_specs = {n: _without_held(sp) for n, sp in s_specs.items()}
    dev = next(iter(params0.values())).device
    p_split = {n: spec_shards(p_specs[n], mesh) for n in params0}
    s_split = {n: spec_shards(s_specs[n], mesh) for n in params0}
    master_keys = set(zero["master_keys"]) if zero else set()
    stage = zero["stage"] if zero else 0

    def shard(t, spec):
        return local_shard(t.detach(), spec, mesh) \
            if spec_shards(spec, mesh) else t

    params_state = {n: (shard(p, p_specs[n]) if p_split[n] else p)
                    for n, p in params0.items()}
    master0 = {k: params0[k].detach().float() for k in master_keys}
    upd0 = {k: master0.get(k, p) for k, p in params0.items()}
    opt0 = optimizer.init_state(upd0)
    opt0["slots"] = {n: {k: (shard(v, s_specs[n]) if v.dim() > 0 else v)
                         for k, v in s.items()}
                     for n, s in opt0["slots"].items()}
    state0 = {"params": params_state, "opt": opt0}
    if zero:
        opt0["step"] = opt0["step"].to(dev)
        state0["master"] = {k: shard(v, s_specs[k]) for k, v in
                            master0.items()}
        state0["scaler"] = {
            "scale": torch.tensor(zero["init_scale"] if zero["dynamic"]
                                  else 1.0, dtype=torch.float32, device=dev),
            "good_steps": torch.zeros((), dtype=torch.int32, device=dev),
            "found_inf": torch.zeros((), dtype=torch.bool, device=dev)}
    else:
        state0["buffers"] = {}
    comm_spec = comm_spec if comm_spec is not None else replicated_spec()
    if policy.stateful:
        state0["comm_e"] = shard(policy.residual_for(params0, device=dev),
                                 comm_spec)
    holder = _Thunk(layer) if layer is not None else None
    # the stage-2/3 layout: gradients reduce-scattered into the slots'
    # shards (a non-fp32 local policy needs the whole mean gradient)
    rs_layout = policy.name == "fp32" and (stage >= 2 or any(p_split.values()))
    if (zero or rs_layout) and (mesh.shape.get("model", 1) > 1 or S > 1):
        raise NotImplementedError(
            "ZeRO layouts over model or sep ranks wait for ROADMAP A7b "
            "(ZeRO composed with tensor and sequence parallelism)")
    if (zero or rs_layout) and expert_split:
        raise NotImplementedError(
            "ZeRO layouts with an expert axis wait for ROADMAP A7b item 3 "
            "(ZeRO composed with expert parallelism)")

    draw_refusal = _draw_refusal(mesh, expert_split)
    local = _local_rows(mesh, draw_refusal, seq_dim)

    def step(state, lr, *batch):
        if not donate:
            state = _clone_tree(state)
        scale = state["scaler"]["scale"] if zero else None
        loss, grads = _rank_loss_and_grads(
            loss_of, state["params"], p_specs, p_split, mesh, holder,
            trainable, batch, scale, accumulate_steps, state.get("buffers"),
            local)
        if zero:
            inv = torch.where(scale > 0, 1.0 / scale, torch.zeros_like(scale))
            grads = {n: g.float() * inv for n, g in grads.items()}
        experts = _mean_held({n: grads.pop(n) for n in expert_split
                              if n in grads}, mesh, G)
        grads = (_reduce_scatter_grads(grads, s_specs, mesh, group, R)
                 if rs_layout else _mean_all(grads, ggroup, G))
        grads.update(experts)
        found_inf = _found_inf(grads, group) if zero else None
        comm_state = {}
        if policy.name != "fp32":
            e = state.get("comm_e")
            if e is not None and spec_shards(comm_spec, mesh):
                e = gather_full(e, comm_spec, mesh)
            grads, comm_state = apply_policy_local(
                policy, grads, {"comm_e": e}, found_inf)
        with torch.no_grad():
            if not rs_layout:
                grads = {n: (local_shard(g, s_specs[n], mesh)
                             if s_split[n] else g) for n, g in grads.items()}
            params = state["params"]
            upd = {n: (state["master"][n] if n in master_keys else
                       params[n] if p_split[n] or not s_split[n] else
                       local_shard(params[n], s_specs[n], mesh))
                   for n in trainable}
            grads = _clip_shards(optimizer._grad_clip, grads, s_specs, mesh,
                                 model_split, expert_split)
            new_upd, new_opt = optimizer._apply_update(
                grads, {"step": state["opt"]["step"],
                        "slots": {n: state["opt"]["slots"][n]
                                  for n in trainable}}, upd, lr=lr)
            if found_inf is not None:
                new_upd = {n: torch.where(found_inf, upd[n], v)
                           for n, v in new_upd.items()}
                new_opt["step"] = torch.where(found_inf, state["opt"]["step"],
                                              new_opt["step"])
                for n, s in new_opt["slots"].items():
                    old = state["opt"]["slots"][n]
                    for k, v in s.items():
                        s[k] = torch.where(found_inf, old[k], v)
            slots = state["opt"]["slots"]
            for n, s in new_opt["slots"].items():
                for k, v in s.items():
                    if v is not slots[n][k]:
                        slots[n][k].copy_(v)
            state["opt"]["step"] = new_opt["step"]
            for n, v in new_upd.items():
                if n in master_keys:
                    state["master"][n].copy_(v)
                p = params[n]
                v = v.to(p.dtype)
                if s_split[n] and not p_split[n]:
                    v = gather_full(v, s_specs[n], mesh)
                if v is not p:
                    p.copy_(v)
            if "comm_e" in comm_state:
                new_e = comm_state["comm_e"]
                state["comm_e"].copy_(local_shard(new_e, comm_spec, mesh)
                                      if spec_shards(comm_spec, mesh)
                                      else new_e)
            if zero:
                sc = state["scaler"]
                if zero["dynamic"]:
                    good = torch.where(found_inf, torch.zeros_like(
                        sc["good_steps"]), sc["good_steps"] + 1)
                    grow = good >= zero["growth_interval"]
                    sc["scale"] = torch.where(
                        found_inf,
                        torch.clamp(sc["scale"] * zero["backoff"], min=1.0),
                        torch.where(grow, sc["scale"] * zero["growth"],
                                    sc["scale"]))
                    sc["good_steps"] = torch.where(grow, torch.zeros_like(
                        good), good)
                sc["found_inf"] = found_inf
        return state, _global_loss(loss, ggroup, G)

    if _is_solo(mesh) or draw_refusal is None:
        refusing = step
    else:
        def refusing(state, lr, *batch):
            with rng.refuse_draws(draw_refusal):
                return step(state, lr, *batch)
    if _is_solo(mesh):
        return refusing, state0

    if not zero:
        from .checkpoint import Layout
        rep_ = replicated_spec()
        specs = {"params": {n: whole_specs[0][n] for n in params0},
                 "opt": {"step": rep_, "slots": {
                     n: {k: (whole_specs[1][n] if v.dim() > 0 else rep_)
                         for k, v in sl.items()}
                     for n, sl in opt0["slots"].items()}},
                 "buffers": {k: rep_ for k in state0["buffers"]}}
        if "comm_e" in state0:
            specs["comm_e"] = comm_spec
        refusing.layout = Layout(specs, mesh)
    return refusing, state0


_MESH_DRAWS = ("a random draw (dropout) inside a train step over model, "
               "sep, pipe or expert ranks waits for ROADMAP A7b item 8: a "
               "rank's block of a column- or sequence-split mask is not one "
               "counter range of the reference's global draw")

_SEP_BATCH_STATS = ("a batch norm in training mode inside a train step whose "
                    "rows the sep ranks split waits for ROADMAP A7b item 8")


def _draw_refusal(mesh, expert_split=()):
    """``_MESH_DRAWS`` where ``mesh`` has model, sep, pipe or expert
    ranks (a step there must not draw), else None."""
    return _MESH_DRAWS if expert_split or any(
        mesh.shape.get(a, 1) > 1 for a in ("model", "sep", "pipe")) else None


def _local_rows(mesh, draw_refusal, seq_dim=None):
    """``local(b)`` of a step over ``mesh``: this rank's rows of a
    (micro-)batch ``b`` of the global rows and the scope of their forward:
    a batch norm's statistics over the batch ranks (refused where the sep
    ranks split the rows too), a draw's block of the global draw at this
    rank's rows (none where ``draw_refusal`` refuses the step's draws)."""
    group, bidx = mesh.batch_group()
    R = group.nranks
    S, sidx = mesh.shape.get("sep", 1), mesh.coord.get("sep", 0)
    seq_split = seq_dim is not None and S > 1

    def local(b):
        rows = _rows(b, R, bidx)
        if seq_dim is not None:
            rows = _rows(rows, S, sidx, dim=seq_dim)
        ctx = contextlib.ExitStack()
        ctx.enter_context(batch_stats_over(
            group, _SEP_BATCH_STATS if seq_split else None))
        n = _lead_rows(rows)
        if R > 1 and draw_refusal is None and n:
            ctx.enter_context(rng.row_block(bidx, n))
        return rows, ctx
    return local


def _lead_rows(batch) -> int:
    """The leading dim of the first tensor of ``batch`` (nested in lists,
    tuples and dicts) with one: a rank's row count."""
    for x in (batch.values() if isinstance(batch, dict) else batch):
        if isinstance(x, torch.Tensor) and x.dim() > 0:
            return x.shape[0]
        if isinstance(x, (list, tuple, dict)):
            n = _lead_rows(x)
            if n:
                return n
    return 0


# --------------------------------------------------------------------------
# the one-device step
# --------------------------------------------------------------------------

def _make_local_step(loss_of, params0, optimizer, layer, donate, policy,
                     accum_steps: int = 1, scaler=None):
    """The step on one device (no mesh, or a mesh of one rank).

    ``accum_steps`` > 1 sums each call's gradients into ``state["acc"]``
    (``state["acc_count"]`` calls so far) and applies their mean, the
    policy with it, on every ``accum_steps``-th call (reference
    ``jit/functional.py:225``; the count is read on the host).
    ``scaler`` (dynamic loss-scale knobs, ``jit.functional._scaler_knobs``)
    multiplies the loss by ``state["scaler"]["scale"]`` before the
    backward, unscales the gradients, and keeps the old parameters, slots
    and residual when one is not finite (reference
    ``amp.GradScaler.functional_update``)."""
    from .grad_comm import apply_policy_local

    if not donate and layer is None:
        raise ValueError("donate=False needs the layer whose parameters the "
                         "loss reads")
    dev = next(iter(params0.values())).device
    state0 = {"params": dict(params0), "opt": optimizer.init_state(params0),
              "buffers": {}}
    if scaler is not None:
        state0["scaler"] = {
            "scale": torch.tensor(scaler["init_loss_scaling"],
                                  dtype=torch.float32, device=dev),
            "good": torch.zeros((), dtype=torch.int32, device=dev),
            "bad": torch.zeros((), dtype=torch.int32, device=dev)}
    if accum_steps > 1:
        state0["acc"] = {n: torch.zeros_like(p.detach())
                         for n, p in params0.items()}
        state0["acc_count"] = torch.zeros((), dtype=torch.int32)
    if policy.stateful:
        state0["comm_e"] = policy.residual_for(params0)
    trainable = [n for n, p in params0.items() if p.requires_grad]

    def update(state, params, grads, lr):
        """(new params, new opt state, the rest of the new state) of one
        call; the params and opt state are None while gradients
        accumulate."""
        rest, found_inf = {}, None
        if scaler is not None:
            grads, found_inf, rest["scaler"] = _unscale(scaler,
                                                        state["scaler"], grads)
        if accum_steps > 1:
            acc = {n: a + grads[n] if n in grads else a
                   for n, a in state["acc"].items()}
            count = state["acc_count"] + 1
            if int(count) < accum_steps:
                rest.update(acc=acc, acc_count=count)
                return None, None, rest
            grads = {n: acc[n] / accum_steps for n in trainable}
            rest.update(acc={n: torch.zeros_like(a) for n, a in acc.items()},
                        acc_count=torch.zeros_like(count))
        grads, comm_state = apply_policy_local(policy, grads, state,
                                               found_inf=found_inf)
        rest.update(comm_state)
        new_p, new_opt = optimizer.update(grads, state["opt"], params, lr=lr)
        if found_inf is not None:
            def keep(old, new):
                return torch.where(found_inf.to(old.device), old, new)
            old = state["opt"]["slots"]
            new_p = {n: keep(params[n], v) for n, v in new_p.items()}
            new_opt = {"step": keep(state["opt"]["step"], new_opt["step"]),
                       "slots": {n: {k: keep(old[n][k], v)
                                     for k, v in s.items()}
                                 for n, s in new_opt["slots"].items()}}
        return new_p, new_opt, rest

    def donated(state, lr, *batch):
        params = state["params"]
        loss = loss_of(params, *batch)
        obj = loss if scaler is None else loss * state["scaler"]["scale"]
        grads = dict(zip(trainable, _grad(obj, [params[n]
                                                for n in trainable])))
        with torch.no_grad():
            new_p, new_opt, rest = update(state, params, grads, lr)
            if new_p is not None:
                for n, p in params.items():
                    if new_p[n] is not p:
                        p.copy_(new_p[n])
                slots = state["opt"]["slots"]
                for n, s in new_opt["slots"].items():
                    for k, v in s.items():
                        if v is not slots[n][k]:
                            slots[n][k].copy_(v)
                state["opt"]["step"] = new_opt["step"]
            for k, v in rest.items():
                if k in ("comm_e", "acc"):
                    _copy_tree(state[k], v)
                else:
                    state[k] = v
        return state, loss.detach()

    holder = _Thunk(layer) if layer is not None else None

    def kept(state, lr, *batch):
        leaves = {n: p.detach().requires_grad_(n in trainable)
                  for n, p in state["params"].items()}
        # the forward reads and advances clones of the given buffers
        buffers = {n: b.detach().clone()
                   for n, b in state["buffers"].items()}
        loss, g = _loss_and_grads(
            loss_of, leaves, trainable, holder, batch,
            scale=None if scaler is None else state["scaler"]["scale"],
            buffers=buffers)
        with torch.no_grad():
            new_p, new_opt, rest = update(state, leaves, g, lr)
            if new_p is None:
                new_p, new_opt = leaves, state["opt"]
            old = state["opt"]["slots"]
            fresh = {"params": {n: (v.clone() if v is leaves[n] else v)
                                for n, v in new_p.items()},
                     "opt": {"step": new_opt["step"], "slots": {
                         n: {k: (v.clone() if v is old[n].get(k) else v)
                             for k, v in s.items()}
                         for n, s in new_opt["slots"].items()}},
                     "buffers": buffers}
            for k in ("comm_e", "scaler", "acc", "acc_count"):
                if k in state:
                    fresh[k] = rest.get(k, state[k])
        return fresh, loss

    return (donated if donate else kept), state0


def _copy_tree(dst, src):
    """Copy a tensor or a dict of tensors into ``dst``'s tensors."""
    if isinstance(dst, dict):
        for k, v in src.items():
            dst[k].copy_(v)
    else:
        dst.copy_(src)


def _unscale(knobs, st, grads):
    """(unscaled grads, found_inf, new scaler state) of the reference's
    ``GradScaler.functional_update`` (``amp/__init__.py:276``)."""
    inv = 1.0 / st["scale"]
    grads = {n: (g.float() * inv).to(g.dtype) for n, g in grads.items()}
    found_inf = ~torch.stack([torch.isfinite(g).all()
                              for g in grads.values()]).all()
    good = torch.where(found_inf, 0, st["good"] + 1)
    bad = torch.where(found_inf, st["bad"] + 1, 0)
    scale = st["scale"]
    decr = bad >= knobs["decr_every_n_nan_or_inf"]
    scale = torch.where(decr, torch.clamp(scale * knobs["decr_ratio"],
                                          min=1.0), scale)
    bad = torch.where(decr, 0, bad)
    incr = good >= knobs["incr_every_n_steps"]
    scale = torch.where(incr, scale * knobs["incr_ratio"], scale)
    good = torch.where(incr, 0, good)
    return grads, found_inf, {"scale": scale, "good": good, "bad": bad}


def _is_solo(mesh) -> bool:
    return mesh is None or mesh.size <= 1


# --------------------------------------------------------------------------
# the builders
# --------------------------------------------------------------------------

def make_spmd_train_step(layer, loss_fn, optimizer, hcg, zero_stage: int = 0,
                         accumulate_steps: int = 1, donate: bool = True,
                         monitor=None, grad_comm=None):
    """The train step over the hybrid mesh for an ``nn.Module`` and a loss
    callable (PyTorch idiom; the reference functionalizes its Layer):
    ``step(state, key, lr, inputs, labels) -> (state, loss)`` with
    ``loss = loss_fn(layer(*inputs), *labels)`` the global mean.  Every
    rank passes the global ``inputs``/``labels`` lists and takes its rows
    (of micro-batch ``m`` of the global rows under ``accumulate_steps``).
    The forward runs under ``rng_scope(key)`` (micro-batch ``m`` under
    ``fold_in(key, m)``), as in the reference: over the data and sharding
    ranks a draw is this rank's rows of the reference's draw over the
    global batch (``core.rng.row_block``), and a batch norm's statistics
    cover the global batch (``nn.functional.batch_stats_over``); over
    model, sep, pipe or expert ranks a draw raises (ROADMAP A7b item 8).
    The forward reads and advances ``state["buffers"]`` (clones of them
    under ``donate=False``); under ``accumulate_steps`` > 1 they come back
    as given, as the reference's do.  Returns
    ``(step, state0, state_specs)``: the state ``{"params", "opt",
    "buffers"}`` (``comm_e`` with a stateful ``grad_comm``) holds this
    rank's shards; ``state_specs`` is their
    spec tree (the reference returns ``NamedSharding``s of it)."""
    from ..jit.functional import _make_loss_of
    from ..telemetry import instrument_train_step
    from .grad_comm import comm_info, resolve_policy

    policy = resolve_policy(grad_comm)
    mesh = hcg.mesh
    params0 = dict(layer.named_parameters())

    loss_of = _make_loss_of(layer, loss_fn, None, [])
    held = _held_blocks(params0, mesh)
    p_specs = build_param_specs(params0, mesh, layer, zero_stage)
    p_specs.update({n: _held_spec(params0[n], p_specs[n], mesh)
                    for n in held})
    s_specs = _slot_specs(p_specs, params0, mesh, zero_stage)
    raw, state0 = _make_mesh_step(loss_of, params0, optimizer, mesh, layer,
                                  p_specs, s_specs, policy, donate,
                                  accumulate_steps=accumulate_steps,
                                  held=held)
    state0["buffers"] = dict(layer.named_buffers())
    specs = build_state_shardings(state0, p_specs, mesh, zero_stage, params0)
    if policy.stateful:
        specs["comm_e"] = replicated_spec()

    def step(state, key, lr, inputs, labels):
        with rng.rng_scope(key):
            return raw(state, lr, list(inputs), list(labels))

    return instrument_train_step(step, monitor, "spmd",
                                 comm=comm_info(params0, policy)), \
        state0, specs


def _held_blocks(params0, mesh):
    """The parameters a layer already holds as its block of a held axis
    (``is_distributed``: the tensor-parallel layers, an expert layer
    after ``set_mesh``; none on one rank)."""
    if _is_solo(mesh):
        return set()
    return {n for n, p in params0.items()
            if getattr(p, "is_distributed", False) is True}


def _held_spec(p, spec, mesh):
    """The whole tensor's spec of a held block: ``spec`` with each held
    axis of more than one rank on the dims its ``_dims_mapping`` names
    (the block's own shape cannot tell whether the degree divides the
    whole)."""
    entries = list(spec) + [None] * (p.dim() - len(spec))
    for d, axis in getattr(p, "_dims_mapping", {}).items():
        if axis in HELD_AXES and mesh.shape.get(axis, 1) > 1:
            entries[int(d)] = axis
    return PartitionSpec(*entries)


def make_gspmd_step_from_loss(loss_of, params0, optimizer, mesh=None,
                              layer=None, zero_stage: int = 0,
                              donate: bool = True, grad_comm=None,
                              seq_dim=None):
    """The shared builder for functional models (gpt/bert):
    ``loss_of(params, *batch) -> scalar``.  Returns ``(step, state0)``
    with ``step(state, lr, *batch) -> (state, loss)`` and state
    ``{"params", "opt", "buffers"}`` (``comm_e`` under a stateful
    ``grad_comm``, applied in local mode).

    ``params0`` are a layer's own parameters (``layer``, read by the loss)
    or a plain dict of tensors the loss reads from its ``params``
    argument.  With ``donate`` the step writes the new parameters and
    slots INTO the state's tensors (the model sees every update);
    ``donate=False`` leaves the given state untouched and returns a fresh
    one.  Over a mesh of more than one rank the slots shard over
    "sharding" as ZeRO-1 (the reference's ``max(zero_stage, 1)``), the
    batch rows split over the ranks, the sequence dim ``seq_dim`` over
    the sep ranks, and a parameter the model axis splits is held as this
    rank's block, which ``loss_of`` computes on (module docstring)."""
    from .grad_comm import resolve_policy
    policy = resolve_policy(grad_comm)
    if _is_solo(mesh):
        return _make_local_step(loss_of, params0, optimizer, layer, donate,
                                policy)
    p_specs = build_param_specs(params0, mesh, layer, zero_stage)
    s_specs = _slot_specs(p_specs, params0, mesh, max(zero_stage, 1))
    return _make_mesh_step(loss_of, params0, optimizer, mesh, layer, p_specs,
                           s_specs, policy, donate, seq_dim=seq_dim)


def _slot_specs(p_specs, params0, mesh, zero_stage):
    from .sharding_rules import _slot_spec
    return {k: _slot_spec(p_specs[k], p, mesh, zero_stage)
            for k, p in params0.items()}


def shard_batch(batch, hcg):
    """This rank's rows of every tensor in ``batch`` along the data axis
    (the reference puts the batch dim on "data": ``batch_spec``)."""
    mesh = hcg.mesh
    spec = batch_spec(mesh)
    if not spec:
        return batch
    R, idx = mesh.shape["data"], mesh.coord["data"]
    out = _rows((batch,), R, idx)[0]
    return out


def make_gspmd_sharded_init_step(loss_of, build_params, optimizer, mesh,
                                 meta_layer=None, zero_stage: int = 0,
                                 donate: bool = True, seed: int = 0,
                                 grad_comm=None):
    """Like ``make_gspmd_step_from_loss`` with the state built from
    ``build_params(seed) -> {name: tensor}`` (the same on every rank) and
    each rank keeping only its shards (``zero_stage`` 3 shards the
    parameters too).  The reference initialises each device's shard
    directly under jit; here each rank builds the whole tree once and
    keeps its blocks (``ROADMAP.md`` §C)."""
    return make_gspmd_step_from_loss(loss_of, build_params(seed), optimizer,
                                     mesh, meta_layer, zero_stage, donate,
                                     grad_comm)


# --------------------------------------------------------------------------
# the pipeline schedules (the pipe axis)
# --------------------------------------------------------------------------
#
# The reference runs one program: a ``lax.scan`` over M+S-1 ticks with a
# ``ppermute`` hop a tick, differentiated by AD (GPipe order, remat per
# tick).  Here each pipe rank is a process running its own stage, and the
# order is 1F1B (Paddle's ``forward_backward_pipeline``; interleaved as
# Megatron's, chunk v of rank d being global stage v*S + d): a rank starts
# the backward of its oldest micro-batch as soon as it can, so under plain
# 1F1B it keeps at most S - d micro-batches' activations (the reference's
# GPipe keeps M).  Activations go to the next global stage and their
# gradients come back by point-to-point exchanges.  Every rank derives the
# same tick table from the ranks' orders (``pipeline_ticks``) and posts
# both sides of each message at the boundary after the tick that made it
# (``collective.p2p_exchange``): a rank's exchange at boundary t waits
# only on ranks that reach t after finishing every earlier boundary, so no
# order of sends can deadlock.

#: the p2p exchanges of the schedules in this process: their wall time
#: (waits for the peer included), messages sent and bytes sent
PIPE_P2P = {"seconds": 0.0, "messages": 0, "bytes": 0}

_HEADER = 10
_WIRE_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
                torch.int64, torch.int32, torch.int16, torch.int8,
                torch.uint8, torch.bool)


def pipeline_order(n_stages: int, n_chunks: int, n_microbatches: int,
                   stage: int, forward_only: bool = False):
    """Stage ``stage``'s ops in order: ``("F" | "B", microbatch, chunk)``.
    Megatron's 1F1B: a warm-up of forwards (S - d - 1; interleaved,
    2 (S - d - 1) + (V - 1) S, or all of them when M equals S), then one
    forward and one backward in turn, then the remaining backwards.  The
    k-th forward of the interleaved order runs chunk (k mod SV) // S on
    micro-batch (k // SV) S + k mod S, and the k-th backward the chunks in
    reverse (``M % S == 0`` there)."""
    S, V, M = n_stages, n_chunks, n_microbatches
    total = M * V

    def op(kind, k):
        v = (k % (S * V)) // S
        m = (k // (S * V)) * S + k % S
        return kind, m, (v if kind == "F" else V - 1 - v)

    if forward_only:
        warm = total
    elif V == 1:
        warm = min(S - stage - 1, M)
    elif M == S:
        warm = total
    else:
        warm = min(2 * (S - stage - 1) + (V - 1) * S, total)
    ops = [op("F", k) for k in range(warm)]
    for i in range(total - warm):
        ops += [op("F", warm + i), op("B", i)]
    if not forward_only:
        ops += [op("B", k) for k in range(total - warm, total)]
    return ops


def pipeline_ticks(n_stages: int, n_chunks: int, n_microbatches: int,
                   forward_only: bool = False):
    """The schedule every rank runs: for each stage its ``[(tick, op)]``.
    Each stage takes its next op (``pipeline_order``) at the first tick
    after the op it needs has run: the previous global stage's forward of
    that micro-batch, the next one's backward (the last stage's backward
    needs its own forward, which its order puts first)."""
    S, V, M = n_stages, n_chunks, n_microbatches
    G = S * V
    orders = [pipeline_order(S, V, M, d, forward_only) for d in range(S)]
    pos, done = [0] * S, {}
    out = [[] for _ in range(S)]
    t = 0
    while any(pos[d] < len(orders[d]) for d in range(S)):
        ran = []
        for d in range(S):
            if pos[d] == len(orders[d]):
                continue
            kind, m, v = orders[d][pos[d]]
            g = v * S + d
            if kind == "F":
                need = ("F", g - 1, m) if g > 0 else None
            else:
                need = ("B", g + 1, m) if g < G - 1 else None
            if need is None or done.get(need, t) < t:
                ran.append((d, (kind, m, v), (kind, g, m)))
        if not ran:
            raise RuntimeError(f"the pipeline order stalls at tick {t} "
                               f"(S {S}, V {V}, M {M})")
        for d, o, key in ran:
            out[d].append((t, o))
            done[key] = t
            pos[d] += 1
        t += 1
    return out


def _header(t):
    h = torch.zeros(_HEADER, dtype=torch.int64)
    h[0] = _WIRE_DTYPES.index(t.dtype)
    h[1] = t.dim()
    h[2:2 + t.dim()] = torch.tensor(t.shape, dtype=torch.int64)
    return h.to(t.device)


def _from_header(h, device):
    h = h.tolist()
    return torch.empty(h[2:2 + h[1]], dtype=_WIRE_DTYPES[h[0]],
                       device=device)


def broadcast_from(t, src: int, group, device):
    """Global rank ``src``'s tensor ``t`` on every rank of ``group`` (the
    others pass None): its shape and dtype first, then its values."""
    from .collective import broadcast
    head = _header(t) if t is not None else \
        torch.zeros(_HEADER, dtype=torch.int64, device=device)
    broadcast(head, src=src, group=group)
    if t is None:
        t = _from_header(head.cpu(), device)
    return broadcast(t.contiguous(), src=src, group=group)


def _warm_group(group, device):
    """One all-reduce over ``group`` before its first batched p2p call:
    NCCL's ``batch_isend_irecv`` needs every rank in a group's first
    collective."""
    from .collective import all_reduce
    if group.backend == "nccl" and not getattr(group, "_p2p_warm", False):
        all_reduce(torch.zeros(1, device=device), group=group)
        group._p2p_warm = True


def run_pipeline(fwd, leaves, uses, microbatches, n_stages: int,
                 n_chunks: int, group, loss_fn=None, call=None):
    """This rank's part of the pipeline over ``group`` (the pipe group; this
    rank is stage ``group.rank``).

    - ``fwd(v, x, m)``: chunk ``v``'s output for input ``x`` of
      micro-batch ``m`` (global stage ``v * S + group.rank``; global
      stage 0 is given ``microbatches[m]``);
    - ``leaves``: the tensors the backward differentiates, ``uses[v]``
      the indices of those chunk ``v`` reads;
    - ``loss_fn(y, m)``: the loss of the last global stage's output of
      micro-batch ``m``; None runs the forward only;
    - ``call(v, thunk)``: runs ``thunk()`` (a forward, or a backward that
      may recompute one) with chunk ``v``'s parameters in place.

    Returns ``(outputs, loss, grads, input_grads)``: the last global
    stage's outputs (a list of M, on the last stage only, forward only),
    the sum of the micro-batch losses (on the last stage; else None),
    one gradient a leaf (summed over micro-batches; None where unused),
    and the gradients of floating ``microbatches`` on global stage 0."""
    from .collective import p2p_exchange
    import time
    S, V, M = n_stages, n_chunks, len(microbatches)
    G, d = S * V, max(group.rank, 0)
    train = loss_fn is not None
    call = call or (lambda v, thunk: thunk())
    ticks = pipeline_ticks(S, V, M, forward_only=not train)
    mine = dict(ticks[d])
    # messages into this rank, by boundary: (kind, global stage, mb)
    incoming = {}
    for e in range(S):
        for t, (kind, m, v) in ticks[e]:
            g = v * S + e
            to = g + 1 if kind == "F" else g - 1
            if 0 <= to < G and to % S == d and (kind == "F" or g > 0):
                incoming.setdefault(t, []).append((kind, to, m, e))
    ranks = group.ranks
    dev = next((t.device for t in list(microbatches) + list(leaves)
                if isinstance(t, torch.Tensor)), torch.device("cpu"))
    _warm_group(group, dev)
    store, inbox, outbox = {}, {}, None
    grads = [None] * len(leaves)
    in_grads = [None] * M
    outputs, loss = [None] * M, None

    def forward(m, v):
        nonlocal loss
        g = v * S + d
        x = microbatches[m] if g == 0 else inbox.pop(("F", g, m))
        x_in = x.detach()
        if train and x_in.is_floating_point():
            x_in.requires_grad_(True)

        def thunk():
            y = fwd(v, x_in, m)
            return y, (loss_fn(y, m) if train and g == G - 1 else None)
        with torch.set_grad_enabled(train):
            y, lm = call(v, thunk)
        if train:
            store[(g, m)] = (x_in, y, lm)
        if g == G - 1:
            if train:
                loss = lm.detach() if loss is None else loss + lm.detach()
            else:
                outputs[m] = y.detach()
            return None
        return ("F", y.detach(), ranks[(g + 1) % S])

    def backward(m, v):
        g = v * S + d
        x_in, y, lm = store.pop((g, m))
        idx = [i for i in uses[v] if leaves[i].requires_grad]
        inputs = [leaves[i] for i in idx]
        if x_in.requires_grad:
            inputs.append(x_in)
        if g == G - 1:
            outs, g_out = [lm], None
        else:
            outs, g_out = [y], [inbox.pop(("B", g, m))]

        def thunk():
            return torch.autograd.grad(outs, inputs, g_out,
                                       allow_unused=True)
        gs = call(v, thunk)
        for i, gi in zip(idx, gs):
            if gi is not None:
                grads[i] = gi if grads[i] is None else grads[i] + gi
        if not x_in.requires_grad:
            return None
        gx = gs[-1] if gs[-1] is not None else torch.zeros_like(x_in)
        if g == 0:
            in_grads[m] = gx
            return None
        return ("B", gx, ranks[(g - 1) % S])

    def exchange(t, out):
        """Boundary ``t``: forward headers first (the receiver sizes its
        buffer from them), then every payload."""
        come = incoming.get(t, [])
        if out is None and not come:
            return
        t0 = time.perf_counter()
        fwd_in = [(to, m, e) for kind, to, m, e in come if kind == "F"]
        sends = [(_header(out[1]), out[2])] \
            if out is not None and out[0] == "F" else []
        heads = [(torch.zeros(_HEADER, dtype=torch.int64, device=dev),
                  ranks[e]) for _, _, e in fwd_in]
        p2p_exchange(sends, heads, group)
        recvs = []
        for (to, m, e), (h, src) in zip(fwd_in, heads):
            buf = _from_header(h.cpu(), dev)
            inbox[("F", to, m)] = buf
            recvs.append((buf, src))
        for kind, to, m, e in come:
            # an integer activation sends no gradient back
            if kind == "B" and store[(to, m)][1].is_floating_point():
                buf = torch.empty_like(store[(to, m)][1])
                inbox[("B", to, m)] = buf
                recvs.append((buf, ranks[e]))
        sends = [(out[1], out[2])] if out is not None else []
        p2p_exchange(sends, recvs, group)
        PIPE_P2P["seconds"] += time.perf_counter() - t0
        for p, _ in sends:
            PIPE_P2P["messages"] += 1
            PIPE_P2P["bytes"] += p.numel() * p.element_size()

    for t in sorted(set(mine) | set(incoming)):
        out = None
        if t in mine:
            kind, m, v = mine[t]
            out = forward(m, v) if kind == "F" else backward(m, v)
        exchange(t, out)
    return outputs, loss, grads, in_grads


def _tree_leaves(tree):
    return [x for _, x in _flatten_with_path(tree)]


def _tree_build(tree, leaves):
    """``tree``'s structure holding ``leaves`` in ``_tree_leaves``
    order."""
    paths = ["/".join(map(str, p)) for p, _ in _flatten_with_path(tree)]
    new = dict(zip(paths, leaves))
    return _map_with_path(lambda path, _: new[path], tree)


def _pipe_group(group):
    if group is not None:
        return group
    from .topology import get_hybrid_communicate_group
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        raise ValueError("no pipe group: pass group= or fleet.init a "
                         "hybrid group with a pp_degree")
    return hcg.get_pipe_parallel_group()


def _schedule(stage_fn, chunk_trees, microbatches, S, V, group, loss_fn):
    """``spmd_pipeline*``'s shared body: ``chunk_trees[v]`` the
    parameter tree of chunk v."""
    from .collective import broadcast
    group = _pipe_group(group)
    if group.nranks != S:
        raise ValueError(f"the pipe group has {group.nranks} ranks, not "
                         f"n_stages ({S})")
    mbs = list(microbatches.unbind(0)) \
        if isinstance(microbatches, torch.Tensor) else list(microbatches)
    leaves, uses = [], []
    for tree in chunk_trees:
        own = [t.detach().requires_grad_(t.is_floating_point()
                                         and loss_fn is not None)
               for t in _tree_leaves(tree)]
        uses.append(list(range(len(leaves), len(leaves) + len(own))))
        leaves += own
    built = [_tree_build(tree, [leaves[i] for i in uses[v]])
             for v, tree in enumerate(chunk_trees)]

    def fwd(v, x, m):
        return stage_fn(built[v], x, m, v)

    outputs, loss, grads, in_grads = run_pipeline(
        fwd, leaves, uses, mbs, S, V, group, loss_fn)
    last = group.ranks[S - 1]
    dev = mbs[0].device
    if loss_fn is None:
        y = torch.stack(outputs) if group.rank == S - 1 else None
        return broadcast_from(y, last, group, dev)
    loss = loss if loss is not None else torch.zeros((), device=dev)
    loss = broadcast(loss.float().contiguous(), src=last, group=group)
    g = [torch.zeros_like(t) if gi is None else gi
         for t, gi in zip(leaves, grads)]
    per_chunk = [_tree_build(tree, [g[i] for i in uses[v]])
                 for v, tree in enumerate(chunk_trees)]
    x_grads = None
    if group.rank == 0 and all(gx is not None for gx in in_grads):
        x_grads = torch.stack(in_grads)
    return loss, per_chunk, x_grads


def spmd_pipeline(stage_fn, stage_params, microbatches, n_stages: int,
                  group=None, loss_fn=None):
    """The reference's ``spmd_pipeline`` on this rank of the pipe group
    ``group`` (default: the hybrid group's), as the 1F1B schedule above.

    ``stage_fn(stage_params, x, microbatch_index) -> y``: this rank's
    stage on its parameters (a tensor or a dict/list tree of them);
    ``microbatches`` (M, mb, ...) or a list of M inputs, read on the first
    stage.  Without ``loss_fn`` the forward only, returning the last
    stage's (M, mb, ...) outputs on every rank (as the reference).  With
    ``loss_fn(y, microbatch_index) -> scalar`` forward and backward,
    returning ``(loss, grads, microbatch_grads)``: the sum of the
    micro-batch losses on every rank, the gradients of ``stage_params``
    (its tree), and on the first stage those of floating
    ``microbatches`` (M, mb, ...) (None elsewhere)."""
    out = _schedule(lambda p, x, m, v: stage_fn(p, x, m), [stage_params],
                    microbatches, n_stages, 1, group, loss_fn)
    if loss_fn is None:
        return out
    loss, per_chunk, x_grads = out
    return loss, per_chunk[0], x_grads


def spmd_pipeline_interleaved(stage_fn, chunk_params, microbatches,
                              n_stages: int, n_chunks: int, group=None,
                              loss_fn=None):
    """The reference's ``spmd_pipeline_interleaved``: this rank holds
    ``n_chunks`` (V) chunks, chunk v being global stage v*S + rank, and
    runs Megatron's interleaved 1F1B (``pipeline_order``).
    ``stage_fn(chunk_local_params, x, microbatch_index, chunk_index)``;
    ``chunk_params`` a tensor or tree whose leaves have leading dim V.
    Returns as :func:`spmd_pipeline`, the gradients with ``chunk_params``'
    leading dim V."""
    S, V = n_stages, n_chunks
    M = (microbatches.shape[0] if isinstance(microbatches, torch.Tensor)
         else len(microbatches))
    if M % S:
        raise ValueError(
            f"n_microbatches ({M}) must be a multiple of the pipeline "
            f"degree ({S}) for the interleaved schedule")
    leaves = _tree_leaves(chunk_params)
    trees = [_tree_build(chunk_params, [a[v] for a in leaves])
             for v in range(V)]
    out = _schedule(stage_fn, trees, microbatches, S, V, group, loss_fn)
    if loss_fn is None:
        return out
    loss, per_chunk, x_grads = out
    stacked = [torch.stack(gs) for gs in zip(*(_tree_leaves(t)
                                                for t in per_chunk))]
    return loss, _tree_build(chunk_params, stacked), x_grads
