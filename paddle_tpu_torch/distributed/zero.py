"""ZeRO sharding (stages 1-3) with contractual semantics (counterpart of
``paddle_tpu/distributed/zero.py``).

The contract per stage, over the "sharding" axis of a data × sharding
mesh (one process per rank; each rank holds the shards the reference's
device at its mesh position holds):

- stage 1: optimizer state (slots + fp32 master weights) sharded 1/N over
  "sharding" along the dim the reference's spec names
  (``sharding_rules._slot_spec``); the gradients are all-reduced, each
  rank updates its shard and the parameters are all-gathered.
- stage 2: + gradients reduce-scattered into the slot layout (summed over
  the data group, reduce-scattered over the sharding group).
- stage 3: + parameters stored sharded; all-gathered for the forward and
  the backward, the gathered copies freed after the step.  The state's
  parameter shards are copies: a layer's own parameter that stage 3
  shards is read by no step and keeps its initial value (``gather_full``
  of the state's shards gives the trained one).

Every shard lives in storage of its own (``sharding_rules.local_shard``),
so a rank holds ~1/N of each sharded tensor's bytes and
``per_device_state_bytes`` is what the device holds for the state.

Update ordering (one step): scaled loss → grads → unscale → found_inf
(any non-finite in the reduced gradient, MAX-reduced over the world so a
skipped step is skipped on every rank) → grad_comm (local mode) →
[optimizer's clip over whole tensors] → update → select old/new state by
found_inf → loss-scale update.  The step counter and loss-scale
bookkeeping only advance on finite steps.

Tensors with no dimension divisible by the sharding degree stay replicated
and are WARNED about with a byte count, as in the reference.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Any, Callable, Dict, Optional

import torch

from .checkpoint import Layout
from .sharding_rules import (_slot_spec, build_param_specs, local_shard,
                             replicated_spec, resolve_flat_shard_spec,
                             spec_shards)

_HALF_DTYPES = (torch.bfloat16, torch.float16)


def _warn_unsharded(kind: str, failures, degree: int):
    if not failures:
        return
    total = sum(b for _, b in failures)
    names = ", ".join(n for n, _ in failures[:5])
    warnings.warn(
        f"ZeRO: {len(failures)} {kind} tensor(s) have no dim divisible by "
        f"sharding degree {degree} and stay fully replicated "
        f"({total / 1e6:.2f} MB per device): {names}"
        + (", ..." if len(failures) > 5 else ""))


def zero_state_specs(params0: Dict[str, Any], mesh, layer=None,
                     zero_stage: int = 1):
    """(param_specs, slot_specs) for the stage, with replication
    accounting."""
    p_specs = build_param_specs(params0, mesh, layer, zero_stage)
    s_specs = {k: _slot_spec(p_specs[k], p, mesh, max(zero_stage, 1))
               for k, p in params0.items()}
    deg = mesh.shape.get("sharding", 1)
    if deg > 1:
        def nbytes(p):
            return int(p.numel()) * p.element_size()
        _warn_unsharded("optimizer-state", [
            (k, nbytes(p)) for k, p in params0.items()
            if "sharding" not in s_specs[k]], deg)
        if zero_stage >= 3:
            _warn_unsharded("parameter", [
                (k, nbytes(p)) for k, p in params0.items()
                if "sharding" not in p_specs[k]], deg)
    return p_specs, s_specs


def _as_mesh(mesh):
    """``mesh``, or a one-rank mesh for None."""
    if mesh is not None:
        return mesh
    from .topology import HYBRID_AXES, ProcessMesh
    return ProcessMesh(HYBRID_AXES, (1,) * len(HYBRID_AXES))


def make_zero_train_step(loss_of: Callable, params0: Dict[str, Any], optimizer,
                         mesh, layer=None, zero_stage: int = 1,
                         master_weights: Optional[bool] = None,
                         dynamic_loss_scale: bool = False,
                         init_loss_scale: float = 2.0 ** 15,
                         growth_interval: int = 1000,
                         backoff_factor: float = 0.5,
                         growth_factor: float = 2.0,
                         donate: bool = True,
                         offload: bool = False,
                         monitor=None,
                         grad_comm=None):
    """Build the sharded train step.

    ``loss_of(params, *batch) -> scalar``.  Returns ``(step, state0)`` with
    ``step(state, lr, *batch) -> (state, loss)``.  state = {params, opt,
    master, scaler}; scaler = {scale, good_steps, found_inf} (found_inf
    from the LAST step).  Every rank passes the global batch.

    ``grad_comm``: the policy, applied in local mode to the unscaled fp32
    mean gradient; a stateful policy adds a flat ``"comm_e"`` residual,
    sharded over "sharding" when its length divides (a non-fp32 policy
    acts on the whole mean gradient, so stage 2 then all-reduces and keeps
    its shard: ``ROADMAP.md`` §C).

    ``offload=True`` routes through ``make_zero_offload_train_step``.

    ``step.layout`` is the checkpoint ``Layout`` of the state as this
    builder shards it, ``comm_e`` included
    (``distributed.checkpoint.save/load(shardings=)``; the reference's
    state arrays carry it as their ``NamedSharding``s).
    """
    from ..telemetry import instrument_train_step
    from .grad_comm import comm_info, resolve_policy
    from .spmd import _make_mesh_step
    policy = resolve_policy(grad_comm)
    if offload and policy.name != "fp32":
        raise NotImplementedError(
            "offload=True with grad_comm != 'fp32' is not wired: the "
            "offload path's wire is PCIe (host<->device), not the "
            "interconnect — compressing it is a different policy axis")
    mesh = _as_mesh(mesh)
    if offload:
        if dynamic_loss_scale:
            raise NotImplementedError(
                "offload=True with dynamic_loss_scale is not supported; "
                "use static scaling (the offload path keeps found_inf "
                "skip-update semantics)")
        return make_zero_offload_train_step(
            loss_of, params0, optimizer, mesh, layer=layer,
            zero_stage=zero_stage, master_weights=master_weights,
            monitor=monitor)
    if master_weights is None:
        master_weights = any(p.dtype in _HALF_DTYPES
                             for p in params0.values())
    p_specs, s_specs = zero_state_specs(params0, mesh, layer, zero_stage)
    half_keys = {k for k, p in params0.items() if p.dtype in _HALF_DTYPES} \
        if master_weights else set()
    comm_spec = None
    if policy.stateful:
        length = int(policy.residual_for(params0, device="meta").shape[0])
        comm_spec = resolve_flat_shard_spec(
            "comm_e", length, mesh, "sharding",
            tracer=getattr(monitor, "tracer", None))
    step, state0 = _make_mesh_step(
        loss_of, params0, optimizer, mesh, layer, p_specs, s_specs, policy,
        donate, comm_spec=comm_spec,
        zero={"master_keys": half_keys, "dynamic": dynamic_loss_scale,
              "init_scale": init_loss_scale,
              "growth_interval": growth_interval,
              "backoff": backoff_factor, "growth": growth_factor,
              "stage": zero_stage})
    step.layout = _state_layout(state0, p_specs, s_specs, comm_spec, mesh)
    return instrument_train_step(step, monitor, "zero",
                                 comm=comm_info(params0, policy)), state0


def make_zero_offload_train_step(loss_of: Callable, params0: Dict[str, Any],
                                 optimizer, mesh, layer=None,
                                 zero_stage: int = 1,
                                 master_weights: Optional[bool] = None,
                                 monitor=None):
    """Offload variant (≙ the reference's sharding_configs ``offload``):
    the optimizer slots and an fp32 master of every parameter live in
    host memory (pinned when the parameters are on a card); each step
    reduces the gradients on the device, copies them host-ward, runs the
    update on the CPU, and copies the parameters back.  As in the
    reference the host state is whole on every rank (not sharded).  The
    forward runs in the mesh step's scope (``spmd._local_rows``): batch
    statistics over the batch ranks, a draw as the rank's rows of the
    global draw.
    state = {params(dev), opt(host), master(host), scaler(host)};
    ``step.layout`` as ``make_zero_train_step``'s."""
    del master_weights  # always master-weighted: the host keeps THE fp32
    # copy of every parameter, so no step fetches parameters from device
    from ..telemetry import instrument_train_step
    from ..core import rng
    from .spmd import (_draw_refusal, _found_inf, _global_loss,
                       _local_rows, _mean_all, _rank_loss_and_grads, _Thunk,
                       _trainable)
    mesh = _as_mesh(mesh)
    p_specs, _ = zero_state_specs(params0, mesh, layer, zero_stage)
    p_split = {n: spec_shards(p_specs[n], mesh) for n in params0}
    dev = next(iter(params0.values())).device
    pin = dev.type == "cuda"

    def host(t):
        h = t.detach().to("cpu", copy=True)
        return h.pin_memory() if pin else h

    master0 = {k: host(p.float()) for k, p in params0.items()}
    opt0 = optimizer.init_state(master0)
    opt0["slots"] = {n: {k: host(v) for k, v in s.items()}
                     for n, s in opt0["slots"].items()}
    state0 = {
        "params": {n: (local_shard(p.detach(), p_specs[n], mesh)
                       if p_split[n] else p) for n, p in params0.items()},
        "opt": opt0,
        "master": master0,
        "scaler": {"scale": torch.ones((), dtype=torch.float32),
                   "good_steps": torch.zeros((), dtype=torch.int32),
                   "found_inf": torch.zeros((), dtype=torch.bool)},
    }
    group, _ = mesh.batch_group()
    R = group.nranks
    trainable = _trainable(params0, layer)
    holder = _Thunk(layer) if layer is not None else None
    draw_refusal = _draw_refusal(mesh)
    local = _local_rows(mesh, draw_refusal)

    def step(state, lr, *batch):
        with (rng.refuse_draws(draw_refusal) if draw_refusal
              else contextlib.nullcontext()):
            loss, grads = _rank_loss_and_grads(
                loss_of, state["params"], p_specs, p_split, mesh, holder,
                trainable, batch, local=local)
        grads = _mean_all({n: g.float() for n, g in grads.items()}, group, R)
        found_inf = _found_inf(grads, group)
        with torch.no_grad():
            g_host = {n: g.to("cpu") for n, g in grads.items()}
            found_inf = found_inf.to("cpu")
            master = state["master"]
            upd = {n: master[n] for n in trainable}
            new_upd, new_opt = optimizer.update(
                g_host, {"step": state["opt"]["step"],
                         "slots": {n: state["opt"]["slots"][n]
                                   for n in trainable}}, upd, lr=lr)
            for n, v in new_upd.items():
                master[n].copy_(torch.where(found_inf, master[n], v))
            slots = state["opt"]["slots"]
            for n, s in new_opt["slots"].items():
                for k, v in s.items():
                    slots[n][k].copy_(torch.where(found_inf, slots[n][k], v))
            state["opt"]["step"] = torch.where(
                found_inf, state["opt"]["step"], new_opt["step"])
            for n in trainable:
                p = state["params"][n]
                v = master[n]
                if p_split[n]:
                    v = local_shard(v, p_specs[n], mesh)
                p.copy_(v)
            state["scaler"]["found_inf"] = found_inf
        return state, _global_loss(loss, group, R)

    rep = replicated_spec()
    step.layout = _state_layout(state0, p_specs, {n: rep for n in params0},
                                None, mesh)
    return instrument_train_step(step, monitor, "zero_offload"), state0


def _state_layout(state, p_specs, s_specs, comm_spec, mesh):
    """The checkpoint ``Layout`` of a state the builders above made: each
    leaf's spec as the step shards it."""
    rep = replicated_spec()
    specs = {"params": {n: p_specs[n] for n in state["params"]},
             "opt": {"step": rep, "slots": {
                 n: {k: (s_specs[n] if v.dim() > 0 else rep)
                     for k, v in s.items()}
                 for n, s in state["opt"]["slots"].items()}},
             "scaler": {k: rep for k in state["scaler"]},
             "master": {k: s_specs[k] for k in state["master"]}}
    if "comm_e" in state:
        specs["comm_e"] = comm_spec
    return Layout(specs, mesh)


def per_device_state_bytes(state) -> int:
    """Bytes of this rank's optimizer state (slots + master): the local
    shards — the reference's ``addressable_shards[0]`` of every leaf on
    device 0, here on each rank; the quantity ZeRO shrinks ~1/shard."""
    total = 0

    def walk(tree):
        nonlocal total
        if isinstance(tree, torch.Tensor):
            total += int(tree.numel()) * tree.element_size()
        elif isinstance(tree, dict):
            for v in tree.values():
                walk(v)

    walk({"opt": state["opt"]["slots"], "master": state.get("master", {})})
    return total

