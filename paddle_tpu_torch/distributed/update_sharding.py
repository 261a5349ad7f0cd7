"""Automatic cross-replica weight-update sharding for plain data parallel
(counterpart of ``paddle_tpu/distributed/update_sharding.py``;
arXiv:2004.13336).

In vanilla data parallelism every replica all-reduces the full gradient
and runs the SAME optimizer update on the SAME full state.  The all-reduce
factors into reduce-scatter + all-gather and the update is elementwise,
so the update slides between the two halves:

    reduce-scatter grads      -> each replica owns 1/R of the mean grad
    update the 1/R shard      -> optimizer state lives ONLY as shards
    all-gather updated params -> replicas re-converge, bit-identically

Each rank is one replica of the ``axis`` group.  ``policy.reduce_scatter``
is the seam, in WIRE mode: under ``int8_ef`` the one hop before the update
is the int8 ``all_to_all``, and each replica carries its own
error-feedback residual (row r of the reference's ``(R, n)`` stack).

Layouts come from :func:`update_sharding_rules`: params replicated, the
flat ``(n_pad,)`` optimizer slots and ``comm_e`` over ``axis``.  The slots
are FLAT, one fused vector per slot over the whole tree (the ``grad_comm``
flatten, zero-padded so R divides), because the shard boundary cuts
across parameters.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from .grad_comm import _flatten_tree, _tree_size, _unflatten_tree, \
    comm_info, resolve_policy
from .sharding_rules import ShardingRules, make_spec, replicated_spec

__all__ = ["make_dp_update_sharded_train_step", "update_sharding_rules"]


def update_sharding_rules(axis: str = "data") -> ShardingRules:
    """The rule table of this trainer's state layout: flat optimizer
    shards and EF residuals ride the replica axis, everything else
    replicates (scalar exemption keeps (1,) slot leaves replicated)."""
    return ShardingRules(
        [
            (r"^opt/slots(/|$)", make_spec(axis)),
            (r"^comm_e$", make_spec(axis)),
            (r".*", replicated_spec()),
        ],
        unmatched="raise", name=f"dp_update_sharding[{axis}]")


def _reject_unsupported(optimizer):
    """The flat-shard update is only valid for optimizers whose functional
    update is elementwise over the parameter vector."""
    if getattr(optimizer, "_grad_clip", None) is not None:
        raise NotImplementedError(
            "update sharding with grad_clip: the clip norm is GLOBAL over "
            "the gradient tree, but each replica only holds a 1/R shard — "
            "computing it locally would clip by the wrong norm.  Needs a "
            "psum of the local square-sums before the clip; not wired yet.")
    if getattr(optimizer, "_wants_param_name", False) or \
            getattr(optimizer, "_per_tensor_norms", False):
        raise NotImplementedError(
            "update sharding with a per-param-identity rule (Lars/Lamb "
            "trust ratios): the fused flat shard spans parameter "
            "boundaries, so per-param norms are not computable on it.")
    if getattr(optimizer, "_multi_precision", False):
        raise NotImplementedError(
            "update sharding with multi_precision: master-weight slots "
            "need a sharded fp32 authority copy (ZeRO-style); use "
            "make_zero_train_step for that regime.")


def make_dp_update_sharded_train_step(loss_of: Callable,
                                      params0: Dict[str, Any], optimizer,
                                      mesh, axis: str = "data",
                                      donate: bool = True, monitor=None,
                                      grad_comm=None,
                                      replicated_args: tuple = (),
                                      layer=None):
    """Build a plain-DP train step with the weight update sharded over
    ``axis`` (module docstring).

    ``loss_of(params, *batch) -> scalar`` (mean over its rows); every rank
    passes the global batch and takes its rows (``replicated_args``:
    positions that ride whole, such as an RNG key).  Returns ``(step,
    state0)`` with ``step(state, lr, *batch) -> (state, loss)``, the loss
    the cross-replica mean.  ``state["params"]`` is the replicated tree
    (a layer's own parameters when ``params0`` are); ``state["opt"]
    ["slots"]["flat"]`` holds this rank's ``(n_pad / R,)`` slot shards;
    ``state["comm_e"]`` (stateful policy) this replica's ``(1, n_pad)``
    residual row.  ``layer``: the module whose parameters ``loss_of``
    reads, when ``params0`` are not its own."""
    from ..telemetry import instrument_train_step
    from ..telemetry_memory import current_memory_ledger
    from .collective import all_gather_dim
    from .spmd import (_clone_tree, _global_loss, _loss_and_grads, _rows,
                       _Thunk, _trainable)

    policy = resolve_policy(grad_comm)
    _reject_unsupported(optimizer)
    extra = [a for a in mesh.axis_names if a != axis and mesh.shape[a] > 1]
    if extra:
        raise NotImplementedError(
            f"update sharding is the PLAIN data-parallel regime "
            f"(arXiv:2004.13336): mesh has non-trivial axes {extra} beyond "
            f"{axis!r} — use make_zero_train_step / the GSPMD builders for "
            f"hybrid meshes")
    replicated_args = tuple(sorted(set(int(i) for i in replicated_args)))
    group = mesh.axis_group(axis)
    R, me = mesh.shape[axis], mesh.coord[axis]
    n = _tree_size(params0)
    multiple = int(getattr(policy, "block", 1)) * max(R, 1)
    n_pad = -(-n // multiple) * multiple
    shard_len = n_pad // R
    dev = next(iter(params0.values())).device

    flat0, _ = _flatten_tree({k: v.detach() for k, v in params0.items()},
                             multiple, total=n_pad)
    opt0 = optimizer.init_state({"flat": flat0})
    lo, hi = me * shard_len, (me + 1) * shard_len
    opt0["slots"] = {"flat": {k: (v[lo:hi].clone() if v.dim() > 0 else v)
                              for k, v in opt0["slots"]["flat"].items()}}
    state0 = {"params": dict(params0), "opt": opt0}
    if policy.stateful:
        state0["comm_e"] = torch.zeros((1, n_pad), dtype=torch.float32,
                                       device=dev)
    trainable = _trainable(params0, layer)
    holder = _Thunk(layer) if layer is not None else None

    def step(state, lr, *batch):
        if not donate:
            state = _clone_tree(state)
        params = state["params"]
        leaves = {k: (p if holder is not None and p.requires_grad else
                      p.detach().requires_grad_(k in trainable))
                  for k, p in params.items()}
        local = _rows(batch, R, me, skip=replicated_args)
        loss, grads = _loss_and_grads(loss_of, leaves, trainable, holder,
                                      local)
        del leaves
        e = state["comm_e"][0] if policy.stateful else None
        # the paper's first half: this replica's 1/R shard of the MEAN
        # gradient (int8: the one wire hop is the quantized all_to_all)
        g_shard, meta, new_e = policy.reduce_scatter(grads, group, e)
        with torch.no_grad():
            flat_p, _ = _flatten_tree(params, multiple, total=n_pad)
            p_shard = flat_p[lo:hi]
            # the update touches 1/R of the state
            new_sh, new_opt = optimizer.update(
                {"flat": g_shard}, state["opt"], {"flat": p_shard}, lr=lr)
            # the paper's second half: all-gather the updated shards
            flat_new = all_gather_dim(new_sh["flat"], 0, group)
            for k, v in _unflatten_tree(flat_new, meta).items():
                params[k].copy_(v)
            slots = state["opt"]["slots"]["flat"]
            for k, v in new_opt["slots"]["flat"].items():
                if v is not slots[k]:
                    slots[k].copy_(v)
            state["opt"]["step"] = new_opt["step"]
            if policy.stateful:
                state["comm_e"][0].copy_(new_e)
        return state, _global_loss(loss, group, R)

    ml = current_memory_ledger()
    if ml is not None:
        # the flat slot shards land in the ``optimizer_state`` pool, so a
        # census MEASURES the ~R x saving
        ml.register_train_state(state0, name="dp_update_sharded")
    return instrument_train_step(step, monitor, "dp_update_sharded",
                                 comm=comm_info(params0, policy)), state0
