"""Expert-parallel exchange (counterpart of
``paddle_tpu/distributed/utils.py``; reference:
python/paddle/distributed/utils.py ``global_scatter``/``global_gather``).

Two tiers, with the reference's signatures and results:

1. **No counts, or uniform counts** (:func:`global_scatter`,
   :func:`global_gather`): ``x`` is ``world`` equal blocks of rows, block
   w goes to rank w, and the blocks received are concatenated in rank
   order (one all-to-all; the gather is the same exchange).  Ragged
   counts raise and point at the ragged pair, as in the reference.
2. **Ragged counts** (:func:`ragged_global_scatter`,
   :func:`ragged_global_gather`): ``x``'s rows are grouped by destination
   global expert (``local_count`` rows each, expert d on rank ``d //
   El``); the receiver gets its rows in the reference's expert-major
   order (by local expert, then source rank) and ``recv_counts``
   ``(world, El)``.  The reference pads every rank's send to a static
   block, exchanges, and argsorts; here ``torch.distributed``'s
   all-to-all takes split sizes, so the rows move with their counts (two
   exchanges: the counts, then the rows) and a host-side permutation
   orders them.  The counts are read on the host (a host sync a call).
   The output keeps the reference's shape, ``(world * block, H)`` with
   the rows past ``recv_counts.sum()`` zero; the third result is an
   opaque plan for :func:`ragged_global_gather`, as the reference's
   permutation is.

Every function is differentiable: a scatter's gradient goes back by its
gather, and a gather's by its scatter.  ``group`` is a ``collective.
Group``, an axis name of the active hybrid group, or None (the hybrid
group's data axis, else the world).  Under gloo a CUDA operand goes
through pinned host copies (``collective._GLOO_HOST_STAGED``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import collective as C

__all__ = ["global_scatter", "global_gather",
           "ragged_global_scatter", "ragged_global_gather"]


def _resolve_group(group):
    """A ``Group`` from ``group`` (module docstring)."""
    if group is not None and not isinstance(group, str):
        return group
    from .topology import get_hybrid_communicate_group
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        if group not in (None, "data"):
            raise ValueError(f"no hybrid group names the axis {group!r}")
        return C._get_default_group()
    return hcg.mesh.axis_group(group or "data")


def _host_counts(counts):
    """Counts as a host int64 array (a device tensor is synced)."""
    if isinstance(counts, torch.Tensor):
        counts = counts.detach().cpu().numpy()
    return np.asarray(counts).astype(np.int64)


# --------------------------------------------------------------------------
# tier 1: uniform blocks
# --------------------------------------------------------------------------

def _check_uniform(local_count, global_count):
    for name, counts in (("local_count", local_count),
                         ("global_count", global_count)):
        if counts is not None and np.unique(_host_counts(counts)).size > 1:
            raise ValueError(
                f"ragged {name} passed to global_scatter/global_gather; use "
                f"the ragged_global_scatter/ragged_global_gather pair, which "
                f"returns the receive counts and permutation the gather-back "
                f"needs")


def global_scatter(x, local_count=None, global_count=None, group=None,
                   use_calc_stream=True):
    """Send each rank's blocks of rows to their ranks: ``x`` (rows, H) is
    ``world`` equal blocks, block w goes to rank w, and the result holds
    the blocks received, in rank order.  No counts or uniform counts run
    this exchange; ragged counts raise (use the ragged pair)."""
    _check_uniform(local_count, global_count)
    g = _resolve_group(group)
    world = g.nranks
    if x.shape[0] % world:
        raise ValueError(f"global_scatter rows ({x.shape[0]}) must be a "
                         f"multiple of the '{g.axis_name}' axis size "
                         f"({world})")
    return C.all_to_all_along(x, 0, 0, g)


def global_gather(x, local_count=None, global_count=None, group=None,
                  use_calc_stream=True):
    """The inverse of :func:`global_scatter` (the same exchange); for the
    ragged tier use :func:`ragged_global_gather`."""
    return global_scatter(x, local_count, global_count, group,
                          use_calc_stream)


# --------------------------------------------------------------------------
# tier 2: ragged counts
# --------------------------------------------------------------------------

class _RaggedPlan:
    """What a ragged scatter's gather needs: the rows sent to each rank,
    the rows received from each, the expert-major order of the received
    rows (``order[i]`` is the arrival index of output row i), the padded
    output length and the group."""

    def __init__(self, send, recv, order, padded, group):
        self.send, self.recv = send, recv
        self.order, self.padded, self.group = order, padded, group


def _to_experts(x, plan, padded):
    """Rows grouped by destination → this rank's expert-major rows,
    padded with zeros to ``padded`` rows."""
    got = C.all_to_all_uneven(x, plan.send, plan.recv, plan.group)
    order = torch.as_tensor(plan.order, dtype=torch.long, device=x.device)
    out = x.new_zeros((padded,) + tuple(x.shape[1:]))
    out[:len(plan.order)] = got[order]
    return out


def _to_sources(y, plan, rows):
    """The inverse: expert-major rows back to the ranks and positions they
    came from; ``rows`` rows a rank, zero past the rows it sent."""
    n = len(plan.order)
    arrival = y.new_empty((n,) + tuple(y.shape[1:]))
    order = torch.as_tensor(plan.order, dtype=torch.long, device=y.device)
    arrival[order] = y[:n]
    back = C.all_to_all_uneven(arrival, plan.recv, plan.send, plan.group)
    out = y.new_zeros((rows,) + tuple(y.shape[1:]))
    out[:back.shape[0]] = back
    return out


class _RaggedScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan, ctx.rows = plan, x.shape[0]
        return _to_experts(x, plan, plan.padded)

    @staticmethod
    def backward(ctx, g):
        return _to_sources(g, ctx.plan, ctx.rows), None


class _RaggedGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, plan, rows):
        ctx.plan, ctx.padded = plan, y.shape[0]
        return _to_sources(y, plan, rows)

    @staticmethod
    def backward(ctx, g):
        return _to_experts(g, ctx.plan, ctx.padded), None, None


def ragged_global_scatter(x, local_count, group=None,
                          block: Optional[int] = None):
    """The reference's ragged scatter: ``x`` (T, H) holds this rank's rows
    grouped by destination global expert, ``local_count[d]`` rows for
    expert d (``world * El`` entries).  Returns ``(out, recv_counts,
    plan)``: ``out`` (world * B, H), B = ``block`` or T, the rows received
    in expert-major order (by local expert, then source rank) and zero
    past ``recv_counts.sum()``; ``recv_counts`` (world, El) int64 on
    ``x``'s device, the rows each source rank sent for each local expert;
    ``plan`` for :func:`ragged_global_gather`.  A ``block`` smaller than
    the rows this rank sends to one rank raises, as in the reference."""
    g = _resolve_group(group)
    W = g.nranks
    T = x.shape[0]
    lc = _host_counts(local_count)
    El = lc.shape[0] // W
    lc = lc.reshape(W, El)
    if block is not None and block < T:
        rank_max = int(lc.sum(1).max())
        if rank_max > block:
            raise ValueError(
                f"block={block} smaller than the largest per-rank send "
                f"({rank_max}) — tokens would be dropped")
    B = T if block is None else block
    counts = torch.as_tensor(lc, dtype=torch.int64, device=x.device)
    recv_counts = C.all_to_all_rows(counts, g) if W > 1 else counts.clone()
    rc = _host_counts(recv_counts)
    # arrival order: source-major, each source's rows by its destination
    # expert; the output wants expert-major, then source
    starts = np.concatenate([[0], np.cumsum(rc.reshape(-1))[:-1]]) \
        .reshape(W, El)
    order = np.concatenate([np.arange(starts[w, e], starts[w, e] + rc[w, e])
                            for e in range(El) for w in range(W)]
                           ).astype(np.int64)
    plan = _RaggedPlan(lc.sum(1).tolist(), rc.sum(1).tolist(), order, W * B,
                       g)
    return _RaggedScatter.apply(x, plan), recv_counts, plan


def ragged_global_gather(y, local_count, perm, rows: int, group=None):
    """The inverse of :func:`ragged_global_scatter`: ``y`` (world * B, H)
    in the scatter's expert-major order, ``perm`` its plan; returns
    (``rows``, H) in the scatter input's layout, zero past the rows this
    rank sent.  ``local_count`` and ``group`` are the scatter's (the plan
    carries both)."""
    if not isinstance(perm, _RaggedPlan):
        raise TypeError("perm must be the plan ragged_global_scatter "
                        "returned")
    return _RaggedGather.apply(y, perm, int(rows))
