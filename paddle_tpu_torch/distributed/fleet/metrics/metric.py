"""Distributed metric reductions (counterpart of
``paddle_tpu/distributed/fleet/metrics/metric.py``; reference:
fleet/metrics/metric.py — all-reduced global metrics over the worker
group).

The reduction is ``collective.all_reduce`` over the default group (the
identity in a single process).  ``all_reduce_metrics`` batches a whole
dict of step metrics into ONE collective per reduction op: the values pack
into one float64 vector (on the current card under NCCL, on the CPU
otherwise), reduce once, and unpack by key.

The reference-parity functions intentionally shadow the ``sum``/``max``/
``min`` builtins (``fleet.metrics.sum`` IS the API); internal code uses
``builtins.*``.
"""

from __future__ import annotations

import builtins
from typing import Dict, Mapping

import numpy as np


def _np(x):
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def _allreduce(value, op="sum"):
    import torch
    from ... import env
    from ...collective import ReduceOp, all_reduce
    ops = {"sum": ReduceOp.SUM, "max": ReduceOp.MAX, "min": ReduceOp.MIN}
    dev = "cuda" if env.get_backend() == "nccl" else "cpu"
    t = torch.as_tensor(np.asarray(value, np.float64), device=dev)
    return all_reduce(t, op=ops[op]).cpu().numpy()


def all_reduce_metrics(metrics: Mapping[str, float], op: str = "sum"
                       ) -> Dict[str, float]:
    """Reduce a whole dict of scalar metrics with ONE collective: values
    pack into a single vector, reduce once, unpack by key.  Identity in a
    single process.  Used by ``telemetry.TrainMonitor.aggregate()`` and
    ``telemetry_ledger.RunLedger.aggregate()`` for global throughput
    (``op="sum"``) and straggler wall time (``op="max"``)."""
    if not metrics:
        return {}
    # goodput seam: this collective's wall is ``comm`` time on the active
    # ledger
    from ....telemetry_ledger import ledger_span
    with ledger_span("comm"):
        keys = list(metrics)
        vec = np.asarray([float(metrics[k]) for k in keys], np.float64)
        out = np.asarray(_allreduce(vec, op), np.float64).reshape(-1)
        return {k: float(v) for k, v in zip(keys, out)}


def sum(input, scope=None, util=None):
    return float(_allreduce(_np(input).sum(), "sum"))


def max(input, scope=None, util=None):
    return float(_allreduce(_np(input).max(), "max"))


def min(input, scope=None, util=None):
    return float(_allreduce(_np(input).min(), "min"))


def mean(input, scope=None, util=None):
    total = _allreduce(np.array([_np(input).sum(), _np(input).size]), "sum")
    return float(total[0] / builtins.max(total[1], 1))


def acc(correct, total, scope=None, util=None):
    agg = _allreduce(np.array([_np(correct).sum(), _np(total).sum()]), "sum")
    return float(agg[0] / builtins.max(agg[1], 1e-12))


def mae(abserr, total_ins_num, scope=None, util=None):
    agg = _allreduce(np.array([_np(abserr).sum(), float(total_ins_num)]), "sum")
    return float(agg[0] / builtins.max(agg[1], 1e-12))


def mse(sqrerr, total_ins_num, scope=None, util=None):
    agg = _allreduce(np.array([_np(sqrerr).sum(), float(total_ins_num)]), "sum")
    return float(agg[0] / builtins.max(agg[1], 1e-12))


def rmse(sqrerr, total_ins_num, scope=None, util=None):
    return float(np.sqrt(mse(sqrerr, total_ins_num)))


def auc(stat_pos, stat_neg, scope=None, util=None):
    """Global AUC from the threshold-bucket stats (reference metric.py:144)."""
    pos = _allreduce(_np(stat_pos), "sum")
    neg = _allreduce(_np(stat_neg), "sum")
    # walk buckets high→low accumulating the trapezoid area
    tot_pos = tot_neg = 0.0
    area = 0.0
    for b in range(len(pos) - 1, -1, -1):
        new_pos = tot_pos + pos[b]
        new_neg = tot_neg + neg[b]
        area += (new_neg - tot_neg) * (tot_pos + new_pos) / 2.0
        tot_pos, tot_neg = new_pos, new_neg
    if tot_pos == 0 or tot_neg == 0:
        return 0.5
    return float(area / (tot_pos * tot_neg))
