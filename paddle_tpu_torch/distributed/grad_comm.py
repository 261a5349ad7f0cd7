"""Quantized gradient collectives — the pluggable grad-comm policy layer
(counterpart of ``paddle_tpu/distributed/grad_comm.py``).

The choice of wire format for the data-parallel gradient exchange is a
POLICY:

``fp32``     full-precision mean reduction.  The default.
``bf16``     cast -> reduce -> cast back: a 2x traffic cut.
``int8_ef``  EQuARX-style block-quantized reduction
             (https://arxiv.org/pdf/2506.17615): per-block fp32 scales +
             an int8 payload, composed over a process group as

                 quantize -> all_to_all (int8)        # shard exchange
                 -> dequantize-accumulate in fp32     # local reduce
                 -> requantize -> all_gather (int8)   # result broadcast
                 -> dequantize

             with an error-feedback residual carrying each replica's
             quantization error into the next step.

Two application modes, as in the reference:

- **wire mode** (``all_reduce``/``reduce_scatter`` with a process
  ``group``, a ``collective.Group``): the composition above runs on
  ``torch.distributed`` and the collectives move quantized bytes.
  ``compressed_all_reduce``/``compressed_reduce_scatter`` and the
  update-sharded trainer use this mode.
- **local mode** (``apply_local``): the same pipeline with R=1 on an
  already mean-reduced fp32 gradient.  The DP, ZeRO and sharded-init
  trainers use it, as the reference's GSPMD trainers do: the policy sets
  the numbers and the byte count, and no int8 goes on the wire there
  (``ROADMAP.md`` §C).

Byte accounting (``wire_bytes``) is the reference's logical
ring-all-reduce model: fp32 ``2 * 4N``, bf16 ``2 * 2N``, int8_ef
``2 * (N + 4 * ceil(N / block))``.

A tree is nested dicts (keys in sorted order, as the reference flattens
them), lists and tuples of tensors; the flat vector concatenates its
leaves in that order, as fp32, zero-padded — the layout the reference's
``_flatten_tree`` gives, so flat state matches it element for element.
The block quantizer is plain PyTorch (the reference's is plain JAX).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

__all__ = [
    "DEFAULT_BLOCK", "GradCommPolicy", "Fp32Policy", "Bf16Policy",
    "Int8EfPolicy", "POLICIES", "resolve_policy",
    "compressed_all_reduce", "compressed_reduce_scatter", "tree_from_shards",
    "quantize_blocks", "dequantize_blocks", "ef_accumulate", "ef_residual",
    "wire_bytes", "comm_info", "apply_policy_local",
]

DEFAULT_BLOCK = 256

_QMAX = 127.0  # symmetric int8: levels in [-127, 127]


# --------------------------------------------------------------------------
# error-feedback primitives
# --------------------------------------------------------------------------

def ef_accumulate(residual, update):
    """``v = residual + update`` (``residual`` None passes ``update``)."""
    if residual is None:
        return update
    return residual + update


def ef_residual(v, sent):
    """``e' = v - sent``: what was accumulated minus what went on the wire
    (the DECOMPRESSED payload)."""
    return v - sent


# --------------------------------------------------------------------------
# block quantization
# --------------------------------------------------------------------------

def quantize_blocks(x, block: int = DEFAULT_BLOCK):
    """Symmetric per-block int8 quantization over the LAST dimension:
    ``(q, scales)`` with ``scale = max|block| / 127`` (all-zero blocks get
    scale 1.0) — the reference's arithmetic, bit for bit."""
    shape = tuple(x.shape)
    if not shape or shape[-1] % block:
        raise ValueError(f"last dim {shape[-1] if shape else None} not a "
                         f"multiple of {block}")
    xb = x.reshape(shape[:-1] + (shape[-1] // block, block)).float()
    amax = xb.abs().amax(-1)
    scales = torch.where(amax > 0, amax / _QMAX, torch.ones_like(amax))
    q = torch.clamp(torch.round(xb / scales[..., None]), -_QMAX, _QMAX)
    return q.to(torch.int8).reshape(shape), scales


def dequantize_blocks(q, scales, block: int = DEFAULT_BLOCK):
    """Inverse of :func:`quantize_blocks`; fp32 with ``q``'s shape."""
    shape = tuple(q.shape)
    qb = q.reshape(shape[:-1] + (shape[-1] // block, block)).float()
    return (qb * scales[..., None]).reshape(shape)


# --------------------------------------------------------------------------
# tree <-> padded flat vector
# --------------------------------------------------------------------------

class TreeMeta(NamedTuple):
    treedef: Any
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[Any, ...]
    n: int
    n_pad: int


def _leaves(tree):
    """(treedef, leaves): dict keys sorted, lists/tuples in order."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        defs, out = [], []
        for k in keys:
            d, ls = _leaves(tree[k])
            defs.append(d)
            out += ls
        return ("dict", tuple(keys), tuple(defs)), out
    if isinstance(tree, (list, tuple)):
        defs, out = [], []
        for v in tree:
            d, ls = _leaves(v)
            defs.append(d)
            out += ls
        return (type(tree), len(tree), tuple(defs)), out
    return None, [tree]


def _unleaves(treedef, leaves):
    it = iter(leaves)

    def build(d):
        if d is None:
            return next(it)
        if d[0] == "dict":
            return {k: build(sub) for k, sub in zip(d[1], d[2])}
        return d[0](build(sub) for sub in d[2])

    return build(treedef)


def _tree_size(tree) -> int:
    total = 0
    for leaf in _leaves(tree)[1]:
        n = 1
        for s in getattr(leaf, "shape", ()):
            n *= int(s)
        total += n
    return total


def _flatten_tree(tree, multiple: int, total: Optional[int] = None):
    """All leaves (as fp32) concatenated into one flat vector zero-padded
    to ``total`` elements (or the next multiple of ``multiple``)."""
    treedef, leaves = _leaves(tree)
    if not leaves:
        raise ValueError("grad_comm: empty tree")
    shapes = tuple(tuple(l.shape) for l in leaves)
    dtypes = tuple(l.dtype for l in leaves)
    parts = [l.reshape(-1).float() for l in leaves]
    flat = parts[0] if len(parts) == 1 else torch.cat(parts)
    n = flat.shape[0]
    n_pad = total if total is not None else -(-n // multiple) * multiple
    if n_pad < n or n_pad % multiple:
        raise ValueError(
            f"grad_comm: residual/pad length {n_pad} incompatible with tree "
            f"size {n} and multiple {multiple} — was the residual built for "
            f"a different tree or axis size?")
    if n_pad > n:
        flat = torch.cat([flat, flat.new_zeros(n_pad - n)])
    return flat, TreeMeta(treedef, shapes, dtypes, n, n_pad)


def _unflatten_tree(flat, meta: TreeMeta):
    out, off = [], 0
    for shape, dt in zip(meta.shapes, meta.dtypes):
        size = 1
        for s in shape:
            size *= s
        out.append(flat[off:off + size].reshape(shape).to(dt))
        off += size
    return _unleaves(meta.treedef, out)


def _group_size(group) -> int:
    return 1 if group is None else group.nranks


# --------------------------------------------------------------------------
# policies
# --------------------------------------------------------------------------

class GradCommPolicy:
    """Base policy: fp32 (the reference's contract, over a process group):

    - ``all_reduce(tree, group, residual)`` -> ``(mean_tree, residual')``;
    - ``reduce_scatter(tree, group, residual)`` -> ``(shard, meta,
      residual')``: this rank's ``1/R`` contiguous fp32 shard of the
      flattened mean;
    - ``apply_local(tree, residual)`` -> ``(tree', residual')``: the R=1
      composition, no collectives;
    - ``residual_for(tree, axis_size)``: zeros of the flat padded residual
      (None for stateless policies);
    - ``wire_bytes(tree)`` -> ``(pre, post)``.
    """

    name = "fp32"
    stateful = False

    def all_reduce(self, tree, group, residual=None):
        from .collective import ReduceOp, all_reduce
        R = _group_size(group)
        if R <= 1:
            return tree, residual
        flat, meta = _flatten_tree(tree, 1)
        all_reduce(flat, ReduceOp.SUM, group)
        return _unflatten_tree(flat / R, meta), residual

    def reduce_scatter(self, tree, group, residual=None):
        from .collective import reduce_scatter_dim
        R = _group_size(group)
        flat, meta = _flatten_tree(tree, max(R, 1))
        shard = reduce_scatter_dim(flat, 0, group) if R > 1 else flat
        return shard / R, meta, residual

    def apply_local(self, tree, residual=None):
        return tree, residual

    def residual_for(self, tree, axis_size: int = 1):
        return None

    def wire_bytes(self, tree) -> Tuple[int, int]:
        n = _tree_size(tree)
        return 8 * n, 8 * n


class Bf16Policy(GradCommPolicy):
    """Cast -> reduce -> cast back: every hop moves bf16; the reduction
    accumulates in bf16, as in the reference."""

    name = "bf16"

    def all_reduce(self, tree, group, residual=None):
        from .collective import ReduceOp, all_reduce
        R = _group_size(group)
        flat, meta = _flatten_tree(tree, 1)
        h = flat.to(torch.bfloat16)
        if R > 1:
            all_reduce(h, ReduceOp.SUM, group)
        mean = (h / R).to(torch.bfloat16).float()
        return _unflatten_tree(mean, meta), residual

    def reduce_scatter(self, tree, group, residual=None):
        from .collective import reduce_scatter_dim
        R = _group_size(group)
        flat, meta = _flatten_tree(tree, max(R, 1))
        h = flat.to(torch.bfloat16)
        shard = reduce_scatter_dim(h, 0, group) if R > 1 else h
        return shard.float() / R, meta, residual

    def apply_local(self, tree, residual=None):
        treedef, leaves = _leaves(tree)
        return _unleaves(treedef, [t.to(torch.bfloat16).to(t.dtype)
                                   for t in leaves]), residual

    def wire_bytes(self, tree):
        n = _tree_size(tree)
        return 8 * n, 4 * n


class Int8EfPolicy(GradCommPolicy):
    """EQuARX-style block-quantized all-reduce with error feedback."""

    name = "int8_ef"
    stateful = True

    def __init__(self, block: int = DEFAULT_BLOCK):
        if block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        self.block = int(block)

    def _padded(self, n: int, R: int) -> int:
        m = self.block * max(R, 1)
        return -(-n // m) * m

    def residual_for(self, tree, axis_size: int = 1, device=None):
        if device is None:
            leaves = _leaves(tree)[1]
            device = leaves[0].device if leaves else "cpu"
        return torch.zeros((self._padded(_tree_size(tree), axis_size),),
                           dtype=torch.float32, device=device)

    def _exchange(self, v, group):
        """The quantized exchange on a padded flat vector ``v``: ``(mean_hat,
        mean_shard, sent, (q1, s1), (q2, s2))`` — ``sent`` the dequantized
        OWN contribution, ``mean_shard`` the local fp32 reduced shard, and
        the two int8 hops' payloads and scales."""
        from .collective import all_gather_dim, all_to_all_rows
        R = _group_size(group)
        shard = v.shape[0] // R
        v2 = v.reshape(R, shard)
        q1, s1 = quantize_blocks(v2, self.block)
        if R > 1:
            # hop 1 (int8): row r is this replica's contribution to replica
            # r's shard; the all_to_all lands every contribution to ours
            qx = all_to_all_rows(q1, group)
            sx = all_to_all_rows(s1, group)
        else:
            qx, sx = q1, s1
        # local reduce in fp32, rows summed in replica order
        deq = dequantize_blocks(qx, sx, self.block)
        acc = deq[0]
        for r in range(1, R):
            acc = acc + deq[r]
        mean_shard = acc / R
        q2, s2 = quantize_blocks(mean_shard, self.block)
        if R > 1:
            # hop 2 (int8): broadcast the requantized mean shards
            qg = all_gather_dim(q2[None], 0, group)
            sg = all_gather_dim(s2[None], 0, group)
        else:
            qg, sg = q2[None], s2[None]
        mean_hat = dequantize_blocks(qg, sg, self.block).reshape(-1)
        sent = dequantize_blocks(q1, s1, self.block).reshape(-1)
        return mean_hat, mean_shard, sent, (q1, s1), (q2, s2)

    def _run(self, tree, group, residual):
        R = _group_size(group)
        flat, meta = _flatten_tree(
            tree, self.block * R,
            total=residual.shape[0] if residual is not None else None)
        v = ef_accumulate(residual, flat)
        mean_hat, mean_shard, sent, _, _ = self._exchange(v, group)
        return meta, mean_hat, mean_shard, ef_residual(v, sent)

    def all_reduce(self, tree, group, residual=None):
        meta, mean_hat, _, new_e = self._run(tree, group, residual)
        return _unflatten_tree(mean_hat, meta), new_e

    def reduce_scatter(self, tree, group, residual=None):
        # stops at the local fp32 shard: the only wire hop is the int8
        # all_to_all (the ZeRO-2 seam)
        meta, _, mean_shard, new_e = self._run(tree, group, residual)
        return mean_shard, meta, new_e

    def apply_local(self, tree, residual=None):
        meta, mean_hat, _, new_e = self._run(tree, None, residual)
        return _unflatten_tree(mean_hat, meta), new_e

    def wire_bytes(self, tree):
        n = _tree_size(tree)
        scales = -(-n // self.block)
        return 8 * n, 2 * (n + 4 * scales)


POLICIES: Dict[str, Any] = {
    "fp32": GradCommPolicy,
    "bf16": Bf16Policy,
    "int8_ef": Int8EfPolicy,
}

Fp32Policy = GradCommPolicy


def resolve_policy(policy) -> GradCommPolicy:
    """``None`` / a policy name / a policy instance -> policy instance."""
    if policy is None:
        return GradCommPolicy()
    if isinstance(policy, GradCommPolicy):
        return policy
    if isinstance(policy, str):
        cls = POLICIES.get(policy)
        if cls is None:
            raise ValueError(
                f"unknown grad_comm policy {policy!r}; choose from "
                f"{sorted(POLICIES)} or pass a GradCommPolicy instance")
        return cls()
    raise TypeError(f"grad_comm must be None, a name, or a GradCommPolicy; "
                    f"got {type(policy).__name__}")


# --------------------------------------------------------------------------
# module-level API
# --------------------------------------------------------------------------

def compressed_all_reduce(tree, group, policy="fp32", residual=None):
    """Cross-replica MEAN of ``tree`` over ``group`` (a
    ``collective.Group``) under ``policy``; every rank of the group calls
    it.  Returns ``(mean_tree, new_residual)``."""
    return resolve_policy(policy).all_reduce(tree, group, residual)


def compressed_reduce_scatter(tree, group, policy="fp32", residual=None):
    """Reduce-scatter of the flattened ``tree`` mean: this rank's
    contiguous fp32 shard plus the :class:`TreeMeta` to reassemble
    (``tree_from_shards``).  Returns ``(shard, meta, new_residual)``."""
    return resolve_policy(policy).reduce_scatter(tree, group, residual)


def tree_from_shards(shard, meta: TreeMeta, group):
    """Gather reduce-scatter shards back into the full tree (fp32 hop)."""
    from .collective import all_gather_dim
    flat = all_gather_dim(shard, 0, group) if _group_size(group) > 1 \
        else shard
    return _unflatten_tree(flat, meta)


def wire_bytes(tree, policy="fp32") -> Dict[str, int]:
    """Logical bytes-on-wire estimate for one reduction of ``tree``:
    ``{"pre_bytes": fp32-baseline, "post_bytes": policy, "elements": N}``."""
    p = resolve_policy(policy)
    pre, post = p.wire_bytes(tree)
    return {"pre_bytes": int(pre), "post_bytes": int(post),
            "elements": _tree_size(tree)}


def apply_policy_local(policy, grads, state, found_inf=None):
    """The trainers' shared local-mode seam: apply ``policy`` to the
    (already mean-reduced) grad tree, threading the error-feedback
    residual through the state dict.  Returns ``(grads', comm_state)``
    with ``comm_state`` ``{}`` or ``{"comm_e": residual'}``; with
    ``found_inf`` (a bool tensor) a skipped step keeps the old
    residual."""
    if policy.name == "fp32":
        return grads, {}
    grads, new_e = policy.apply_local(grads, state.get("comm_e"))
    if not policy.stateful:
        return grads, {}
    if found_inf is not None:
        new_e = torch.where(found_inf, state["comm_e"], new_e)
    return grads, {"comm_e": new_e}


def comm_info(tree, policy) -> Optional[Dict[str, Any]]:
    """The ``comm=`` dict ``telemetry.instrument_train_step`` feeds to
    ``TrainMonitor.record_comm`` each step — None for the fp32 default."""
    p = resolve_policy(policy)
    if p.name == "fp32":
        return None
    wb = wire_bytes(tree, p)
    return {"policy": p.name, "pre_bytes": wb["pre_bytes"],
            "post_bytes": wb["post_bytes"]}
