"""Unified sharding-rules layer (counterpart of
``paddle_tpu/distributed/sharding_rules.py``) — THE place array-layout
decisions live.

A spec is the reference's ``PartitionSpec`` structure: per tensor dim an
axis name, a tuple of axis names, or None.  The port keeps its own small
copy of it (:class:`PartitionSpec`, a tuple), and a mesh is the port's
``topology.ProcessMesh``: one process per rank, rank r at flat position r
of the reference's device mesh.  A rank's local shard of a tensor under
a spec is the block the reference's ``addressable_shards[r]`` holds
(:func:`local_shard`); :func:`gather_full` inverts it.

1. **Spec constructors** (:func:`make_spec`, :func:`replicated_spec`,
   :func:`replica_stacked_spec`, :func:`batch_spec`, ...).
2. **Metadata-driven inference** (:func:`build_param_specs`,
   :func:`_slot_spec`, :func:`build_state_shardings`): the data, ZeRO and
   (spec-only) model-axis layout of params and optimizer slots, as the
   reference infers it.
3. **Rules-based resolver** (:class:`ShardingRules`): ordered
   ``(regex, spec)`` rules over ``/``-joined tree paths, with the
   reference's scalar exemption and unmatched/indivisible policies.
4. **Stable digests** (:func:`spec_tree_digest`,
   :func:`sharding_rules_digest`, :meth:`ShardingRules.digest`): the same
   strings as the reference's for the same trees and rules.
5. **Replication-fallback accounting** (:func:`replication_fallback`,
   :func:`resolve_flat_shard_spec`).

The model axis enters through ``_dims_mapping`` (a dim the degree does not
divide stays replicated, as in the reference); :func:`without_axis` is the
spec of a rank's model-axis block (the block the tensor-parallel steps hold
and compute on).  :func:`override_leading_axis` is the pipeline's
stacked-parameter layout (the leading layer dim over "pipe").
"""

from __future__ import annotations

import hashlib
import re
import warnings
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "CATALOG_VERSION", "PartitionSpec", "ShardingRules",
    "activation_batch_spec", "batch_spec", "build_param_specs",
    "build_state_shardings", "gather_full", "local_shard", "make_spec",
    "match_partition_rules", "override_leading_axis", "register_rules",
    "replica_stacked_spec",
    "replicated_spec", "replication_fallback", "resolve_flat_shard_spec",
    "sep_activation_spec", "sharding_rules_digest", "spec_tree_digest",
    "unregister_rules", "without_axis",
]

#: Bump when the SEMANTICS of the built-in inference below change without
#: the code path changing shape (the reference's value: the digests agree).
CATALOG_VERSION = 1

#: The built-in rule catalog, word for word the reference's:
#: ``sharding_rules_digest()`` digests these rows.
_RULE_CATALOG: Tuple[Tuple[str, str], ...] = (
    ("tp", "params with _dims_mapping={dim: axis} shard that dim on the "
           "axis when the axis exists, has size>1, and divides the dim"),
    ("pp", "_pipe_stacked params shard dim 0 over 'pipe' when divisible"),
    ("zero3", "zero_stage>=3 shards the first free divisible param dim "
              "over 'sharding'"),
    ("slots", "optimizer slots follow their param's spec; zero_stage>=1 "
              "adds 'sharding' on the first free divisible dim"),
    ("scalars", "scalar/size-1 leaves are always replicated"),
    ("dp_update", "plain-DP weight-update sharding: flat optimizer shards "
                  "carry a leading replica dim over the dp axis "
                  "(update_sharding.py)"),
    ("flat_residual", "flat comm residuals ride an axis only when the "
                      "length divides; otherwise replicate WITH byte "
                      "accounting (resolve_flat_shard_spec)"),
)

#: Explicitly registered custom rule sets (name -> digest).
_REGISTERED: Dict[str, str] = {}


class PartitionSpec(tuple):
    """The reference's ``PartitionSpec``: one entry per leading tensor dim
    (an axis name, a tuple of axis names, or None); list entries become
    tuples.  ``PartitionSpec()`` is replicated, and differs from
    ``PartitionSpec(None)`` as in the reference."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            tuple(e) if isinstance(e, list) else e for e in entries))

    def __getnewargs__(self):
        # pickle passes these to ``__new__``: the entries, not one tuple
        return tuple(self)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(tuple(self))}" \
            if len(self) != 1 else f"PartitionSpec({self[0]!r})"


# --------------------------------------------------------------------------
# trees: nested dicts (keys in sorted order, as jax flattens them), lists
# and tuples; everything else (and a PartitionSpec) is a leaf
# --------------------------------------------------------------------------

def _flatten_with_path(tree, is_leaf=None, path=()):
    """[(path parts, leaf)] in the reference's flatten order."""
    if is_leaf is not None and is_leaf(tree):
        return [(path, tree)]
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten_with_path(tree[k], is_leaf, path + (k,))
        return out
    if isinstance(tree, (list, tuple)) and not isinstance(tree,
                                                          PartitionSpec):
        out = []
        for i, v in enumerate(tree):
            out += _flatten_with_path(v, is_leaf, path + (i,))
        return out
    if tree is None:
        return []
    return [(path, tree)]


def _map_with_path(fn, tree, path=()):
    """``tree`` with each leaf replaced by ``fn("/".join(path), leaf)``."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree,
                                                          PartitionSpec):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn("/".join(path), tree)


# --------------------------------------------------------------------------
# spec constructors
# --------------------------------------------------------------------------

def make_spec(*entries) -> PartitionSpec:
    """``PartitionSpec(*entries)``."""
    return PartitionSpec(*entries)


def replicated_spec() -> PartitionSpec:
    """Fully replicated layout (``PartitionSpec()``)."""
    return PartitionSpec()


def replica_stacked_spec(leaf, axis: str) -> PartitionSpec:
    """Leading-dim-over-``axis`` layout for per-replica stacked state:
    ``P(axis, None, ..., None)`` padded to the leaf's rank."""
    return PartitionSpec(axis, *([None] * (len(_shape(leaf)) - 1)))


def batch_spec(mesh, axis: str = "data") -> PartitionSpec:
    """Batch-dim layout: ``P(axis)`` when the axis exists with size > 1 on
    ``mesh``, else replicated."""
    if axis in mesh.axis_names and mesh.shape[axis] > 1:
        return PartitionSpec(axis)
    return PartitionSpec()


def activation_batch_spec(mesh) -> Optional[PartitionSpec]:
    """(B, L, H) activation layout: batch on "data", sequence on "sep";
    None when the mesh gives no reason to constrain."""
    if "sep" in mesh.shape and mesh.shape["sep"] > 1:
        return PartitionSpec("data", "sep", None)
    if "data" in mesh.shape and mesh.shape["data"] > 1:
        return PartitionSpec("data", None, None)
    return None


def sep_activation_spec(ndim: int = 4, axis: str = "sep",
                        seq_dim: int = 1) -> PartitionSpec:
    """The sequence-parallel attention operands' layout: ``axis`` on the
    sequence dim, everything else replicated (``P(None, "sep", None,
    None)`` at the default rank)."""
    entries: list = [None] * ndim
    entries[seq_dim] = axis
    return PartitionSpec(*entries)


def override_leading_axis(spec: PartitionSpec, ndim: int,
                          axis: str) -> PartitionSpec:
    """``spec`` widened to ``ndim`` entries with dim 0 forced onto
    ``axis``: the pipeline engine's stacked-parameter layout (the leading
    layer dim over "pipe")."""
    entries = [None] * ndim
    for i, a in enumerate(spec):
        entries[i] = a
    entries[0] = axis
    return PartitionSpec(*entries)


def without_axis(spec: PartitionSpec, axis: str = "model") -> PartitionSpec:
    """``spec`` with ``axis`` taken out of every entry: the layout of a
    rank's block along that axis, seen as a whole tensor (the other axes
    split it as ``spec`` does)."""
    out = []
    for e in spec:
        axes = tuple(a for a in _entry_axes(e) if a != axis)
        out.append(None if not axes else axes[0] if len(axes) == 1
                   else axes)
    return PartitionSpec(*out)


# --------------------------------------------------------------------------
# replication-fallback accounting
# --------------------------------------------------------------------------

def replication_fallback(kind: str, name: str, nbytes: int, *,
                         axis: Optional[str] = None,
                         degree: Optional[int] = None,
                         tracer=None) -> None:
    """Record one quietly-replicated tensor: warn, bump the stats
    registry, and (with a tracer) emit a ``sharding_fallback`` event."""
    from ..utils.stats import stat_add
    stat_add("sharding_replicated_fallback_bytes", int(nbytes))
    stat_add("sharding_replicated_fallback_leaves", 1)
    detail = f" over axis {axis!r} (degree {degree})" if axis else ""
    warnings.warn(
        f"sharding: {kind} {name!r} stays fully replicated{detail} — "
        f"{nbytes / 1e6:.2f} MB per device that a divisible layout would "
        f"shard (stat: sharding_replicated_fallback_bytes)")
    if tracer is not None:
        tracer.emit("sharding_fallback", kind=kind, name=name,
                    bytes=int(nbytes), axis=axis, degree=degree)


def resolve_flat_shard_spec(name: str, length: int, mesh, axis: str, *,
                            itemsize: int = 4,
                            tracer=None) -> PartitionSpec:
    """Layout for a flat fp32 buffer: ``P(axis)`` when ``length`` divides
    over the axis, else replicated WITH fallback accounting."""
    deg = mesh.shape.get(axis, 1)
    if deg > 1 and length % deg == 0:
        return PartitionSpec(axis)
    if deg > 1:
        replication_fallback("flat-residual", name, length * itemsize,
                             axis=axis, degree=deg, tracer=tracer)
    return PartitionSpec()


# --------------------------------------------------------------------------
# metadata-driven inference
# --------------------------------------------------------------------------

def _shape(p) -> Tuple[int, ...]:
    return tuple(int(d) for d in getattr(p, "shape", ()) or ())


def _spec_for_param(name: str, p, mesh, named_params: Dict,
                    zero_stage: int, stacked_pipe: bool) -> PartitionSpec:
    shape = _shape(p)
    ndim = len(shape)
    entries = [None] * ndim
    meta = getattr(named_params.get(name), "_dims_mapping", None) \
        if named_params else None
    if meta is None:
        meta = getattr(p, "_dims_mapping", None) or {}
    for dim, axis in meta.items():
        if axis in mesh.axis_names and mesh.shape[axis] > 1 and \
                shape[int(dim)] % mesh.shape[axis] == 0:
            entries[int(dim)] = axis
    if stacked_pipe and "pipe" in mesh.axis_names and mesh.shape["pipe"] > 1 \
            and ndim >= 1 and entries[0] is None and \
            shape[0] % mesh.shape["pipe"] == 0 and \
            getattr(named_params.get(name), "_pipe_stacked", False):
        entries[0] = "pipe"
    if zero_stage >= 3 and "sharding" in mesh.axis_names and \
            mesh.shape["sharding"] > 1:
        for d in range(ndim):
            if entries[d] is None and shape[d] % mesh.shape["sharding"] == 0:
                entries[d] = "sharding"
                break
    return PartitionSpec(*entries)


def build_param_specs(params: Dict[str, Any], mesh, layer=None,
                      zero_stage: int = 0) -> Dict[str, PartitionSpec]:
    named = dict(layer.named_parameters()) if layer is not None else {}
    return {name: _spec_for_param(name, p, mesh, named, zero_stage, True)
            for name, p in params.items()}


def _slot_spec(param_spec: PartitionSpec, p, mesh,
               zero_stage: int) -> PartitionSpec:
    """Optimizer slots follow param sharding; ZeRO-1/2 additionally shards
    them over "sharding" on the first free divisible dim."""
    shape = _shape(p)
    entries = list(param_spec) + [None] * (len(shape) - len(param_spec))
    if zero_stage >= 1 and "sharding" in mesh.axis_names and \
            mesh.shape["sharding"] > 1 and "sharding" not in entries:
        for d in range(len(shape)):
            if entries[d] is None and shape[d] % mesh.shape["sharding"] == 0:
                entries[d] = "sharding"
                break
    return PartitionSpec(*entries)


def build_state_shardings(state, params_specs: Dict[str, PartitionSpec],
                          mesh, zero_stage: int, params):
    """Specs for the full TrainState {params, opt, buffers} (the
    reference returns ``NamedSharding``s of these specs over its mesh)."""
    rep = replicated_spec()

    def slot_specs(name, slots):
        return {sname: (_slot_spec(params_specs[name], params[name], mesh,
                                   zero_stage)
                        if len(_shape(val)) > 0 else rep)
                for sname, val in slots.items()}

    return {"params": dict(params_specs),
            "opt": {"step": rep,
                    "slots": {k: slot_specs(k, v)
                              for k, v in state["opt"]["slots"].items()}},
            "buffers": {k: rep for k in state["buffers"]}}


# --------------------------------------------------------------------------
# a rank's shard of a tensor under a spec, and back
# --------------------------------------------------------------------------

def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def local_shard(full, spec: PartitionSpec, mesh):
    """This rank's block of ``full`` under ``spec``, in storage of its own
    (never a view of ``full``, whose memory a shard must not keep alive):
    dim d splits into the product of its axes' degrees, and the rank takes
    the block its mesh coordinates name (the first axis of a tuple entry
    the major one) — ``addressable_shards[rank].data`` of the reference."""
    out = full
    for d, entry in enumerate(spec):
        idx, n = 0, 1
        for a in _entry_axes(entry):
            idx = idx * mesh.shape[a] + mesh.coord[a]
            n *= mesh.shape[a]
        if n > 1:
            size = out.shape[d] // n
            out = out.narrow(d, idx * size, size)
    # ``clone`` keeps the strides of dense memory only: a block cut along
    # any dim of a contiguous tensor comes out contiguous
    return out.clone()


def gather_full(shard, spec: PartitionSpec, mesh):
    """The whole tensor from each rank's :func:`local_shard`: an
    all-gather along each sharded dim over each of its axes' groups, the
    entry's last (minor) axis first."""
    from .collective import all_gather_dim
    out = shard
    for d, entry in enumerate(spec):
        for a in reversed(_entry_axes(entry)):
            if mesh.shape[a] > 1:
                out = all_gather_dim(out, d, mesh.axis_group(a))
    return out


def spec_shards(spec: PartitionSpec, mesh) -> bool:
    """Whether ``spec`` splits a tensor over any axis of size > 1."""
    return any(mesh.shape.get(a, 1) > 1 for e in spec
               for a in _entry_axes(e))


# --------------------------------------------------------------------------
# path utilities + digests
# --------------------------------------------------------------------------

def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


def _leaf_size(leaf) -> int:
    shape = _shape(leaf)
    return int(np.prod(shape)) if shape else 1


def _leaf_nbytes(leaf) -> int:
    dt = getattr(leaf, "dtype", None)
    itemsize = getattr(dt, "itemsize", None)
    if itemsize is None:
        itemsize = np.dtype(dt).itemsize if dt is not None else 4
    return _leaf_size(leaf) * int(itemsize)


def _canon_spec(spec) -> Tuple:
    if spec is None:
        return ("<none>",)
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e
                 for e in spec)


def _is_spec_leaf(x) -> bool:
    return x is None or isinstance(x, PartitionSpec)


def spec_tree_digest(spec_tree) -> str:
    """Stable hex digest of a resolved spec tree: sorted (path, entries)
    pairs under blake2b — the reference's string for the same tree."""
    flat = _flatten_with_path(spec_tree, is_leaf=_is_spec_leaf)
    rows = sorted((_path_str(path), _canon_spec(spec)) for path, spec in flat)
    h = hashlib.blake2b(digest_size=16)
    for path, entries in rows:
        h.update(path.encode())
        h.update(repr(entries).encode())
        h.update(b"\x00")
    return h.hexdigest()


def sharding_rules_digest() -> str:
    """Digest of the ACTIVE sharding rules in this process: the built-in
    catalog plus every registered :class:`ShardingRules` set."""
    h = hashlib.blake2b(digest_size=16)
    h.update(repr((CATALOG_VERSION,) + _RULE_CATALOG).encode())
    for name in sorted(_REGISTERED):
        h.update(name.encode())
        h.update(_REGISTERED[name].encode())
        h.update(b"\x00")
    return h.hexdigest()


def register_rules(rules: "ShardingRules") -> None:
    """Enroll a custom rule set in the process-global active digest."""
    _REGISTERED[rules.name] = rules.digest()


def unregister_rules(name: str) -> None:
    _REGISTERED.pop(name, None)


# --------------------------------------------------------------------------
# the rules-based resolver
# --------------------------------------------------------------------------

class ShardingRules:
    """Ordered (regex, spec) sharding rules over tree paths, as the
    reference's: first ``re.search`` match wins; ``unmatched`` is
    ``"raise"`` or ``"replicate"`` (with fallback accounting);
    ``indivisible`` (with a bound mesh) is ``"replicate"`` or ``"raise"``;
    scalar and size-1 leaves are always replicated."""

    def __init__(self, rules: Sequence[Tuple[str, Any]], *,
                 unmatched: str = "raise", indivisible: str = "replicate",
                 mesh=None, name: str = "custom", tracer=None):
        if unmatched not in ("raise", "replicate"):
            raise ValueError(
                f"unmatched must be 'raise' or 'replicate', got {unmatched!r}")
        if indivisible not in ("raise", "replicate"):
            raise ValueError(f"indivisible must be 'raise' or 'replicate', "
                             f"got {indivisible!r}")
        self.rules: Tuple[Tuple[str, PartitionSpec], ...] = tuple(
            (str(pat), self._as_spec(spec)) for pat, spec in rules)
        self._compiled = tuple((re.compile(pat), spec)
                               for pat, spec in self.rules)
        self.unmatched = unmatched
        self.indivisible = indivisible
        self.mesh = mesh
        self.name = str(name)
        self.tracer = tracer

    @staticmethod
    def _as_spec(spec) -> PartitionSpec:
        if spec is None:
            return PartitionSpec()
        if isinstance(spec, PartitionSpec):
            return spec
        if isinstance(spec, (tuple, list)):
            return PartitionSpec(*spec)
        raise TypeError(f"rule spec must be a PartitionSpec, entry tuple, "
                        f"or None; got {type(spec).__name__}")

    def spec_for(self, path: str, leaf=None) -> PartitionSpec:
        """The spec for one '/'-joined path."""
        if leaf is not None and _leaf_size(leaf) <= 1:
            return PartitionSpec()
        for rx, spec in self._compiled:
            if rx.search(path):
                return self._fit(path, leaf, spec)
        if self.unmatched == "raise":
            raise ValueError(
                f"sharding rules {self.name!r}: no rule matches path "
                f"{path!r} — add a rule or construct with "
                f"unmatched='replicate'")
        if leaf is not None:
            replication_fallback("unmatched-path", path, _leaf_nbytes(leaf),
                                 tracer=self.tracer)
        return PartitionSpec()

    def _fit(self, path: str, leaf, spec: PartitionSpec) -> PartitionSpec:
        """Trim/pad ``spec`` to the leaf's rank and enforce divisibility
        against the bound mesh."""
        if leaf is None:
            return spec
        shape = _shape(leaf)
        entries = list(spec)[:len(shape)] + \
            [None] * max(0, len(shape) - len(spec))
        if self.mesh is None:
            return self._squeeze(entries)
        for d, entry in enumerate(entries):
            deg = 1
            for a in _entry_axes(entry):
                deg *= self.mesh.shape.get(a, 1)
            if deg > 1 and shape[d] % deg != 0:
                if self.indivisible == "raise":
                    raise ValueError(
                        f"sharding rules {self.name!r}: axis {entry!r} "
                        f"(degree {deg}) does not divide dim {d} "
                        f"(size {shape[d]}) of {path!r}")
                replication_fallback(
                    "indivisible-dim", f"{path}[{d}]",
                    _leaf_nbytes(leaf), axis=str(entry), degree=deg,
                    tracer=self.tracer)
                entries[d] = None
        return self._squeeze(entries)

    @staticmethod
    def _squeeze(entries) -> PartitionSpec:
        """Drop trailing Nones (``P(None, None)`` and ``P()`` lay out the
        same; the short form keeps digests rank-independent)."""
        while entries and entries[-1] is None:
            entries = entries[:-1]
        return PartitionSpec(*entries)

    def resolve(self, tree) -> Any:
        """Spec tree (same structure as ``tree``) for any tree."""
        return _map_with_path(lambda p, leaf: self.spec_for(p, leaf), tree)

    def resolve_state(self, state) -> Any:
        """Specs for an optimizer-carrying train state: each optimizer
        slot resolves under its PARAM's path; opt/step is replicated."""
        out = {}
        for key, sub in state.items():
            if key == "opt" and isinstance(sub, dict) and "slots" in sub:
                slot_specs = {}
                for pname, slots in sub["slots"].items():
                    slot_specs[pname] = {
                        sname: self.spec_for(f"params/{pname}", leaf=sval)
                        for sname, sval in slots.items()}
                out["opt"] = {"step": PartitionSpec(), "slots": slot_specs}
                if "step" not in sub:
                    del out["opt"]["step"]
            elif isinstance(sub, (dict, list, tuple)):
                out[key] = _map_with_path(
                    lambda p, leaf, key=key: self.spec_for(
                        f"{key}/{p}" if p else key, leaf), sub)
            else:
                out[key] = self.spec_for(key, sub)
        return out

    def digest(self) -> str:
        """Stable digest of the rule CONTENT (not the name)."""
        h = hashlib.blake2b(digest_size=16)
        h.update(repr((self.unmatched, self.indivisible)).encode())
        for pat, spec in self.rules:
            h.update(pat.encode())
            h.update(repr(_canon_spec(spec)).encode())
            h.update(b"\x00")
        return h.hexdigest()

    def __repr__(self):
        return (f"ShardingRules({self.name!r}, {len(self.rules)} rules, "
                f"unmatched={self.unmatched!r}, digest={self.digest()[:8]})")


def match_partition_rules(rules: Sequence[Tuple[str, Any]], tree,
                          unmatched: str = "raise", mesh=None) -> Any:
    """Functional shorthand: resolve ``tree`` under ``rules`` in one call."""
    return ShardingRules(rules, unmatched=unmatched, mesh=mesh,
                         name="match_partition_rules").resolve(tree)
