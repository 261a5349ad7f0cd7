"""Hybrid-parallel topology (counterpart of
``paddle_tpu/distributed/topology.py``; reference:
python/paddle/distributed/fleet/base/topology.py).

The reference is single-controller: its topology is one ``jax`` device
mesh, ``np.array(devs).reshape(dims)`` over the axes in ``HYBRID_AXES``
order.  The port is multi-controller, one process per rank: rank r is the
device at flat position r of that mesh (``ProcessMesh``), and the hybrid
group builds one ``torch.distributed`` process group per axis and per
coordinate, in ``HYBRID_AXES`` order, on every rank, and one group for
each combination of the batch axes the train steps reduce over
(``BATCH_AXES``, ``GRAD_AXES``).  All five axes run: the pipe axis
through ``distributed.spmd``'s schedules, whose stages reach their
neighbours by point-to-point sends over the pipe group
(``is_first_stage``, ``is_last_stage``, ``_get_p2p_prev_rank``,
``_get_p2p_next_rank``, as Paddle's hybrid group names them).
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence

import numpy as np

# canonical axis order, outer → inner (reference topology.py:361)
HYBRID_AXES = ("data", "pipe", "sharding", "sep", "model")
#: the axes a batch's rows split over, and the axes a gradient is averaged
#: over (the rows and the sequence chunks)
BATCH_AXES = ("data", "sharding")
GRAD_AXES = ("data", "sharding", "sep")


class CommunicateTopology:
    """Pure coordinate math over an N-D rank grid."""

    def __init__(self, hybrid_group_names: Sequence[str] = ("data", "pipe",
                                                            "sharding", "model"),
                 dims: Sequence[int] = (1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(int(d) for d in dims)
        self.coordinate = list(itertools.product(*(range(d) for d in self._dims)))
        self._coord2rank = {c: i for i, c in enumerate(self.coordinate)}

    def get_hybrid_group_names(self) -> List[str]:
        return self._parallel_names

    def get_dim(self, axis_name: str) -> int:
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self) -> int:
        return int(np.prod(self._dims))

    def get_rank(self, **kwargs) -> int:
        coord = tuple(kwargs[name] for name in self._parallel_names)
        return self._coord2rank[coord]

    def get_coord(self, rank: int):
        return self.coordinate[rank]

    def get_axis_list(self, axis_name: str, index: int) -> List[int]:
        axis = self._parallel_names.index(axis_name)
        return sorted(r for r, c in enumerate(self.coordinate) if c[axis] == index)

    def get_comm_list(self, axis_name: str) -> List[List[int]]:
        """All groups along ``axis_name`` (ranks varying only that coord)."""
        return self.get_comm_list_over((axis_name,))

    def get_comm_list_over(self, axis_names: Sequence[str]) -> List[List[int]]:
        """All groups over the axes ``axis_names`` (ranks varying only
        those coords), each in rank order: the first axis in
        ``hybrid_group_names`` order is the major one."""
        names = self._parallel_names
        moving = [i for i, n in enumerate(names) if n in axis_names]
        other = [i for i in range(len(names)) if i not in moving]
        groups = []
        for combo in itertools.product(*(range(self._dims[i]) for i in other)):
            coord = [0] * len(names)
            for i, v in zip(other, combo):
                coord[i] = v
            group = []
            for vals in itertools.product(*(range(self._dims[i])
                                            for i in moving)):
                for i, v in zip(moving, vals):
                    coord[i] = v
                group.append(self._coord2rank[tuple(coord)])
            groups.append(group)
        return groups

    def get_rank_from_stage(self, global_rank: int, **kwargs) -> int:
        coord = list(self.get_coord(global_rank))
        for name, v in kwargs.items():
            coord[self._parallel_names.index(name)] = v
        return self._coord2rank[tuple(coord)]


class ProcessMesh:
    """The port's counterpart of the reference's ``jax.sharding.Mesh``:
    ``axis_names``, ``shape`` (axis → size), ``devices`` (the ranks laid
    out as the mesh), this process's ``rank`` and its ``coord`` (axis →
    index).  ``axis_group(axis)`` is the ``collective.Group`` of the ranks
    that differ from this one only along ``axis`` (a one-rank group when
    the axis has size 1).  Built without groups (``groups=None``) it is
    layout math only, as the sharding rules need."""

    def __init__(self, axis_names: Sequence[str], dims: Sequence[int],
                 rank: int = 0, groups: Optional[Dict[str, object]] = None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(d) for d in dims)))
        self.size = int(np.prod(list(self.shape.values()) or [1]))
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.devices = np.arange(self.size).reshape(
            tuple(self.shape.values()))
        self.rank = int(rank)
        idx = np.unravel_index(self.rank, self.devices.shape) \
            if self.axis_names else ()
        self.coord = {a: int(i) for a, i in zip(self.axis_names, idx)}
        self._groups = groups

    def axis_group(self, axis: str):
        from .collective import Group
        if self.shape.get(axis, 1) <= 1:
            return Group(ranks=[self.rank], axis_name=axis)
        if self._groups is None:
            raise RuntimeError(f"this mesh has no process groups (axis "
                               f"{axis!r}); build it through "
                               f"HybridCommunicateGroup")
        return self._groups[axis]

    def batch_group(self, axes=BATCH_AXES):
        """The group over the axes ``axes`` (the ranks that differ from
        this one only along them: by default the data × sharding ranks at
        this rank's model and sep coordinates), and this rank's index in
        it (the first axis the major one)."""
        from .collective import Group
        axes = tuple(a for a in self.axis_names if a in axes)
        live = tuple(a for a in axes if self.shape[a] > 1)
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coord[a]
        if not live:
            return Group(ranks=[self.rank], axis_name="batch"), 0
        if int(np.prod([self.shape[a] for a in live])) == self.size:
            return Group(ranks=list(range(self.size)), axis_name="batch"), idx
        if len(live) == 1:
            return self.axis_group(live[0]), idx
        if self._groups is None or live not in self._groups:
            raise RuntimeError(f"this mesh has no process group over "
                               f"{live}; build it through "
                               f"HybridCommunicateGroup")
        return self._groups[live], idx

    def __repr__(self):
        return f"ProcessMesh({self.shape}, rank={self.rank})"


class HybridCommunicateGroup:
    """Reference HybridCommunicateGroup over ``torch.distributed``: one
    process group per axis and per coordinate, created on every rank in
    ``HYBRID_AXES`` order (``torch.distributed.new_group``'s contract);
    ``nranks`` must equal the world size."""

    def __init__(self, topology: Optional[CommunicateTopology] = None,
                 dp_degree: int = 1, mp_degree: int = 1, pp_degree: int = 1,
                 sharding_degree: int = 1, sep_degree: int = 1,
                 devices: Optional[Sequence] = None, order: Sequence[str] = None,
                 virtual_pp_degree: int = 1):
        from . import env
        if topology is not None:
            self._topo = topology
            dims = {n: topology.get_dim(n) for n in topology.get_hybrid_group_names()}
            dp_degree = dims.get("data", 1)
            pp_degree = dims.get("pipe", 1)
            sharding_degree = dims.get("sharding", 1)
            sep_degree = dims.get("sep", 1)
            mp_degree = dims.get("model", 1)
        self._dp_degree = dp_degree
        self._mp_degree = mp_degree
        self._pp_degree = pp_degree
        self._sharding_degree = sharding_degree
        self._sep_degree = sep_degree
        self._virtual_pp_degree = max(int(virtual_pp_degree), 1)
        names = list(order) if order else list(HYBRID_AXES)
        degrees = {"data": dp_degree, "pipe": pp_degree, "sharding": sharding_degree,
                   "sep": sep_degree, "model": mp_degree}
        self._axis_names = [n for n in names if degrees.get(n, 1) >= 1]
        self._dims = [degrees.get(n, 1) for n in self._axis_names]
        if topology is None:
            self._topo = CommunicateTopology(self._axis_names, self._dims)
        self.nranks = int(np.prod(self._dims))
        world = env.get_world_size()
        if self.nranks != world:
            raise ValueError(
                f"the hybrid degrees make {self.nranks} ranks but the "
                f"torch.distributed world has {world}: start one process "
                f"per rank (init_parallel_env) before fleet.init")
        self.global_rank = env.get_rank() if self.nranks > 1 else 0
        self._groups = self._build_groups()
        self._mesh = ProcessMesh(self._axis_names, self._dims,
                                 self.global_rank, self._groups)
        self.stage_id = self.get_stage_id()
        self.is_first_stage = self.stage_id == 0
        self.is_last_stage = self.stage_id == self._pp_degree - 1

    def _build_groups(self):
        """Every rank creates every axis group in the same order, then a
        group for each combination of two or more live axes among
        ``BATCH_AXES`` and ``GRAD_AXES``; it keeps the ones that contain
        it (an axis under its name, a combination under its tuple)."""
        from .collective import Group
        import torch.distributed as dist
        mine = {}
        live = [a for a in self._axis_names if self._topo.get_dim(a) > 1]
        combos = [(a,) for a in live]
        for axes in (BATCH_AXES, GRAD_AXES):
            c = tuple(a for a in live if a in axes)
            if len(c) > 1 and c not in combos:
                combos.append(c)
        for c in combos:
            n = int(np.prod([self._topo.get_dim(a) for a in c]))
            for ranks in self._topo.get_comm_list_over(c):
                pg = None if n == self.nranks else dist.new_group(ranks)
                if self.global_rank in ranks:
                    key = c[0] if len(c) == 1 else c
                    mine[key] = Group(ranks=ranks, axis_name="_".join(c),
                                      hcg=self, pg=pg)
        return mine

    @property
    def mesh(self) -> ProcessMesh:
        return self._mesh

    def build_mesh(self, devices: Optional[Sequence] = None) -> ProcessMesh:
        return self._mesh

    def axis_name(self, logical: str) -> str:
        return {"dp": "data", "pp": "pipe", "sharding": "sharding",
                "sep": "sep", "mp": "model"}.get(logical, logical)

    # ------------------------------------------------- reference API surface
    def get_hybrid_group_names(self):
        return self._axis_names

    def get_global_rank(self) -> int:
        return self.global_rank

    def _axis_rank(self, name: str) -> int:
        if name not in self._axis_names or self.nranks == 1:
            return 0
        coord = self._topo.get_coord(self.global_rank)
        return coord[self._axis_names.index(name)]

    def get_data_parallel_rank(self) -> int:
        return self._axis_rank("data")

    def get_model_parallel_rank(self) -> int:
        return self._axis_rank("model")

    def get_stage_id(self) -> int:
        return self._axis_rank("pipe")

    def get_sharding_parallel_rank(self) -> int:
        return self._axis_rank("sharding")

    def get_sep_parallel_rank(self) -> int:
        return self._axis_rank("sep")

    def get_data_parallel_world_size(self) -> int:
        return self._dp_degree

    def get_model_parallel_world_size(self) -> int:
        return self._mp_degree

    def get_pipe_parallel_world_size(self) -> int:
        return self._pp_degree

    def get_virtual_pipeline_degree(self) -> int:
        return self._virtual_pp_degree

    def get_sharding_parallel_world_size(self) -> int:
        return self._sharding_degree

    def get_sep_parallel_world_size(self) -> int:
        return self._sep_degree

    def _group(self, name: str):
        return self._mesh.axis_group(name)

    def get_data_parallel_group(self):
        return self._group("data")

    def get_model_parallel_group(self):
        return self._group("model")

    def get_pipe_parallel_group(self):
        return self._group("pipe")

    def get_sharding_parallel_group(self):
        return self._group("sharding")

    def get_sep_parallel_group(self):
        return self._group("sep")

    def get_check_parallel_group(self, *a, **k):
        return self._group("model")

    def get_data_parallel_group_src_rank(self):
        return self._group("data").ranks[0]

    def get_model_parallel_group_src_rank(self):
        return self._group("model").ranks[0]

    def get_p2p_groups(self):
        return None

    def _pipe_neighbour(self, step: int) -> int:
        ranks = self._group("pipe").ranks
        return ranks[(self.stage_id + step) % len(ranks)]

    def _get_p2p_next_rank(self) -> int:
        """The global rank of the next pipe stage (the first stage after
        the last: the interleaved schedule's ring)."""
        return self._pipe_neighbour(1)

    def _get_p2p_prev_rank(self) -> int:
        """The global rank of the previous pipe stage (the last before
        the first)."""
        return self._pipe_neighbour(-1)

    def topology(self):
        return self._topo

    def get_parallel_mode(self):
        if self._mp_degree == 1 and self._pp_degree == 1 and \
                self._sharding_degree == 1 and self._dp_degree > 1:
            return "DataParallel"
        if self._sharding_degree > 1 and self._mp_degree == 1 and self._pp_degree == 1:
            return "ShardingParallel"
        if self._pp_degree > 1:
            return "PipelineParallel"
        if self._mp_degree > 1:
            return "TensorParallel"
        return "Serial"


_hcg: Optional[HybridCommunicateGroup] = None


def set_hybrid_communicate_group(hcg: HybridCommunicateGroup):
    global _hcg
    _hcg = hcg


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _hcg
