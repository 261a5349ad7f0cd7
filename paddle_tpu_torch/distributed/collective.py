"""Collective communication API (counterpart of
``paddle_tpu/distributed/collective.py``; reference:
python/paddle/distributed/collective.py).

A ``Group`` wraps a ``torch.distributed`` process group over the
reference's rank list.  Each collective acts IN PLACE on the caller's
tensor and returns it, as Paddle and ``torch.distributed`` do (the
reference returns a new value inside ``shard_map``: ``ROADMAP.md`` §C).
A group of one rank is the identity, so every collective runs unchanged
in a single process with no process group.

Under the gloo backend a CUDA tensor goes through an explicit pinned host
copy for the collectives gloo does not run on CUDA tensors
(``_GLOO_HOST_STAGED``; counted in ``HOST_STAGING``).  NCCL never stages.

The tensor- and sequence-parallel layers differentiate through the
autograd collectives below: Megatron's pair (:func:`copy_to_group`,
identity forward and all-reduce backward; :func:`reduce_from_group`,
all-reduce forward and identity backward), :func:`gather_along` (an
all-gather along a dim, reduce-scatter backward), :func:`split_along`
(its transpose), :func:`all_to_all_along` (an all-to-all between two
dims, its inverse backward) and :func:`ring_exchange` (send to the next
rank of a group, receive from the previous one).  The expert axis adds
:func:`reduce_scatter_along` (a reduce-scatter along a dim, all-gather
backward), :func:`sum_over_group` (an all-reduce whose gradient is
all-reduced too: every rank's loss reads the sum) and
:func:`all_to_all_uneven` (an all-to-all of rows with per-rank counts,
``distributed/utils.py``'s ragged exchange).  The pipeline's schedules
move activations and gradients with :func:`p2p_exchange` (every send and
receive of one boundary posted at once).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from . import env

_group_counter = [0]
_groups = {}

#: collectives gloo refuses on CUDA tensors: under gloo their CUDA
#: operands are copied through pinned host buffers (never under NCCL)
_GLOO_HOST_STAGED = frozenset({
    "all_gather", "reduce_scatter", "all_to_all", "all_to_all_uneven",
    "scatter", "send", "recv", "ring_exchange", "p2p_exchange"})

#: host staging done under gloo: copies (each direction counts) and bytes
HOST_STAGING = {"copies": 0, "bytes": 0}


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


def _torch_op(op):
    import torch.distributed as dist
    return {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
            ReduceOp.MIN: dist.ReduceOp.MIN,
            ReduceOp.PROD: dist.ReduceOp.PRODUCT,
            ReduceOp.AVG: dist.ReduceOp.SUM}[op]


class Group:
    """A communication group: a ``torch.distributed`` process group over
    ``ranks`` (global ranks, in the reference's order).  ``pg`` is the
    process group, None for the default group or a group of one rank."""

    def __init__(self, ranks: Optional[List[int]] = None,
                 axis_name: str = "group", hcg=None, gid: int = 0, pg=None):
        self.ranks = list(ranks) if ranks is not None else list(
            range(env.get_world_size()))
        self.axis_name = axis_name
        self.hcg = hcg
        self.id = gid
        self.pg = pg

    @property
    def nranks(self) -> int:
        return len(self.ranks)

    world_size = nranks

    @property
    def rank(self) -> int:
        r = env.get_rank()
        return self.ranks.index(r) if r in self.ranks else -1

    def get_group_rank(self, rank: int) -> int:
        return self.ranks.index(rank) if rank in self.ranks else -1

    def is_member(self) -> bool:
        return env.get_rank() in self.ranks

    def global_rank(self, rank: int) -> int:
        """A global rank from a rank given as the reference takes it: a
        member's global rank, else an index into ``ranks``."""
        return rank if rank in self.ranks else self.ranks[rank]

    @property
    def backend(self) -> Optional[str]:
        import torch.distributed as dist
        if self.nranks <= 1 or not dist.is_initialized():
            return None
        return dist.get_backend(self.pg)

    def __repr__(self):
        return f"Group(axis={self.axis_name}, ranks={self.ranks})"


_default_group: Optional[Group] = None


def _get_default_group() -> Group:
    global _default_group
    if _default_group is None or \
            _default_group.nranks != env.get_world_size():
        _default_group = Group(axis_name="world", gid=0)
    return _default_group


def get_group(gid: int = 0) -> Optional[Group]:
    if gid == 0:
        return _get_default_group()
    return _groups.get(gid)


def new_group(ranks: Optional[List[int]] = None, backend: Optional[str] = None,
              timeout=None) -> Group:
    """``paddle.distributed.new_group``: every rank of the world calls it,
    in the same order (``torch.distributed.new_group``'s contract)."""
    import torch.distributed as dist
    _group_counter[0] += 1
    gid = _group_counter[0]
    ranks = list(ranks) if ranks is not None else list(
        range(env.get_world_size()))
    pg = None
    if len(ranks) > 1 and len(ranks) < env.get_world_size():
        kw = {"backend": backend} if backend else {}
        if timeout is not None:
            kw["timeout"] = timeout
        pg = dist.new_group(ranks, **kw)
    g = Group(ranks, axis_name=f"group_{gid}", gid=gid, pg=pg)
    _groups[gid] = g
    return g


def is_initialized() -> bool:
    return env.is_initialized()


def destroy_process_group(group=None):
    """Drop ``group``, or (None) every group and the default process
    group."""
    global _default_group
    import torch.distributed as dist
    if group is None:
        _default_group = None
        _groups.clear()
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
        env._forget()
        return
    _groups.pop(group.id, None)
    if group.pg is not None:
        dist.destroy_process_group(group.pg)


def _solo(group: Group) -> bool:
    return group.nranks <= 1


# --------------------------------------------------------------------------
# the one place a collective meets torch.distributed: gloo's host staging
# --------------------------------------------------------------------------

def _run(name: str, group: Group, inputs, outputs, fn):
    """Run ``fn(inputs, outputs)`` (a ``torch.distributed`` call on those
    tensors).  Under gloo, a collective gloo does not run on CUDA tensors
    gets pinned host copies of its CUDA operands, and its outputs are
    copied back; under any other backend ``fn`` sees the tensors as
    given."""
    import torch
    tensors = [t for t in list(inputs) + list(outputs) if t is not None]
    if not (group.backend == "gloo" and name in _GLOO_HOST_STAGED
            and any(t.is_cuda for t in tensors)):
        fn(inputs, outputs)
        return

    def host(t, fill):
        if t is None or not t.is_cuda:
            return t
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        if fill:
            h.copy_(t)
            HOST_STAGING["copies"] += 1
            HOST_STAGING["bytes"] += t.numel() * t.element_size()
        return h

    h_in = [host(t, True) for t in inputs]
    # an in-place collective's output is its input's host copy
    h_out = []
    for o in outputs:
        same = [h for t, h in zip(inputs, h_in) if t is o]
        h_out.append(same[0] if same else host(o, False))
    fn(h_in, h_out)
    for o, h in zip(outputs, h_out):
        if o is not None and o.is_cuda:
            o.copy_(h)
            HOST_STAGING["copies"] += 1
            HOST_STAGING["bytes"] += o.numel() * o.element_size()


# --------------------------------------------------------------------------
# tensor-level helpers the trainers use (dim-aware gather/scatter)
# --------------------------------------------------------------------------

def _gather_into(out, x, group):
    """``all_gather_single`` where this torch has it, else its older name
    ``all_gather_into_tensor`` (the same call)."""
    import torch.distributed as dist
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, x, group=group)


def _scatter_into(out, x, op, group):
    """``reduce_scatter_single``, else ``reduce_scatter_tensor``."""
    import torch.distributed as dist
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    fn(out, x, op=op, group=group)


def all_gather_dim(shard, dim: int, group: Group):
    """The ranks' ``shard``s concatenated along ``dim`` in group order."""
    import torch
    import torch.distributed as dist
    if _solo(group):
        return shard
    x = shard.movedim(dim, 0).contiguous()
    out = torch.empty((group.nranks * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _run("all_gather", group, [x], [out],
         lambda i, o: _gather_into(o[0], i[0], group=group.pg))
    return out.movedim(0, dim)


def reduce_scatter_dim(full, dim: int, group: Group, op=ReduceOp.SUM):
    """This rank's block along ``dim`` of the reduction of the ranks'
    ``full`` tensors (``dim`` splits evenly over the group)."""
    import torch
    import torch.distributed as dist
    if _solo(group):
        return full.clone()
    x = full.movedim(dim, 0).contiguous()
    n = x.shape[0] // group.nranks
    out = torch.empty((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _run("reduce_scatter", group, [x], [out],
         lambda i, o: _scatter_into(o[0], i[0], op=_torch_op(op),
                                    group=group.pg))
    if op == ReduceOp.AVG:
        out = out / group.nranks
    return out.movedim(0, dim)


def all_to_all_rows(x, group: Group):
    """``x`` of shape ``(R, ...)``: row r goes to the group's r-th rank;
    returns ``(R, ...)`` whose row r came from the r-th rank."""
    import torch
    import torch.distributed as dist
    if _solo(group):
        return x.clone()
    x = x.contiguous()
    out = torch.empty_like(x)
    _run("all_to_all", group, [x], [out],
         lambda i, o: dist.all_to_all_single(o[0], i[0], group=group.pg))
    return out


def all_to_all_uneven(x, send_counts, recv_counts, group: Group):
    """Rows of ``x`` (dim 0) exchanged with uneven counts: the first
    ``send_counts[0]`` rows go to the group's first rank, the next
    ``send_counts[1]`` to its second, and so on; returns the
    ``sum(recv_counts)`` rows received, in group order
    (``recv_counts[q]`` from rank q).  The counts are host integers."""
    import torch.distributed as dist
    send_counts = [int(c) for c in send_counts]
    recv_counts = [int(c) for c in recv_counts]
    if _solo(group):
        return x[:send_counts[0]].clone()
    x = x[:sum(send_counts)].contiguous()
    out = torch.empty((sum(recv_counts),) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _run("all_to_all_uneven", group, [x], [out],
         lambda i, o: dist.all_to_all_single(o[0], i[0], recv_counts,
                                             send_counts, group=group.pg))
    return out


# --------------------------------------------------------------------------
# the collective API
# --------------------------------------------------------------------------

def wait(tensor, group=None, use_calc_stream=True):
    """Reference collective.py:286: wait for the tensor's stream."""
    import torch
    if getattr(tensor, "is_cuda", False):
        torch.cuda.current_stream(tensor.device).synchronize()


def barrier(group=None):
    """Reference collective.py:167."""
    import torch.distributed as dist
    group = group or _get_default_group()
    if _solo(group):
        return
    dist.barrier(group=group.pg)


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """In place on ``tensor``; returns it.  ``AVG`` is the sum divided by
    the group's size; ``PROD`` the exact product (signs and zeros)."""
    import torch.distributed as dist
    group = group or _get_default_group()
    if _solo(group):
        return tensor
    _run("all_reduce", group, [tensor], [tensor],
         lambda i, o: dist.all_reduce(i[0], op=_torch_op(op),
                                      group=group.pg))
    if op == ReduceOp.AVG:
        if tensor.is_floating_point():
            tensor.div_(group.nranks)
        else:
            tensor.copy_(tensor.div(group.nranks, rounding_mode="trunc"))
    return tensor


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reference collective.py:516 — the result is produced on every rank
    (a superset of the contract, as in the reference)."""
    return all_reduce(tensor, op, group, sync_op)


def broadcast(tensor, src=0, group=None, sync_op=True):
    """Reference collective.py:352: ``src``'s tensor, in place on every
    rank."""
    import torch.distributed as dist
    group = group or _get_default_group()
    if _solo(group):
        return tensor
    src = group.global_rank(src)
    _run("broadcast", group, [tensor], [tensor],
         lambda i, o: dist.broadcast(i[0], src, group=group.pg))
    return tensor


def all_gather(tensor_list, tensor, group=None, sync_op=True):
    """Reference collective.py:618 — appends the ranks' tensors to
    ``tensor_list`` in group order; with ``tensor_list`` None returns them
    stacked on a new leading dim."""
    import torch
    group = group or _get_default_group()
    if _solo(group):
        if tensor_list is not None:
            tensor_list.append(tensor)
            return tensor_list
        return tensor[None]
    out = all_gather_dim(tensor[None], 0, group)
    if tensor_list is not None:
        tensor_list.extend(torch.unbind(out, 0))
        return tensor_list
    return out


def all_gather_object(object_list, obj, group=None):
    """Appends every rank's ``obj`` to ``object_list`` in group order."""
    import torch.distributed as dist
    group = group or _get_default_group()
    if _solo(group):
        object_list.append(obj)
        return object_list
    got = [None] * group.nranks
    dist.all_gather_object(got, obj, group=group.pg)
    object_list.extend(got)
    return object_list


def reduce_scatter(tensor, tensor_list=None, op=ReduceOp.SUM, group=None,
                   sync_op=True, input_tensor=None):
    """This rank's block (along dim 0) of the reduction of ``input_tensor``
    (or of ``tensor_list`` concatenated, or of ``tensor``); written into
    ``tensor`` when it is a separate output, else returned."""
    import torch
    group = group or _get_default_group()
    src = input_tensor if input_tensor is not None else (
        tensor_list if tensor_list is not None else tensor)
    x = torch.cat(list(src), 0) if isinstance(src, (list, tuple)) else src
    out = x if _solo(group) else reduce_scatter_dim(x, 0, group, op)
    if tensor is not None and tensor is not src:
        tensor.copy_(out)
        return tensor
    return out


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Reference collective.py:704: rank r of the group receives
    ``tensor_list[r]`` (``src``'s list) into ``tensor``."""
    import torch.distributed as dist
    group = group or _get_default_group()
    if _solo(group):
        if tensor_list:
            tensor.copy_(tensor_list[0])
        return tensor
    src = group.global_rank(src)
    lst = list(tensor_list) if tensor_list is not None and \
        env.get_rank() == src else None
    ins = [t.contiguous() for t in lst] if lst is not None else []
    _run("scatter", group, ins, [tensor],
         lambda i, o: dist.scatter(o[0], list(i) if lst is not None else
                                   None, src=src, group=group.pg))
    return tensor


def alltoall(in_tensor_list, out_tensor_list=None, group=None, sync_op=True):
    """Reference collective.py:1488: ``in_tensor_list[r]`` goes to the
    group's r-th rank; the received tensors are appended to
    ``out_tensor_list`` (returned stacked when it is None)."""
    import torch
    group = group or _get_default_group()
    x = torch.stack(list(in_tensor_list), 0) \
        if isinstance(in_tensor_list, (list, tuple)) else in_tensor_list
    out = x if _solo(group) else all_to_all_rows(x, group)
    if out_tensor_list is not None:
        out_tensor_list.extend(torch.unbind(out, 0))
        return out_tensor_list
    return out


def alltoall_single(in_tensor, out_tensor=None, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """Equal splits of dim 0 exchanged between the group's ranks."""
    group = group or _get_default_group()
    if in_split_sizes or out_split_sizes:
        raise NotImplementedError("alltoall_single with split sizes: equal "
                                  "splits only, as in the reference")
    if _solo(group):
        out = in_tensor
    else:
        R = group.nranks
        out = all_to_all_rows(in_tensor.reshape(
            (R, in_tensor.shape[0] // R) + tuple(in_tensor.shape[1:])),
            group).reshape(in_tensor.shape)
    if out_tensor is not None:
        out_tensor.copy_(out)
        return out_tensor
    return out


def send(tensor, dst=0, group=None, sync_op=True):
    """Reference collective.py:1573: ``tensor`` to rank ``dst`` (paired
    with that rank's ``recv``)."""
    import torch.distributed as dist
    group = group or _get_default_group()
    if _solo(group):
        return tensor
    dst = group.global_rank(dst)
    _run("send", group, [tensor.contiguous()], [],
         lambda i, o: dist.send(i[0], dst, group=group.pg))
    return tensor


def recv(tensor, src=0, group=None, sync_op=True):
    """Receives rank ``src``'s ``send`` into ``tensor``."""
    import torch.distributed as dist
    group = group or _get_default_group()
    if _solo(group):
        return tensor
    src = group.global_rank(src)
    _run("recv", group, [], [tensor],
         lambda i, o: dist.recv(o[0], src, group=group.pg))
    return tensor


isend = send
irecv = recv


def broadcast_object_list(object_list, src=0, group=None):
    """``src``'s objects, in place in ``object_list`` on every rank."""
    import torch.distributed as dist
    group = group or _get_default_group()
    if _solo(group):
        return object_list
    dist.broadcast_object_list(object_list, group.global_rank(src),
                               group=group.pg)
    return object_list


# --------------------------------------------------------------------------
# autograd collectives (the tensor- and sequence-parallel layers)
# --------------------------------------------------------------------------

def _reduced(x, group, op=ReduceOp.SUM):
    """A new tensor: ``x`` all-reduced over ``group``."""
    out = x.clone(memory_format=torch.contiguous_format)
    return all_reduce(out, op, group)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduced(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduced(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.dim, ctx.group), None, None


class _ReduceScatterAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.dim, ctx.group), None, None


class _SumOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduced(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduced(g, ctx.group), None


class _SplitAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        n = x.shape[dim] // group.nranks
        return x.narrow(dim, group.rank * n, n).clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.dim, ctx.group), None, None


def _a2a(x, split_dim, concat_dim, group):
    """``x`` split into ``group.nranks`` blocks along ``split_dim``, block
    r sent to the group's r-th rank; the blocks received concatenated
    along ``concat_dim`` in group order."""
    R = group.nranks
    shape = list(x.shape)
    n = shape[split_dim] // R
    blocks = x.reshape(shape[:split_dim] + [R, n] + shape[split_dim + 1:])
    rows = all_to_all_rows(blocks.movedim(split_dim, 0), group)
    # rows[r]: rank r's block, of x's shape but n along split_dim
    got = rows.movedim(0, concat_dim)
    shape[split_dim] = n
    shape[concat_dim] *= R
    return got.reshape(shape)


class _AllToAllAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return _a2a(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _a2a(g, concat_dim, split_dim, ctx.group), None, None, None


def copy_to_group(x, group: Group):
    """Identity forward, the gradient all-reduced over ``group``
    backward: the input of a column-parallel product (Megatron's f)."""
    return x if _solo(group) else _CopyToGroup.apply(x, group)


def reduce_from_group(x, group: Group):
    """``x`` all-reduced over ``group`` forward, identity backward: the
    output of a row-parallel product (Megatron's g)."""
    return x if _solo(group) else _ReduceFromGroup.apply(x, group)


def gather_along(x, dim: int, group: Group):
    """The ranks' ``x`` concatenated along ``dim`` in group order; the
    gradient is reduce-scattered back along ``dim``."""
    return x if _solo(group) else _GatherAlong.apply(x, dim, group)


def reduce_scatter_along(x, dim: int, group: Group):
    """This rank's block along ``dim`` of the sum of the ranks' ``x``; the
    gradient is all-gathered back (the transpose of :func:`gather_along`).
    """
    return x if _solo(group) else _ReduceScatterAlong.apply(x, dim, group)


def sum_over_group(x, group: Group):
    """The sum of the ranks' ``x`` on every rank; the gradient is the sum
    of the ranks' gradients, as when every rank's loss reads the sum and
    the step averages the ranks' gradients (a global mean over the batch
    group, the MoE gate's mean probability)."""
    return x if _solo(group) else _SumOverGroup.apply(x, group)


def split_along(x, dim: int, group: Group):
    """This rank's block of ``x`` along ``dim``; the gradient is
    all-gathered back."""
    return x if _solo(group) else _SplitAlong.apply(x, dim, group)


def all_to_all_along(x, split_dim: int, concat_dim: int, group: Group):
    """``x`` split along ``split_dim`` over the group's ranks, each rank's
    blocks concatenated along ``concat_dim`` (Ulysses' sequence → heads
    swap); the gradient takes the inverse exchange."""
    if _solo(group):
        return x
    return _AllToAllAlong.apply(x, split_dim, concat_dim, group)


def ring_exchange(tensors, group: Group):
    """Each tensor of ``tensors`` sent to the group's next rank; returns
    the tensors received from the previous one (one round of a ring, all
    sends and receives posted at once).  Not differentiable: the ring's
    own backward sends its gradients the same way."""
    import torch.distributed as dist
    if _solo(group):
        return list(tensors)
    me = group.rank
    nxt = group.ranks[(me + 1) % group.nranks]
    prv = group.ranks[(me - 1) % group.nranks]
    ins = [t.contiguous() for t in tensors]
    outs = [torch.empty_like(t) for t in ins]

    def fn(i, o):
        reqs = [dist.isend(t, nxt, group=group.pg) for t in i]
        reqs += [dist.irecv(t, prv, group=group.pg) for t in o]
        for r in reqs:
            r.wait()
    _run("ring_exchange", group, ins, outs, fn)
    return outs


def p2p_exchange(sends, recvs, group: Group):
    """Post every send of ``sends`` (``[(tensor, dst)]``) and every
    receive of ``recvs`` (``[(buffer, src)]``, filled in place; ``dst``
    and ``src`` are global ranks of ``group``) at once, and wait for all:
    one NCCL group call (``batch_isend_irecv``), or gloo's own sends and
    receives.  The pipeline schedules exchange this way at each of their
    boundaries, every peer posting its side of a pair in the same call,
    so two neighbours that both send never wait on each other."""
    import torch.distributed as dist
    if _solo(group) or not (sends or recvs):
        return
    ins = [t.contiguous() for t, _ in sends]
    outs = [t for t, _ in recvs]
    dsts = [d for _, d in sends]
    srcs = [s for _, s in recvs]

    def fn(i, o):
        if group.backend == "nccl":
            reqs = dist.batch_isend_irecv(
                [dist.P2POp(dist.isend, t, d, group=group.pg)
                 for t, d in zip(i, dsts)]
                + [dist.P2POp(dist.irecv, t, s, group=group.pg)
                   for t, s in zip(o, srcs)])
        else:
            reqs = [dist.isend(t, d, group=group.pg) for t, d in zip(i, dsts)]
            reqs += [dist.irecv(t, s, group=group.pg)
                     for t, s in zip(o, srcs)]
        for r in reqs:
            r.wait()
    _run("p2p_exchange", group, ins, outs, fn)


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """Megatron-style sharded Embedding/Linear (reference collective.py
    ``split``): builds the tensor-parallel layer for ``operation``
    (``"embedding"``, or ``"linear"`` row-parallel on ``axis`` 0 and
    column-parallel on 1) over the model group of the active hybrid group
    and applies it to ``x``."""
    from .fleet.meta_parallel.parallel_layers.mp_layers import (
        ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)
    if operation == "embedding":
        layer = VocabParallelEmbedding(size[0], size[1],
                                       weight_attr=weight_attr)
        return layer(x)
    if operation == "linear":
        if axis == 0:
            layer = RowParallelLinear(size[0], size[1],
                                      weight_attr=weight_attr,
                                      has_bias=bias_attr is not False,
                                      input_is_parallel=False)
        else:
            layer = ColumnParallelLinear(size[0], size[1],
                                         weight_attr=weight_attr,
                                         has_bias=bias_attr is not False,
                                         gather_output=gather_out)
        return layer(x)
    raise ValueError(f"unsupported split operation {operation}")
