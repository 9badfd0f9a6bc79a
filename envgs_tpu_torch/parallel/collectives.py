"""Collectives over a mesh axis, differentiable as the JAX package's `lax`
collectives are under shard_map (the torch counterpart of the psum /
pmean / pmax / all_gather / ppermute / axis_index that
envgs_tpu/parallel/ calls).

An `Axis` is one axis of a mesh: a torch.distributed process group, this
process's position along it and the group's backend. Every collective is
built on `all_reduce`, the one collective that gloo and NCCL both run on
CPU and CUDA tensors: an all-gather writes each rank's piece into its own
slot of a zeros buffer and sums (adding zeros is exact), a neighbour
exchange is an all-gather read at the sender's slot. Under gloo a CUDA
tensor goes through the host on purpose: gloo's own collectives are
CPU-side, so `_all_reduce` copies it to the CPU, reduces there and copies
back. The backend is the group's, chosen by whoever made it; nothing here
picks another.

Gradients follow the transposes shard_map gives (each rank
differentiates its own share of the objective):
- psum: the cotangents summed over the axis;
- pmax: the summed cotangent to the elements that hold the maximum;
- all_gather: each rank's slice of the summed cotangent (psum_scatter);
- ppermute: the cotangent sent back from receiver to sender.
Every rank must reach the same collectives in the same order, backward
included; a rank that raises leaves the others at the group's timeout.
`REDUCED` counts the all-reduces this process took part in and the bytes
of its buffers.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist


REDUCED = {"calls": 0, "bytes": 0}


class Axis(NamedTuple):
    """One mesh axis: the ranks of `group` (None: the default group) in
    axis order, this process's position `index` among them, and the
    group's backend ("gloo" or "nccl")."""

    name: str
    group: object
    ranks: tuple
    index: int
    backend: str

    @property
    def size(self) -> int:
        return len(self.ranks)


def make_axis(name: str, ranks=None, timeout=None) -> Axis:
    """The axis over `ranks` (default: every rank of the default group).
    A subgroup is made with dist.new_group, which every rank of the
    default group must call, for every subgroup, in one order."""
    world = dist.get_world_size()
    ranks = tuple(range(world)) if ranks is None else tuple(ranks)
    group = None
    if ranks != tuple(range(world)):
        group = dist.new_group(list(ranks), timeout=timeout)
    me = dist.get_rank()
    index = ranks.index(me) if me in ranks else -1
    backend = str(dist.get_backend(group if index >= 0 else None))
    return Axis(name, group, ranks, index, backend)


def axis_index(axis: Axis) -> int:
    """This process's position along the axis (lax.axis_index)."""
    return axis.index


def _all_reduce(x: torch.Tensor, axis: Axis, op) -> torch.Tensor:
    """all_reduce of a copy of x; under gloo a CUDA tensor is reduced on
    the host (see the module's docstring)."""
    y = x.detach().clone(memory_format=torch.contiguous_format)
    if axis.size == 1:
        return y
    REDUCED["calls"] += 1
    REDUCED["bytes"] += y.numel() * y.element_size()
    if axis.backend == "gloo" and y.device.type != "cpu":
        h = y.cpu()
        dist.all_reduce(h, op=op, group=axis.group)
        return h.to(y.device)
    dist.all_reduce(y, op=op, group=axis.group)
    return y


def _gather(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """(axis.size, *x.shape): every rank's x at its position."""
    buf = x.new_zeros((axis.size, *x.shape))
    buf[axis.index] = x.detach()
    return _all_reduce(buf, axis, dist.ReduceOp.SUM)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _all_reduce(x, axis, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis, dist.ReduceOp.SUM), None


class _PMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        y = _all_reduce(x, axis, dist.ReduceOp.MAX)
        ctx.axis = axis
        ctx.save_for_backward(x == y)
        return y

    @staticmethod
    def backward(ctx, g):
        at_max, = ctx.saved_tensors
        g = _all_reduce(g, ctx.axis, dist.ReduceOp.SUM)
        return torch.where(at_max, g, torch.zeros_like(g)), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, tiled):
        ctx.axis, ctx.shape = axis, x.shape
        out = _gather(x, axis)
        return out.reshape(-1, *x.shape[1:]) if tiled else out

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g, ctx.axis, dist.ReduceOp.SUM)
        g = g.reshape(ctx.axis.size, *ctx.shape)[ctx.axis.index]
        return g, None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, perm):
        ctx.axis, ctx.perm = axis, perm
        src = {d: s for s, d in perm}.get(axis.index)
        pieces = _gather(x, axis)
        return pieces[src] if src is not None else torch.zeros_like(x)

    @staticmethod
    def backward(ctx, g):
        dst = dict(ctx.perm).get(ctx.axis.index)
        pieces = _gather(g, ctx.axis)
        return (pieces[dst] if dst is not None else torch.zeros_like(g),
                None, None)


def psum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum over the axis, on every rank (lax.psum)."""
    return _PSum.apply(x, axis)


def pmean(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Mean over the axis, on every rank (lax.pmean)."""
    return psum(x, axis) / axis.size


def pmax(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Elementwise maximum over the axis, on every rank (lax.pmax)."""
    return _PMax.apply(x, axis)


def pmin(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Elementwise minimum over the axis (lax.pmin); no gradient."""
    return _all_reduce(x, axis, dist.ReduceOp.MIN)


def all_gather(x: torch.Tensor, axis: Axis,
               tiled: bool = False) -> torch.Tensor:
    """Every rank's x in axis order (lax.all_gather): stacked on a new
    leading dimension, or with `tiled` concatenated along dimension 0."""
    return _AllGather.apply(x, axis, tiled)


def ppermute(x: torch.Tensor, axis: Axis, perm) -> torch.Tensor:
    """Send x along the (source, destination) pairs of `perm` (positions
    on the axis, lax.ppermute): a rank that no pair sends to gets zeros."""
    return _PPermute.apply(x, axis, tuple(map(tuple, perm)))


def gather_tree(tree, axis: Axis):
    """all_gather (stacked) of every tensor field of a NamedTuple; None
    fields stay None."""
    return type(tree)(*(None if v is None else all_gather(v, axis)
                        for v in tree))
