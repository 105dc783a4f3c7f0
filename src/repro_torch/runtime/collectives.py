"""Collectives over one mesh axis, taken over the shards of one process.

The port's mesh is driven by one Python process (``launch/mesh.py``): a
placed tensor is a dict of per-device shards, mesh id -> tensor.  A
collective here takes the shards of one *group*, the ids that differ only
along the axes it runs over, and returns each member's result on that
member's device.  On several cards it is a device-to-device copy plus
adds; on logical devices of one card or the CPU it is the same code.

Every result is computed once, in the group's order (the first member's
device, members added one after the other), and copied to each member,
so every member holds the same bits, as the members of a real all-reduce
do, and each its own storage.  A group of one member is no collective:
its result is its input, and nothing is counted (XLA drops a collective
over one device too).

Four of them take gradients.  Megatron's conjugate pair for tensor
parallelism: ``Group.sum`` (an all-reduce in the forward, the identity in
the backward) closes a block whose members computed partial sums that
each then uses whole, and ``Group.copy`` (the identity in the forward, an
all-reduce of the gradients in the backward) opens one, after the
replicated norm.  And a second pair, for a block whose members each need
their own part of a result: ``Group.gather`` (an all-gather whose
backward is a reduce-scatter of the gradients) and ``Group.sum_scatter``
(a reduce-scatter whose backward is an all-gather).  The rest act on
values without gradients: ``Group.max``, ``all_reduce`` of gradients,
``all_gather`` and ``reduce_scatter`` (FSDP).

``Counter`` records, for every mesh id, the bytes each collective
delivers there, by kind and by the axes it ran over: an all-reduce's and
a reduce-scatter's result on that id, an all-gather's gathered tensor.
That is the JAX package's measure (``hlo_analysis.collective_bytes`` sums
the result shapes of the collective ops of the per-device program;
``runtime/hlo_analysis.py`` applies its factor of 2 for an all-reduce).
"""
from __future__ import annotations

from collections import Counter as _Tally
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

class Counter:
    """Result bytes and op counts a collective delivered on each mesh id,
    by (kind, axes): ``bytes[id][(kind, "data,model")]``."""

    def __init__(self):
        self.bytes: Dict[int, _Tally] = {}
        self.ops: Dict[int, _Tally] = {}

    def reset(self) -> None:
        self.bytes.clear()
        self.ops.clear()

    def add(self, device_id: int, kind: str, axes: str, nbytes: int) -> None:
        key = (kind, axes)
        self.bytes.setdefault(device_id, _Tally())[key] += int(nbytes)
        self.ops.setdefault(device_id, _Tally())[key] += 1

    def by_id(self) -> Dict[int, Dict[str, Dict[str, int]]]:
        """id -> kind -> axes -> bytes."""
        out: Dict[int, Dict[str, Dict[str, int]]] = {}
        for i, tally in sorted(self.bytes.items()):
            for (kind, axes), b in sorted(tally.items()):
                out.setdefault(i, {}).setdefault(kind, {})[axes] = b
        return out


def groups(mesh, axes: Sequence[str]) -> List[List[int]]:
    """The ids of ``mesh`` in groups that differ only along ``axes``, each
    in the axes' order (the first axis the major one); every id is in
    exactly one group.  No axes: every id alone."""
    axes = [a for a in axes if a in mesh.axis_names]
    ids = mesh.device_ids
    names = list(mesh.axis_names)
    moved = np.moveaxis(ids, [names.index(a) for a in axes],
                        list(range(ids.ndim - len(axes), ids.ndim)))
    size = int(np.prod([mesh.shape[a] for a in axes])) if axes else 1
    return [[int(i) for i in row] for row in moved.reshape(-1, size)]


class Group:
    """The members of one group of ``mesh`` along ``axes``, in order, with
    the counter their collectives write to."""

    def __init__(self, mesh, ids: Sequence[int], axes: Sequence[str],
                 counter: Optional[Counter] = None):
        self.mesh = mesh
        self.ids = [int(i) for i in ids]
        self.axes = ",".join(a for a in axes if a in mesh.axis_names)
        self.counter = counter

    def __len__(self) -> int:
        return len(self.ids)

    def device(self, k: int) -> torch.device:
        return self.mesh.device(self.ids[k])

    def count(self, kind: str, results: Sequence[torch.Tensor]) -> None:
        if self.counter is None:
            return
        for i, t in zip(self.ids, results):
            self.counter.add(i, kind, self.axes,
                             t.numel() * t.element_size())

    # -- without gradients ------------------------------------------------

    def _reduce(self, xs: Sequence[torch.Tensor], op) -> torch.Tensor:
        dev = xs[0].device
        total = xs[0]
        for x in xs[1:]:
            total = op(total, x.to(dev))
        return total

    def _spread(self, total: torch.Tensor) -> List[torch.Tensor]:
        return [total.to(self.device(k), copy=True)
                for k in range(len(self.ids))]

    @torch.no_grad()
    def all_reduce(self, xs: Sequence[torch.Tensor],
                   op: str = "sum") -> List[torch.Tensor]:
        """Each member's result: the members' values added (``op="sum"``)
        or their elementwise maximum (``"max"``)."""
        if len(xs) == 1:
            return list(xs)
        fn = torch.add if op == "sum" else torch.maximum
        out = self._spread(self._reduce(xs, fn))
        self.count("all-reduce", out)
        return out

    def max(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The elementwise maximum over the members (no gradient)."""
        return self.all_reduce([x.detach() for x in xs], op="max")

    @torch.no_grad()
    def all_gather(self, xs: Sequence[torch.Tensor],
                   dim: int) -> List[torch.Tensor]:
        """The members' parts concatenated along ``dim``, in group
        order, on every member."""
        if len(xs) == 1:
            return list(xs)
        dev = xs[0].device
        whole = torch.cat([x.to(dev) for x in xs], dim=dim)
        out = self._spread(whole)
        self.count("all-gather", out)
        return out

    @torch.no_grad()
    def reduce_scatter(self, xs: Sequence[torch.Tensor],
                       dim: int) -> List[torch.Tensor]:
        """The members' values added, then split along ``dim``: member k
        keeps the k-th part."""
        if len(xs) == 1:
            return list(xs)
        total = self._reduce(xs, torch.add)
        q = total.shape[dim] // len(xs)
        out = [total.narrow(dim, k * q, q).to(self.device(k), copy=True)
               .contiguous() for k in range(len(xs))]
        self.count("reduce-scatter", out)
        return out

    # -- with gradients ---------------------------------------------------

    def sum(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """All-reduce in the forward, the identity in the backward: each
        member's gradient is its own result's (Megatron's g)."""
        if len(xs) == 1:
            return list(xs)
        return list(_Sum.apply(self, *xs))

    def copy(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The identity in the forward, an all-reduce of the gradients in
        the backward (Megatron's f)."""
        if len(xs) == 1:
            return list(xs)
        return list(_Copy.apply(self, *xs))

    def gather(self, xs: Sequence[torch.Tensor],
               dim: int) -> List[torch.Tensor]:
        """``all_gather`` in the forward; in the backward each member's
        gradient is its own part of the members' gradients added (a
        reduce-scatter)."""
        if len(xs) == 1:
            return list(xs)
        return list(_Gather.apply(self, dim, *xs))

    def sum_scatter(self, xs: Sequence[torch.Tensor],
                    dim: int) -> List[torch.Tensor]:
        """``reduce_scatter`` in the forward (member k keeps the k-th part
        of the sum); in the backward every member's gradient is the
        members' gradients concatenated (an all-gather)."""
        if len(xs) == 1:
            return list(xs)
        return list(_SumScatter.apply(self, dim, *xs))


def _filled(grads, meta) -> list:
    """The gradients of a collective's results, a zero tensor where a
    result took none."""
    return [torch.zeros(shape, dtype=dtype, device=dev) if g is None else g
            for g, (shape, dtype, dev) in zip(grads, meta)]


def _meta(xs) -> list:
    return [(x.shape, x.dtype, x.device) for x in xs]


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group: Group, *xs):
        out = group._spread(group._reduce(xs, torch.add))
        group.count("all-reduce", out)
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *grads)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group: Group, *xs):
        ctx.group, ctx.meta = group, _meta(xs)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ctx.group.all_reduce(_filled(grads, ctx.meta)))


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group: Group, dim: int, *xs):
        out = group.all_gather(xs, dim)
        ctx.group, ctx.dim, ctx.meta = group, dim, _meta(out)
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *ctx.group.reduce_scatter(
            _filled(grads, ctx.meta), ctx.dim))


class _SumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group: Group, dim: int, *xs):
        out = group.reduce_scatter(xs, dim)
        ctx.group, ctx.dim, ctx.meta = group, dim, _meta(out)
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *ctx.group.all_gather(
            _filled(grads, ctx.meta), ctx.dim))


def mesh_groups(mesh, axes: Sequence[str],
                counter: Optional[Counter] = None) -> List[Group]:
    """Every ``Group`` of ``mesh`` along ``axes`` (``groups``' order)."""
    return [Group(mesh, ids, axes, counter) for ids in groups(mesh, axes)]


def per_id(mesh, axes: Sequence[str], values: Dict[int, torch.Tensor],
           fn, counter: Optional[Counter] = None, **kw
           ) -> Dict[int, torch.Tensor]:
    """Run the collective ``fn(group, [values of its members], **kw)``
    (e.g. ``Group.all_reduce``) over every group of ``mesh`` along
    ``axes``; returns id -> result."""
    out: Dict[int, torch.Tensor] = {}
    for g in mesh_groups(mesh, axes, counter):
        out.update(zip(g.ids, fn(g, [values[i] for i in g.ids], **kw)))
    return out
