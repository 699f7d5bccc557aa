"""Collectives over a ``torch.distributed`` process group, each a
``torch.autograd.Function`` whose backward is written out.

A module of the port's own: ``svgir_tpu`` has no counterpart, because
JAX's collectives (``all_gather``, ``psum``, ``pmax``, ``all_to_all``,
``psum_scatter``) carry their transposes with them.  ``parallel/dp.py``
and ``parallel/gshard.py`` use the functions below.

Two kinds of tensor meet here.  A *replicated* tensor holds the same values
on every rank, and a loss computed from replicated tensors is computed, the
same, by every rank; its gradient must be the single-device one, not D
times it.  A *rank-local* tensor differs between ranks.  The backward of
each collective follows from which kind its output is:

- ``all_gather(x, backward="sum")``: the ranks' [n, ...] tensors joined in
  rank order into [D*n, ...].  Every rank goes on to compute something of
  its own from the whole (the sharded render's band of tile rows reads
  every Gaussian's slab row), so the ranks' cotangents differ and each
  rank's slice is their sum: a reduce-scatter.
- ``all_gather(x, backward="own")``: the same forward, for an output every
  rank turns into the same loss (the sharded render's image).  The
  cotangents are equal, and the rank keeps its own slice of its own.
  (``torch.distributed.nn.functional.all_gather`` sums them, which there
  gives D times the gradient.)
- ``all_reduce(x, op)``: ``"sum"`` and ``"mean"`` give every rank the same
  result, from which every rank computes the same loss, so the backward
  passes the cotangent on (times 1/D for the mean); ``"max"`` passes it to
  the ranks that hold the maximum, shared among ties.
- ``all_to_all(x)``: chunk d of x [D*k, ...] goes to rank d; the backward
  sends each cotangent chunk back where it came from, another all-to-all.
- ``reduce_scatter(x)``: the ranks' x [D*k, ...] summed, chunk r to rank
  r; the backward all-gathers the cotangents.
- ``shard(x)``: rank r's chunk of a replicated x [D*k, ...]; the backward
  all-gathers the chunks' gradients, so every rank holds the whole
  gradient of x.

The backend is NCCL on the card and gloo on the CPU.  Several ranks on one
card cannot use NCCL ("Duplicate GPU detected"); they run gloo over CUDA
tensors, which took every collective here on the card (torch 2.11 with
CUDA 12.8), so none is staged through the host.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
        "max": dist.ReduceOp.MAX}


def _gather(x, group):
    d = dist.get_world_size(group)
    out = x.new_empty((d * x.shape[0],) + x.shape[1:])
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def _reduce(x, op, group):
    y = x.clone()
    dist.all_reduce(y, op=_OPS[op], group=group)
    return y


def _split(x, group):
    d = dist.get_world_size(group)
    if x.shape[0] % d:
        raise ValueError(f"{x.shape[0]} rows do not split over {d} ranks")
    return d


def _scatter(x, group):
    out = x.new_empty((x.shape[0] // _split(x, group),) + x.shape[1:])
    dist.reduce_scatter_tensor(out, x.contiguous(), op=dist.ReduceOp.SUM,
                               group=group)
    return out


def _exchange(x, group):
    _split(x, group)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def _own(x, group):
    k = x.shape[0] // dist.get_world_size(group)
    r = dist.get_rank(group)
    return x[r * k:(r + 1) * k]


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, backward):
        ctx.group, ctx.backward = group, backward
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.backward == "own":
            return _own(g, ctx.group).clone(), None, None
        return _scatter(g, ctx.group), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, op, group):
        y = _reduce(x, op, group)
        if op == "mean":
            y = y / dist.get_world_size(group)
        ctx.op, ctx.group = op, group
        if op == "max":
            ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        if ctx.op == "sum":
            return g, None, None
        if ctx.op == "mean":
            return g / dist.get_world_size(ctx.group), None, None
        x, y = ctx.saved_tensors
        held = (x == y).to(g.dtype)
        return g * held / _reduce(held, "sum", ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _scatter(x, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group), None


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        _split(x, group)
        ctx.group = group
        return _own(x, group).clone()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group), None


def all_gather(x: torch.Tensor, group=None, *,
               backward: str = "sum") -> torch.Tensor:
    """[n, ...] on each rank -> [D*n, ...] in rank order.  ``backward``:
    ``"sum"`` (reduce-scatter) or ``"own"`` (the rank's slice; for a
    replicated loss)."""
    if backward not in ("sum", "own"):
        raise ValueError(f"backward={backward!r}")
    return _AllGather.apply(x, group, backward)


def all_reduce(x: torch.Tensor, op: str = "sum",
               group=None) -> torch.Tensor:
    """The ranks' x reduced by ``op`` ("sum", "mean" or "max")."""
    if op not in _OPS:
        raise ValueError(f"op={op!r}")
    return _AllReduce.apply(x, op, group)


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """x [D*k, ...]: chunk d goes to rank d; returns [D*k, ...] whose chunk
    s came from rank s."""
    return _AllToAll.apply(x, group)


def reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """x [D*k, ...] summed over the ranks; rank r keeps chunk r."""
    return _ReduceScatter.apply(x, group)


def shard(x: torch.Tensor, group=None) -> torch.Tensor:
    """Rank r's chunk of a replicated x [D*k, ...]."""
    return _Shard.apply(x, group)


def gather_values(x: torch.Tensor, group=None) -> torch.Tensor:
    """``all_gather`` of a tensor that carries no gradient (integers,
    masks, flags)."""
    return _gather(x.detach(), group)


def reduce_values(x: torch.Tensor, op: str = "sum",
                  group=None) -> torch.Tensor:
    """``all_reduce`` of a tensor that carries no gradient."""
    y = _reduce(x.detach(), op, group)
    return y / dist.get_world_size(group) if op == "mean" else y

