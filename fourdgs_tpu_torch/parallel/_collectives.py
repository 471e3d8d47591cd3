"""Collectives over a mesh axis's process group, with gradients.

The sharded step's rule for gradients: every rank backpropagates its own
share of the loss, and the shares' parameter gradients are summed over all
ranks afterwards. A collective's backward is then its transpose: the
cotangents of the ranks that read its output are summed over the group
(JAX: the transposes shard_map takes for `all_gather` and `psum`).

A group of None (a one-rank mesh) makes each collective the identity.
PyTorch's gloo backend runs only `all_reduce` and `broadcast` on CUDA
tensors, so on gloo `all_gather` is an all_reduce (SUM) of a zero-filled
buffer into which each rank has written its slice: exact, since x + 0 = x.
NCCL takes `all_gather_into_tensor`.

Under NCCL every collective can be recorded into a CUDA graph
(train/graphs.py), forward and backward: each reads only host values
fixed for the group (its size and this rank's place in it), allocates
its output on the current stream (inside a capture, from the capture's
pool), and ProcessGroupNCCL records its launch into the capture. gloo
reduces CUDA tensors through the host, which no graph can hold: a
collective over a gloo group called while the current stream captures
raises.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _nccl(group) -> bool:
    return dist.get_backend(group) == "nccl"


def capturing() -> bool:
    """Whether the current CUDA stream is recording a graph."""
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def _capturable(group) -> None:
    if not _nccl(group) and capturing():
        raise RuntimeError(
            f"a collective over a {dist.get_backend(group)} group inside a "
            f"CUDA graph capture: gloo reduces through the host, which a "
            f"graph cannot record; capture a mesh over NCCL, or run it "
            f"eagerly (capture=False)")


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    _capturable(group)
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    """The group's x, concatenated along dim 0 in group-rank order."""
    _capturable(group)
    n, r, m = group_size(group), dist.get_rank(group), x.shape[0]
    x = x.contiguous()
    if _nccl(group):
        out = x.new_empty((n * m,) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        return out
    out = x.new_zeros((n * m,) + tuple(x.shape[1:]))
    out[r * m:(r + 1) * m] = x
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.m = group, x.shape[0]
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        r, m = dist.get_rank(ctx.group), ctx.m
        return _sum(g, ctx.group)[r * m:(r + 1) * m], None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _PMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        _capturable(group)
        out = x.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
        ctx.mark_non_differentiable(out)
        return out

    @staticmethod
    def backward(ctx, g):
        return None, None


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """x of every rank of `group`, concatenated along dim 0 (JAX:
    `all_gather(..., axis=0, tiled=True)`); its backward sums the
    cotangents over the group and keeps this rank's slice."""
    return x if group is None else _AllGather.apply(x, group)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over `group`; its backward is the same sum of the
    cotangents."""
    return x if group is None else _PSum.apply(x, group)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of x over `group`; no gradient."""
    return x if group is None else _PMax.apply(x, group)
