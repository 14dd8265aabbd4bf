# -*- coding: utf-8 -*-
"""Collectives over a mesh axis, with the transposes ``shard_map`` gives
them.

Each rank of an axis holds its own value of a tensor ("varying", in the
JAX package's terms) unless a reduction has made it the same on every rank.
What is differentiated here is a function of a *replicated* input (the
hyperparameters) whose value every rank of the axis computes from its own
shard and ends with :func:`pmean`.  The rules that make its gradient right:

* :func:`pvary` — a replicated tensor entering code that runs on shards:
  the identity forward; backward, the cotangents of the ranks summed (each
  rank's is its shard's part of the gradient);
* :func:`all_gather` — the shards concatenated along ``dim``; backward,
  each rank gets its slice of the cotangent summed over the axis;
* :func:`psum` — the sum over the axis, the same on every rank; backward,
  the cotangents summed over the axis (its exact transpose: its result
  feeds code that runs on shards);
* :func:`pmean` — the mean over the axis that ends a sharded function; its
  result and cotangent are the same on every rank, so backward gives each
  rank the cotangent over the axis size.  Seeding the cotangent 1 on every
  rank then counts the function once, not once a rank.

A rank's part of a collective must take part in autograd as the other
ranks' parts do (computed by the same operations from the same inputs,
zeros included): autograd runs a collective's backward only where it
leads to an input that asks for a gradient, and the ranks' backward
passes must make the same collectives in the same order.

Reductions gather the ranks' tensors and sum them in index order on every
rank: each rank gets the same bits whatever the backend's algorithm (the
backward of :func:`all_gather`, whose cotangent may be a whole covariance
matrix, uses the backend's ``all_reduce`` instead).  Every transfer goes
through :func:`gather_stack` or :func:`all_reduce_sum`.  The gloo backend
takes CUDA tensors through pinned host memory (a transport; all
arithmetic stays on the card); NCCL takes them directly.
"""

import torch
import torch.distributed as dist

__all__ = ["gather_stack", "all_reduce_sum", "all_gather", "psum", "pmean",
           "pvary", "pmax"]


def _stages(t, axis):
    return t.device.type != "cpu" and dist.get_backend(axis.group) == "gloo"


def gather_stack(x, axis):
    """Every rank's ``x`` stacked in index order: (axis.size, *x.shape).
    Not differentiable (the Functions below are)."""
    t = x.detach()
    is_bool = t.dtype == torch.bool
    if is_bool:
        t = t.to(torch.uint8)
    t = t.contiguous()
    staged = _stages(t, axis)
    if staged:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        out = torch.empty((axis.size,) + tuple(t.shape), dtype=t.dtype,
                          pin_memory=True)
        dist.all_gather(list(out.unbind(0)), host, group=axis.group)
        out = out.to(x.device)
    else:
        out = t.new_empty((axis.size,) + tuple(t.shape))
        dist.all_gather(list(out.unbind(0)), t, group=axis.group)
    return out.to(torch.bool) if is_bool else out


def _sum_over(x, axis):
    return torch.sum(gather_stack(x, axis), dim=0)


def all_reduce_sum(x, axis):
    """The backend's ``all_reduce`` sum of ``x`` over the axis (a new
    tensor; not differentiable)."""
    t = x.detach().contiguous()
    if _stages(t, axis):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        dist.all_reduce(host, group=axis.group)
        return host.to(x.device)
    total = t.clone()
    dist.all_reduce(total, group=axis.group)
    return total


class _AllGather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        parts = gather_stack(x, axis)
        return torch.cat(tuple(parts), dim=dim)

    @staticmethod
    def backward(ctx, g):
        total = all_reduce_sum(g, ctx.axis)
        return (torch.narrow(total, ctx.dim, ctx.axis.index * ctx.n, ctx.n),
                None, None)


class _Psum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _sum_over(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g, ctx.axis), None


class _Pmean(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, axis):
        ctx.size = axis.size
        return _sum_over(x, axis) / axis.size

    @staticmethod
    def backward(ctx, g):
        return g / ctx.size, None


class _Pvary(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g, ctx.axis), None


def all_gather(x, axis, dim=0):
    """The ranks' ``x`` concatenated along ``dim`` in index order (JAX's
    ``all_gather(..., tiled=True)``)."""
    return _AllGather.apply(x, axis, dim)


def psum(x, axis):
    return _Psum.apply(x, axis)


def pmean(x, axis):
    return _Pmean.apply(x, axis)


def pvary(x, axis):
    return _Pvary.apply(x, axis)


def pmax(x, axis):
    """The elementwise maximum over the axis (not differentiable)."""
    return torch.amax(gather_stack(x, axis), dim=0)
