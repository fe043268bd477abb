# -*- coding: utf-8 -*-
"""The collectives of the sharded plans, on `torch.distributed`.

The JAX package runs one program over a device mesh (`shard_map` with
`psum`, `all_gather` and a ring `ppermute`); this package runs one process
per rank, and each plan issues these collectives on the process groups of
its `DeviceMesh`'s dimensions:

  * `psum`: the sum of a partial result over a group (`all_reduce`; a
    complex tensor through `torch.view_as_real`), the reduction of the
    synchrosqueezed bins over 'scale' and of the inverses' scale sums;
  * `all_gather`: the shards of a group concatenated along an axis (the
    time plans' halo edges and their exact rows' signal);
  * `gather_shards`: a plan's output put together on every rank, the
    shards padded to one block length and cut back;
  * `replicated_in`: the identity on an input that every rank of a group
    holds, whose backward sums the cotangent over the group.

Where autograd records, `psum` and `replicated_in` run as
`torch.autograd.Function`s, the pair a tensor-parallel layer uses: the
sum over 'scale' is replicated on every rank of the group, which each
differentiates as its own copy, so its backward passes the cotangent on
unchanged, and the input's backward sums the ranks' parts of the
gradient. x.grad of a rank is then the one-device gradient of its batch
rows (`torch.distributed.nn.functional.all_reduce` sums the cotangent in
its backward too, which would count the replicated loss once per rank).

Every collective runs on the group's own backend with the tensors where
they are: NCCL takes CUDA tensors, and gloo takes CPU tensors and (in
PyTorch 2.11) CUDA tensors for `all_reduce` and `all_gather` alike, so
nothing is staged through host memory.
"""
import torch
import torch.distributed as dist

__all__ = ['psum', 'replicated_in', 'all_gather', 'gather_shards',
           'row_block', 'dim_size']


def _all_reduce_(t, group):
    """Sum the contiguous tensor `t` over `group` in place; returns it."""
    dist.all_reduce(torch.view_as_real(t) if t.is_complex() else t,
                    group=group)
    return t


class _Psum(torch.autograd.Function):
    """Sum over `group`; the cotangent of the replicated sum passes on."""

    @staticmethod
    def forward(ctx, t, group):
        return _all_reduce_(t.clone(memory_format=torch.contiguous_format),
                            group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReplicatedIn(torch.autograd.Function):
    """Identity; the backward sums the cotangent over `group`."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.clone(memory_format=torch.contiguous_format),
                            ctx.group), None


def _records(t):
    return torch.is_grad_enabled() and t.requires_grad


def psum(t, group):
    """Sum of the partial result `t` over the ranks of `group`, the same
    tensor on each of them. Without autograd `t` is summed in place."""
    if _records(t):
        return _Psum.apply(t, group)
    return _all_reduce_(t.contiguous(), group)


def replicated_in(t, group):
    """`t`, an input that every rank of `group` holds alike, entering work
    that each rank does in part: the backward sums its gradient over the
    group. `t` itself where autograd does not record."""
    return _ReplicatedIn.apply(t, group) if _records(t) else t


def all_gather(t, group, axis):
    """The ranks' tensors `t` (one shape on every rank of `group`),
    concatenated along `axis` in rank order; `t` itself in a group of one
    (the gather and its concatenation would copy it twice)."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    t = t.contiguous()
    r = torch.view_as_real(t) if t.is_complex() else t
    parts = [torch.empty_like(r) for _ in range(n)]
    dist.all_gather(parts, r, group=group)
    if t.is_complex():
        parts = [torch.view_as_complex(p) for p in parts]
    return torch.cat(parts, dim=axis)


def row_block(n, parts, i):
    """(lo, hi): shard `i` of `parts` of n rows, ceil(n / parts) rows each,
    the last ones shorter or empty (the JAX package's `_pad_scales` blocks
    without their padded rows)."""
    size = -(-n // parts)
    lo = min(i * size, n)
    return lo, min(lo + size, n)


def dim_size(mesh, name):
    """Size of the dimension `name` of `mesh`."""
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def gather_shards(t, mesh, dims):
    """The global tensor of the shards `t` on every rank of `mesh`: `dims`
    maps each sharded mesh dimension to (tensor axis, global length); each
    shard holds its `row_block` of that axis."""
    for name, (axis, size) in dims.items():
        n = dim_size(mesh, name)
        block = -(-size // n)
        axis = axis % t.dim()
        short = block - t.shape[axis]
        if short:
            pad = list(t.shape)
            pad[axis] = short
            t = torch.cat([t, t.new_zeros(pad)], dim=axis)
        t = all_gather(t, mesh.get_group(name), axis).narrow(axis, 0, size)
    return t
