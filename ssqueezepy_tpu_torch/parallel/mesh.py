# -*- coding: utf-8 -*-
"""Device-mesh construction helpers.

Counterpart of `ssqueezepy_tpu/parallel/mesh.py`: a
`torch.distributed.device_mesh.DeviceMesh` over every rank of the world,
its dimensions named as the JAX mesh's axes, each dimension's process
group made with the backend of the world and a timeout of
`distributed.GROUP_TIMEOUT_S`. Every rank makes the same meshes in the
same order (each makes its groups collectively). The first mesh starts
the world (`init_distributed`) if no process group exists.
"""
import datetime

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..utils.common import resolve_device
from .distributed import GROUP_TIMEOUT_S, init_distributed, local_rank

__all__ = ['make_mesh', 'mesh_info', 'build_mesh', 'split_sizes',
           'mesh_device']


def _group_options(backend):
    """Process-group options carrying the groups' timeout."""
    if backend == 'nccl':
        opts = dist.ProcessGroupNCCL.Options()
    elif backend == 'gloo':
        opts = dist.ProcessGroupGloo._Options()
    else:
        return None
    opts._timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    return opts


def build_mesh(names, sizes, device_type='cuda'):
    """DeviceMesh of shape `sizes` over the world's ranks (row-major, as
    the JAX package reshapes its devices), dimensions named `names`. A
    CUDA mesh without a card raises."""
    device = resolve_device(device_type)
    init_distributed(device_type=device.type)
    world = dist.get_world_size()
    sizes = tuple(int(s) for s in sizes)
    n = 1
    for s in sizes:
        n *= s
    if n != world:
        raise ValueError("mesh %s of %d ranks in a world of %d"
                         % (dict(zip(names, sizes)), n, world))
    backend = dist.get_backend()
    opts = _group_options(backend)
    return init_device_mesh(device.type, sizes, mesh_dim_names=tuple(names),
                            backend_override={name: (backend, opts)
                                              for name in names})


def split_sizes(n, a, b):
    """(a, b) with a * b == n, a missing size taken from the other; with
    neither given all of n on the second, as the JAX package puts every
    device on 'scale' (or 'time')."""
    if a is None and b is None:
        return 1, n
    if a is None:
        return n // b, b
    if b is None:
        return a, n // a
    return a, b


def make_mesh(batch=None, scale=None, device_type='cuda'):
    """Mesh over ('batch', 'scale'). With no sizes given, puts all ranks
    on 'scale' (the CWT's natural tensor-parallel dimension: filterbank
    rows)."""
    init_distributed(device_type=device_type)
    return build_mesh(('batch', 'scale'),
                      split_sizes(dist.get_world_size(), batch, scale),
                      device_type)


def mesh_info(mesh):
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_device(mesh):
    """This rank's device on `mesh`: its card (`LOCAL_RANK % count`) for a
    CUDA mesh, else the CPU."""
    if mesh.device_type == 'cuda':
        resolve_device('cuda')
        return torch.device('cuda', local_rank() % torch.cuda.device_count())
    return torch.device('cpu')
