# -*- coding: utf-8 -*-
"""Process bootstrap of the sharded plans, and a host x card mesh.

Counterpart of `ssqueezepy_tpu/parallel/distributed.py`. The JAX package
is one process over many devices; this package runs one process per rank
under `torch.distributed`, each rank on its own device: a launcher such as
``torchrun --nproc-per-node=K script.py`` starts the processes and sets
`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE` and the rendezvous
address, and each process calls `init_distributed()` (or lets the first
mesh call it). Without `RANK` / `WORLD_SIZE` in the environment it starts
a world of one on a `FileStore` in a temporary directory, which is how
the JAX package degenerates on a single host.

`spawn` starts `world` ranks from one process
(`torch.multiprocessing.start_processes`, a `FileStore` in a temporary
directory, the join bounded by a timeout and the ranks killed when it
runs out): the tests' and `dryrun_multichip`'s way to run a world without
a launcher.
"""
import datetime
import os
import pickle
import tempfile
import time

import torch
import torch.distributed as dist

from ..utils.common import resolve_device

__all__ = ['init_distributed', 'make_host_chip_mesh', 'spawn', 'local_rank',
           'GROUP_TIMEOUT_S']

# wall-clock seconds after which a collective of a group that does not
# complete raises (every group this package makes)
GROUP_TIMEOUT_S = 300.


def local_rank():
    """This process's rank on its host: `LOCAL_RANK`, else its rank."""
    return int(os.environ.get('LOCAL_RANK',
                              dist.get_rank() if dist.is_initialized()
                              else 0))


def default_backend(device_type):
    return 'nccl' if torch.device(device_type).type == 'cuda' else 'gloo'


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, backend=None, device_type='cuda',
                     timeout=GROUP_TIMEOUT_S):
    """Start this rank's process group, once (a no-op when one exists).
    Returns (rank, world size).

    `coordinator_address` 'host:port' with `num_processes` and
    `process_id` rendezvous over TCP; else `RANK` and `WORLD_SIZE` in the
    environment (a launcher's `env://`); else a world of one. `backend`
    defaults to 'nccl' for `device_type='cuda'` and 'gloo' for 'cpu'; a
    CUDA rank takes the card `LOCAL_RANK % torch.cuda.device_count()`. A
    CUDA request without a card raises."""
    device = resolve_device(device_type)
    if not dist.is_initialized():
        backend = backend or default_backend(device.type)
        td = datetime.timedelta(seconds=timeout)
        if coordinator_address is not None:
            dist.init_process_group(
                backend, init_method='tcp://' + coordinator_address,
                world_size=num_processes, rank=process_id, timeout=td)
        elif 'RANK' in os.environ and 'WORLD_SIZE' in os.environ:
            dist.init_process_group(backend, init_method='env://',
                                    timeout=td)
        else:
            path = os.path.join(tempfile.mkdtemp(prefix='ssq_dist_'), 'store')
            dist.init_process_group(backend, store=dist.FileStore(path, 1),
                                    rank=0, world_size=1, timeout=td)
    if device.type == 'cuda':
        torch.cuda.set_device(local_rank() % torch.cuda.device_count())
    return dist.get_rank(), dist.get_world_size()


def make_host_chip_mesh(inner='scale', device_type='cuda'):
    """Mesh ('batch', `inner`) with the 'batch' axis across hosts and
    `inner` ('scale' or 'time') across each host's cards, so that the
    per-signal reductions stay inside a host; `LOCAL_WORLD_SIZE` ranks per
    host (all of them when unset). On one host this is (1, world)."""
    from .mesh import build_mesh
    if inner not in ('scale', 'time'):
        raise ValueError("inner must be 'scale' or 'time' (got %r)" % inner)
    init_distributed(device_type=device_type)
    world = dist.get_world_size()
    per_host = int(os.environ.get('LOCAL_WORLD_SIZE', world))
    return build_mesh(('batch', inner), (world // per_host, per_host),
                      device_type)


def _rank_main(rank, fn, world, args, backend, device_type, tmp, timeout):
    """Body of one spawned rank: its process group, `fn(rank, world,
    *args)`, and its result pickled to `tmp`/out<rank>."""
    os.environ['LOCAL_RANK'] = str(rank)
    if device_type == 'cpu':
        torch.set_num_threads(1)
    dist.init_process_group(
        backend or default_backend(device_type),
        init_method='file://' + os.path.join(tmp, 'store'), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout))
    try:
        if device_type == 'cuda':
            torch.cuda.set_device(rank % torch.cuda.device_count())
        out = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, 'out%d' % rank), 'wb') as f:
        pickle.dump(out, f)


def spawn(fn, world, args=(), backend=None, device_type='cpu', timeout=120.):
    """Run ``fn(rank, world, *args)`` on `world` new processes, one rank
    each, in one process group (`backend`, by default 'gloo' on the CPU
    and 'nccl' on CUDA; CPU ranks take one thread each). `fn` must be a
    function of an importable module that imports no more than the rank
    needs. Returns the ranks' results in rank order (picklable values,
    such as numpy arrays). A rank that raises ends every rank and raises
    RuntimeError with its traceback; a world that is not done within
    `timeout` seconds is killed and raises TimeoutError."""
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException
    with tempfile.TemporaryDirectory(prefix='ssq_spawn_') as tmp:
        ctx = mp.start_processes(
            _rank_main, (fn, world, tuple(args), backend, device_type, tmp,
                         timeout), nprocs=world, join=False, daemon=True)
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(max(deadline - time.monotonic(), 0.),
                               grace_period=1.):
                if time.monotonic() >= deadline:
                    raise TimeoutError("%d of %d ranks done after %.0f s" % (
                        world - len(ctx.sentinels), world, timeout))
        except ProcessException as e:
            raise RuntimeError("spawned rank failed: %s" % e) from None
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
        out = []
        for r in range(world):
            with open(os.path.join(tmp, 'out%d' % r), 'rb') as f:
                out.append(pickle.load(f))
    return out
