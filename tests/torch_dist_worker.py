# -*- coding: utf-8 -*-
"""Rank bodies of the port's multi-rank tests (`ssqueezepy_tpu_torch.
parallel` on gloo, on the CPU).

Each function here runs on every rank of a world that
`ssqueezepy_tpu_torch.parallel.distributed.spawn` starts, runs every leg
of one mesh shape, and returns rank 0's results as numpy (the other ranks
return None). A spawned rank imports the module that holds its function,
so this module imports torch, numpy and the port only: never JAX, nor
the tests' conftest. The signals are made here from seeds, and the test
files make the same ones for their references.
"""
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

G32 = ('gmw', {'dtype': 'float32'})
G64 = ('gmw', {'dtype': 'float64'})
SC3 = np.array([[2.], [5.], [12.5]])        # three log-spaced scales


def noise(shape, dtype=np.float32, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def chirps(N, B=2):
    """A chirp plus a little noise per row (the JAX time-sharded tests'
    signal)."""
    rng = np.random.default_rng(0)
    t = np.linspace(0, 6, N, endpoint=False)
    x = np.cos(2 * np.pi * 2 * np.exp(t / 2)).astype(np.float32)
    return np.stack([x + 0.05 * rng.standard_normal(N).astype(np.float32)
                     for _ in range(B)])


def tones(N=512):
    """Four rows of two tones: x, x reversed, -x and -x reversed."""
    t = np.linspace(0, 4, N, endpoint=False)
    x = (np.cos(2 * np.pi * 14 * t) +
         np.sin(2 * np.pi * 30 * t ** 1.2)).astype(np.float32)
    return np.stack([x, x[::-1], -x, -x[::-1]])


def _own(mesh, a, row_axis, n_rows):
    """This rank's shard of the global numpy `a`: its batch block and its
    `row_block` of the axis `row_axis`."""
    from ssqueezepy_tpu_torch.parallel.collectives import dim_size, row_block
    bl = a.shape[0] // dim_size(mesh, 'batch')
    b = mesh.get_local_rank('batch')
    lo, hi = row_block(n_rows, dim_size(mesh, 'scale'),
                       mesh.get_local_rank('scale'))
    a = a[b * bl:(b + 1) * bl]
    return np.take(a, np.arange(lo, hi), axis=row_axis)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t


def scale_world(rank, world, b, s):
    """Every ('batch', 'scale') leg on a (b, s) mesh."""
    from ssqueezepy_tpu_torch import parallel as par
    mesh = par.make_mesh(batch=b, scale=s, device_type='cpu')
    out = {'mesh': par.mesh_info(mesh)}
    x = noise((4, 512))
    Wx, sc = par.sharded_cwt(x, G32, 'log', nv=16, mesh=mesh)
    out['cwt'] = (_np(Wx), sc)
    Tx, Wx, sf, sc = par.sharded_ssq_cwt(x, G32, 'log', nv=16, mesh=mesh)
    out['ssq'] = (_np(Tx), _np(Wx), sf)
    Tx, Wx, *_ = par.sharded_ssq_cwt(noise((4, 256)), G32, 'log', nv=12,
                                      mesh=mesh)
    out['ssq_nv12'] = (_np(Tx), _np(Wx))
    Tx, Wx, *_ = par.sharded_ssq_cwt(noise((4, 512), np.float64), G64,
                                      'log-piecewise', nv=16, mesh=mesh)
    out['ssq_f64'] = (_np(Tx), _np(Wx))
    for sq in ('lebesgue', 'abs'):
        Tx, _, *_ = par.sharded_ssq_cwt(x, G32, 'log', nv=16, mesh=mesh,
                                        squeezing=sq)
        out['ssq_' + sq] = _np(Tx)
    # a wavelet off the CWT kernel's route: cwt_general, then B4
    Tx, Wx, *_ = par.sharded_ssq_cwt(x, ('morlet', {'dtype': 'float32'}),
                                      'log', nv=16, mesh=mesh)
    out['ssq_morlet'] = (_np(Tx), _np(Wx))
    # fewer rows than ranks: the last blocks are empty
    Tx, Wx, *_ = par.sharded_ssq_cwt(x, G32, SC3, nv=None, mesh=mesh)
    out['ssq_3rows'] = (_np(Tx), _np(Wx))
    out['cwt_3rows'] = _np(par.sharded_cwt(x, G32, SC3, nv=None,
                                           mesh=mesh)[0])
    Tx, Sx, *_ = par.sharded_ssq_stft(noise((4, 256), np.float64), 'hann',
                                      n_fft=6, mesh=mesh)
    out['stft_4rows'] = (_np(Tx), _np(Sx))

    xs = noise((4, 1024), np.float64)
    Tx, Sx, sf, sfs = par.sharded_ssq_stft(xs, n_fft=256, mesh=mesh)
    out['stft'] = (_np(Tx), _np(Sx), sf, sfs)
    tone = np.tile(np.cos(2 * np.pi * .12 * np.arange(1024)), (4, 1))
    for sq in ('sum', 'lebesgue'):
        Tx, _, sf, _ = par.sharded_ssq_stft(tone, n_fft=256, mesh=mesh,
                                            squeezing=sq)
        out['stft_tone_' + sq] = (_np(Tx), sf)
    p = par.ShardedSSQSTFT2(1024, n_fft=128, mesh=mesh, dtype='float32')
    Tx, Sx = p.gather(*p(noise((4, 1024), seed=2)))
    out['stft2'] = (_np(Tx), _np(Sx), p.ssq_freqs_out)
    p = par.ShardedSSQCWT2(512, G32, 'log', nv=16, mesh=mesh)
    Tx, Wx = p.gather(*p(x))
    out['cwt2'] = (_np(Tx), _np(Wx))

    # the inverses on the forward's shards
    xt = tones()
    for scales in ('log', 'log-piecewise', 'linear'):
        Wg, sc = par.sharded_cwt(xt, G32, scales, nv=16, mesh=mesh)
        out['icwt_' + scales] = par.sharded_icwt(
            _own(mesh, _np(Wg), 1, len(sc)), G32, scales=sc, mesh=mesh)
    p = par.ShardedSSQCWT(512, G32, 'log-piecewise', nv=16, mesh=mesh)
    Tx, _ = p(xt)
    out['issq'] = par.sharded_issq_cwt(Tx, G32, mesh=mesh)

    # a gradient step through the forward; x.grad summed over 'batch'.
    # With three scales over four 'scale' ranks the last block is empty.
    bl = x.shape[0] // b
    i = mesh.get_local_rank('batch')
    for name, scales, nv in (('log', 'log', 16), ('3rows', SC3, None)):
        xg = torch.as_tensor(x).requires_grad_()
        p = par.ShardedSSQCWT(512, G32, scales, nv=nv, mesh=mesh)
        Tx, _ = p(xg)
        ((Tx.real.sum(-2) - xg[i * bl:(i + 1) * bl]) ** 2).mean().backward()
        g = xg.grad.clone()
        dist.all_reduce(g, group=mesh.get_group('batch'))
        out['grad_' + name] = g.numpy()
        out['rows_' + name] = p.rows
    out['jax_imported'] = 'jax' in sys.modules
    return out if rank == 0 else None


def time_world(rank, world, b, t):
    """Every ('batch', 'time') leg on a (b, t) mesh."""
    from ssqueezepy_tpu_torch import parallel as par
    mesh = par.make_mesh_time(batch=b, time=t, device_type='cpu')
    B = max(2, b)
    out = {}
    x = chirps(4096, B)
    Wx, sc = par.time_sharded_cwt(x, G32, scales='log', nv=16, mesh=mesh)
    out['cwt'] = (_np(Wx), sc)
    for scales in ('log-piecewise', 'linear'):
        Wx, _ = par.time_sharded_cwt(x, G32, scales=scales, nv=16,
                                     mesh=mesh)
        out['cwt_' + scales] = _np(Wx)
    for scales in ('log', 'log-piecewise'):
        p = par.TimeShardedSSQCWT(4096, G32, scales=scales, nv=16,
                                  mesh=mesh)
        Tx, Wx, dWx = p.gather(*p(x))
        out['ssq_' + scales] = (_np(Tx), _np(Wx), _np(dWx))
    # the bins route (derivative=False): B1 on both kinds of rows, B2
    p = par.TimeShardedSSQCWT(4096, G32, scales='log', nv=16, mesh=mesh,
                              derivative=False)
    Tx, Wx = p.gather(*p(x))
    out['bins'] = (_np(Tx), _np(Wx))
    # a halo too small for the largest scales: exact rows
    p = par.TimeShardedSSQCWT(2048, G32, scales='log', nv=16, mesh=mesh,
                              halo=96)
    _, Wx, _ = p.gather(*p(chirps(2048, B)))
    out['small_halo'] = (_np(Wx), p.n_local, len(p.scales_np), p.n_lo)
    out['jax_imported'] = 'jax' in sys.modules
    return out if rank == 0 else None


def full_world(rank, world, b, s, t):
    """The three-axis legs on a (b, s, t) mesh."""
    from ssqueezepy_tpu_torch import parallel as par
    mesh = par.make_mesh3(batch=b, scale=s, time=t, device_type='cpu')
    out = {}
    x = chirps(2048, 2)
    for scales in ('log', 'log-piecewise'):
        p = par.FullShardedSSQCWT(2048, G32, scales, nv=16, mesh=mesh)
        out[scales], = (_np(a) for a in p.gather(p(x)))
    p = par.FullShardedSSQCWT(2048, G32, 'log', nv=8, mesh=mesh, halo=128)
    Tx, = p.gather(p(x))
    out['exact'] = (_np(Tx), p.n_exact)
    out['jax_imported'] = 'jax' in sys.modules
    return out if rank == 0 else None


def health_world(rank, world):
    """The heartbeat on a live world of two, then a stall: rank 1 misses
    two beats, which trips rank 0's monitor; it then issues them, and both
    recover."""
    from ssqueezepy_tpu_torch import parallel as par
    mesh = par.make_mesh(device_type='cpu')
    out = {}
    out['live'] = [par.collective_heartbeat(mesh, timeout=60.)
                   for _ in range(2)]
    tripped = []
    mon = par.HealthMonitor(mesh, interval=999, timeout=0.5, max_failures=2,
                            on_failure=lambda m: tripped.append(m.failures))
    dist.barrier()
    if rank == 0:
        out['stalled'] = [mon.poll_once() for _ in range(2)]
        out['tripped'] = list(tripped)
    else:
        time.sleep(2.)
        # the two beats rank 0 waits for
        for _ in range(2):
            par.collective_heartbeat(mesh, timeout=60.)
    dist.barrier()
    mon.timeout = 60.
    out['recovered'] = mon.poll_once()
    out['after'] = (mon.failures, mon.tripped, mon.last_latency is not None)
    return out if rank == 0 else None


def monitor_world(rank, world):
    """The monitor's thread beating on a live world of one."""
    from ssqueezepy_tpu_torch import parallel as par
    mesh = par.make_mesh(device_type='cpu')
    mon = par.HealthMonitor(mesh, interval=0.05, timeout=30.,
                            max_failures=99)
    mon.start()
    time.sleep(0.4)
    mon.stop()
    return mon.beats, mon.failures


def raise_on_one(rank, world):
    if rank == 1:
        raise ValueError("planted failure")
    return rank


def stall(rank, world):
    """Rank 0 waits in a collective that rank 1 never joins."""
    if rank == 0:
        dist.all_reduce(torch.ones(1))
    else:
        time.sleep(600)
