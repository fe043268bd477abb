# -*- coding: utf-8 -*-
"""The port's scale- and batch-sharded plans (`ssqueezepy_tpu_torch.
parallel`: `sharded.py`, `sharded_stft.py`, `sharded_order2.py`,
`inverse.py`, `mesh.py`, `distributed.py`, `collectives.py`) on gloo
ranks on the CPU, against two references on the same seeded input: the
JAX package's sharded plan on a mesh of the same shape (its 8 virtual CPU
devices), and the port's one-device call:

  * Wx/Sx within 1e-5 of max (float32) or 1e-9 (float64);
  * Tx by the bins criterion of `tests/test_sharded.py:76` (column sums
    within 1e-4 of max, energy within 5e-3);
  * the inverses on the forward's shards within 5e-4 of max of the
    one-device inverses, round trips at mad_rms < 0.1;
  * x.grad through the sharded forward (each rank's gradient of its
    batch rows, summed over 'batch') within 1e-5 of max of the one-device
    route's.

Each mesh shape, (1, 4), (2, 2) and (4, 1), is one world of four ranks
(`tests/torch_dist_worker.py::scale_world`, spawned once per module) that
runs every leg; the tests read its results. Also: `dryrun_multichip(4)`,
the single-host bootstrap and imports with `jax` blocked, the JAX names,
a CUDA mesh without a card, and `spawn`'s failure paths.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import ssqueezepy_tpu as jstq
from ssqueezepy_tpu import parallel as jpar
from ssqueezepy_tpu.toolkit import mad_rms

import ssqueezepy_tpu_torch as tstq
from ssqueezepy_tpu_torch import parallel as tpar
from ssqueezepy_tpu_torch.parallel.distributed import spawn
from torch_jax_reference import xla_reference  # noqa: F401
import torch_dist_worker as w

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {np.dtype('complex64'): 1e-5, np.dtype('complex128'): 1e-9}


def _np(c):
    if isinstance(c, torch.Tensor):
        return c.detach().cpu().numpy()
    if hasattr(c, 're'):
        return np.asarray(c.re) + 1j * np.asarray(c.im)
    return np.asarray(c)


def rel(a, b):
    a, b = _np(a), _np(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def bins_criterion(Tx, ref):
    Tx, ref = _np(Tx), _np(ref)
    m = max(np.abs(ref).max(), 1e-9)
    assert np.abs(Tx.sum(-2) - ref.sum(-2)).max() < 1e-4 * m
    e, e_ref = np.abs(Tx).sum(), np.abs(ref).sum()
    assert abs(e - e_ref) / e_ref < 5e-3


def close(W, ref):
    W = _np(W)
    assert W.shape == _np(ref).shape
    assert rel(W, ref) < TOL[W.dtype], rel(W, ref)


def spawn_with_cache(fn, world, args, tmp):
    """`spawn`, the ranks' plan memo on disk under `tmp`."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('SSQ_TPU_TORCH_CACHE', str(tmp))
        return spawn(fn, world, args, timeout=240.)


@pytest.fixture(scope='module', params=[(1, 4), (2, 2), (4, 1)],
                ids=lambda s: 'mesh%dx%d' % s)
def world(request, tmp_path_factory):
    res = spawn_with_cache(w.scale_world, 4, request.param,
                           tmp_path_factory.mktemp('plans'))[0]
    res['shape'] = request.param
    return res


def jmesh(shape):
    import jax
    b, s = shape
    return jpar.make_mesh(batch=b, scale=s, devices=jax.devices()[:b * s])


def one_device(fn, *a, **k):
    return fn(*a, device='cpu', **k)


def test_mesh_and_rows(world):
    b, s = world['shape']
    assert world['mesh'] == {'batch': b, 'scale': s}
    assert not world['jax_imported']
    na = len(jstq.process_scales('log', 512, jstq.Wavelet(w.G32), nv=16))
    assert world['rows_log'] == (0, -(-na // s))


def test_sharded_cwt(world):
    x = w.noise((4, 512))
    Wx, sc = world['cwt']
    Wj, scj = jpar.sharded_cwt(x, w.G32, 'log', nv=16,
                               mesh=jmesh(world['shape']))
    Wt, sct = one_device(tstq.cwt, x, w.G32, scales='log', nv=16)
    close(Wx, Wj)
    close(Wx, Wt)
    assert np.allclose(sc, scj) and np.allclose(sc, sct)


def test_sharded_ssq_cwt(world):
    x = w.noise((4, 512))
    Tx, Wx, sf = world['ssq']
    Tj, Wj, sfj, _ = jpar.sharded_ssq_cwt(x, w.G32, 'log', nv=16,
                                          mesh=jmesh(world['shape']))
    Tt, Wt, sft, _ = one_device(tstq.ssq_cwt, x, w.G32, scales='log', nv=16)
    close(Wx, Wj)
    close(Wx, Wt)
    bins_criterion(Tx, Tj)
    bins_criterion(Tx, Tt)
    assert np.allclose(sf, sfj) and np.allclose(sf, sft)


def test_scale_padding_nondivisible(world):
    """Row counts the 'scale' size does not divide: the last blocks are
    shorter (or empty)."""
    x = w.noise((4, 256))
    Tx, Wx = world['ssq_nv12']
    Tj, Wj, *_ = jpar.sharded_ssq_cwt(x, w.G32, 'log', nv=12,
                                      mesh=jmesh(world['shape']))
    Tt, Wt, *_ = one_device(tstq.ssq_cwt, x, w.G32, scales='log', nv=12)
    close(Wx, Wj)
    close(Wx, Wt)
    bins_criterion(Tx, Tj)
    bins_criterion(Tx, Tt)


def test_sharded_ssq_cwt_float64(world):
    x = w.noise((4, 512), np.float64)
    Tx, Wx = world['ssq_f64']
    Tj, Wj, *_ = jpar.sharded_ssq_cwt(x, w.G64, 'log-piecewise', nv=16,
                                      mesh=jmesh(world['shape']))
    Tt, Wt, *_ = one_device(tstq.ssq_cwt, x, w.G64, scales='log-piecewise',
                            nv=16)
    close(Wx, Wj)
    close(Wx, Wt)
    bins_criterion(Tx, Tj)
    bins_criterion(Tx, Tt)


@pytest.mark.parametrize('squeezing', ['lebesgue', 'abs'])
def test_sharded_squeezing(world, squeezing):
    """The JAX plan has no `squeezing`: the references are the one-device
    calls of both packages."""
    x = w.noise((4, 512))
    Tx = world['ssq_' + squeezing]
    Tj, *_ = jstq.ssq_cwt(x, w.G32, scales='log', nv=16,
                          squeezing=squeezing, astensor=False)
    Tt, *_ = one_device(tstq.ssq_cwt, x, w.G32, scales='log', nv=16,
                        squeezing=squeezing)
    bins_criterion(Tx, Tj)
    bins_criterion(Tx, Tt)


def test_sharded_ssq_cwt_off_kernel_wavelet(world):
    """Morlet, off the CWT kernel's route: `cwt_general` on the block,
    then B4."""
    x = w.noise((4, 512))
    mor = ('morlet', {'dtype': 'float32'})
    Tx, Wx = world['ssq_morlet']
    Tj, Wj, *_ = jpar.sharded_ssq_cwt(x, mor, 'log', nv=16,
                                      mesh=jmesh(world['shape']))
    Tt, Wt, *_ = one_device(tstq.ssq_cwt, x, mor, scales='log', nv=16)
    close(Wx, Wj)
    close(Wx, Wt)
    bins_criterion(Tx, Tj)
    bins_criterion(Tx, Tt)


def test_fewer_rows_than_ranks(world):
    """Three scales (four STFT rows) over up to four 'scale' ranks: the
    last blocks empty, their ranks launching nothing and adding zeros."""
    x = w.noise((4, 512))
    Tx, Wx = world['ssq_3rows']
    Tj, Wj, *_ = jpar.sharded_ssq_cwt(x, w.G32, w.SC3, nv=None,
                                      mesh=jmesh(world['shape']))
    Tt, Wt, *_ = one_device(tstq.ssq_cwt, x, w.G32, scales=w.SC3)
    for W in (Wx, world['cwt_3rows']):
        close(W, Wj)
        close(W, Wt)
    bins_criterion(Tx, Tj)
    bins_criterion(Tx, Tt)
    xs = w.noise((4, 256), np.float64)
    Tx, Sx = world['stft_4rows']
    Tj, Sj, *_ = jpar.sharded_ssq_stft(xs, 'hann', n_fft=6,
                                       mesh=jmesh(world['shape']))
    Tt, St, *_ = one_device(tstq.ssq_stft, xs, 'hann', n_fft=6)
    for S, T in ((Sj, Tj), (St, Tt)):
        close(Sx, S)
        bins_criterion(Tx, T)


def test_sharded_ssq_stft(world):
    """129 rows over 4 row shards: the last block shorter."""
    x = w.noise((4, 1024), np.float64)
    Tx, Sx, sf, sfs = world['stft']
    Tj, Sj, sfj, sfsj = jpar.sharded_ssq_stft(x, n_fft=256,
                                              mesh=jmesh(world['shape']))
    Tt, St, sft, sfst = one_device(tstq.ssq_stft, x, n_fft=256)
    close(Sx, Sj)
    close(Sx, St)
    bins_criterion(Tx, Tj)
    bins_criterion(Tx, Tt)
    assert np.allclose(sf, sfj) and np.allclose(sf, sft)
    assert np.allclose(sfs, sfsj) and np.allclose(sfs, sfst)


@pytest.mark.parametrize('squeezing', ['sum', 'lebesgue'])
def test_sharded_ssq_stft_tone_ridge(world, squeezing):
    """A pure tone reassigns onto its row on every layout. 'lebesgue' sums
    one quantum, const / (the transform's rows), into each cell above the
    gamma gate, as the one-device calls do (the JAX plan sums const / (its
    block's rows)); the tone's near-empty rows sit at the gate, where
    rounding moves cells across it, so that mode is held by its ridge and
    its quantum."""
    N = 1024
    tone = np.tile(np.cos(2 * np.pi * .12 * np.arange(N)), (4, 1))
    Tx, sf = world['stft_tone_' + squeezing]
    Ts, *_ = jpar.sharded_ssq_stft(tone, n_fft=256, squeezing=squeezing,
                                   mesh=jmesh(world['shape']))
    if squeezing == 'sum':
        Tt, *_ = one_device(tstq.ssq_stft, tone, n_fft=256)
        bins_criterion(Tx, Ts)
        bins_criterion(Tx, Tt)
    else:
        q = (sf[1] - sf[0]) / 129
        assert np.allclose(Tx.real / q, np.round(Tx.real / q), atol=1e-3)
        assert not Tx.imag.any()
    k_true = int(np.argmin(np.abs(np.asarray(sf) - .12)))
    for T in (Tx, Ts):
        ridge = np.abs(_np(T)[0])[:, N // 4:3 * N // 4].sum(-1)
        assert abs(int(np.argmax(ridge)) - k_true) <= 1


def test_sharded_ssq_stft2(world):
    x = w.noise((4, 1024), seed=2)
    Tx, Sx, sf = world['stft2']
    pj = jpar.ShardedSSQSTFT2(1024, n_fft=128, mesh=jmesh(world['shape']),
                              dtype='float32')
    Tj, Sj = pj(x)
    Tt, St, sft, _ = one_device(tstq.ssq_stft2, x, n_fft=128,
                                dtype='float32')
    close(Sx, Sj)
    close(Sx, St)
    bins_criterion(Tx, Tj)
    bins_criterion(Tx, Tt)
    assert np.allclose(sf, pj.ssq_freqs_out) and np.allclose(sf, sft)


def test_sharded_ssq_cwt2(world):
    x = w.noise((4, 512))
    Tx, Wx = world['cwt2']
    Tj, Wj = jpar.ShardedSSQCWT2(512, w.G32, 'log', nv=16,
                                 mesh=jmesh(world['shape']))(x)
    Tt, Wt, *_ = one_device(tstq.ssq_cwt2, x, w.G32, scales='log', nv=16)
    close(Wx, Wj)
    close(Wx, Wt)
    bins_criterion(Tx, Tj)
    bins_criterion(Tx, Tt)


def test_sharded_prime_length(world):
    """`padtype=None` at N = 521 (a prime): every block on the general
    route (`cwt_general`, `wsst2_general`), against the one-device port
    (held against the JAX package in tests/test_torch_prime_length.py)."""
    x = w.noise((4, 521))
    kw = dict(wavelet=w.G32, scales='log', nv=16, padtype=None)
    close(world['cwt_prime'], one_device(tstq.cwt, x, **kw)[0])
    for name, fn in (('ssq_prime', tstq.ssq_cwt),
                     ('cwt2_prime', tstq.ssq_cwt2)):
        Tx, Wx = world[name]
        Tt, Wt, *_ = one_device(fn, x, **kw)
        close(Wx, Wt)
        bins_criterion(Tx, Tt)


@pytest.mark.parametrize('scales', ['log', 'log-piecewise', 'linear'])
def test_sharded_icwt_roundtrip(world, scales):
    xb = w.tones()
    xr = world['icwt_' + scales]
    Wj, scj = jpar.sharded_cwt(xb, w.G32, scales, nv=16,
                               mesh=jmesh(world['shape']))
    xj = jpar.sharded_icwt(Wj, w.G32, scales=scj, mesh=jmesh(world['shape']))
    assert xr.shape == xb.shape
    assert rel(xr, xj) < 5e-4
    for b in range(len(xb)):
        Wt, sct = one_device(tstq.cwt, xb[b], w.G32, scales=scales, nv=16)
        xt = tstq.icwt(Wt, w.G32, scales=sct, one_int=True)
        assert np.abs(xr[b] - xt).max() < 5e-4 * max(1., np.abs(xt).max())
        if scales != 'linear':
            assert mad_rms(xb[b], xr[b]) < .1
        else:
            # the one-integral inverse on a linear grid is poor for this
            # signal on every path: parity, not quality
            assert abs(mad_rms(xb[b], xr[b]) - mad_rms(xb[b], xt)) < 1e-3


def test_sharded_issq_cwt_roundtrip(world):
    xb = w.tones()
    xr = world['issq']
    Tj, *_ = jpar.sharded_ssq_cwt(xb, w.G32, 'log-piecewise', nv=16,
                                  mesh=jmesh(world['shape']))
    xj = jpar.sharded_issq_cwt(Tj, w.G32, mesh=jmesh(world['shape']))
    assert rel(xr, xj) < 5e-4
    for b in range(len(xb)):
        Tt, *_ = one_device(tstq.ssq_cwt, xb[b], w.G32, nv=16,
                            scales='log-piecewise')
        xt = tstq.issq_cwt(Tt, w.G32)
        assert np.abs(xr[b] - xt).max() < 5e-4 * max(1., np.abs(xt).max())
        assert mad_rms(xb[b], xr[b]) < .1


@pytest.mark.parametrize('scales', ['log', '3rows'])
def test_sharded_grad(world, scales):
    """x.grad through the sharded forward (the kernels' autograd Functions,
    the sum over 'scale' passing its cotangent on, the input's summing
    the scale blocks' parts) against the one-device route's; with three
    scales, a rank of the (1, 4) mesh holds no rows and takes part in the
    backward's collectives all the same."""
    b = world['shape'][0]
    x1 = torch.as_tensor(w.noise((4, 512))).requires_grad_()
    sc, nv = ('log', 16) if scales == 'log' else (w.SC3, None)
    Tx, *_ = one_device(tstq.ssq_cwt, x1, w.G32, scales=sc, nv=nv)
    bl = 4 // b
    sum(((Tx[i:i + bl].real.sum(-2) - x1[i:i + bl]) ** 2).mean()
        for i in range(0, 4, bl)).backward()
    g = world['grad_' + scales]
    assert np.isfinite(g).all()
    assert rel(g, x1.grad) < 1e-5, rel(g, x1.grad)


def test_dryrun_multichip():
    assert tpar.dryrun_multichip(4)


def test_names_match_jax():
    assert tpar.__all__ == jpar.__all__
    for name in jpar.__all__:
        assert hasattr(tpar, name)


def test_single_host_bootstrap_imports_no_jax():
    """With `jax` and `ssqueezepy_tpu` blocked: importing starts no process
    group; `init_distributed()` without RANK / WORLD_SIZE starts a world
    of one; the host x card mesh is (1, 1) with the JAX axis names."""
    code = r"""
import os, sys
sys.modules['jax'] = None
sys.modules['ssqueezepy_tpu'] = None
for k in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'LOCAL_WORLD_SIZE'):
    os.environ.pop(k, None)
import torch.distributed as dist
from ssqueezepy_tpu_torch import parallel as par
assert not dist.is_initialized()
assert par.init_distributed(device_type='cpu') == (0, 1)
m = par.make_host_chip_mesh('scale', device_type='cpu')
assert m.mesh_dim_names == ('batch', 'scale') and tuple(m.shape) == (1, 1)
m = par.make_host_chip_mesh('time', device_type='cpu')
assert m.mesh_dim_names == ('batch', 'time')
assert par.mesh_info(par.make_mesh(device_type='cpu')) == {'batch': 1,
                                                          'scale': 1}
assert 'jax' not in {n.split('.')[0] for n in sys.modules if sys.modules[n]}
dist.destroy_process_group()
print('ok')
"""
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.split()[-1] == 'ok', \
        out.stderr


def test_cuda_mesh_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for make in (tpar.make_mesh, tpar.make_mesh_time, tpar.make_mesh3):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            make(device_type='cuda')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tpar.init_distributed()
    assert not torch.distributed.is_initialized()


def test_spawn_reports_a_failed_rank():
    with pytest.raises(RuntimeError, match='planted failure'):
        spawn(w.raise_on_one, 2, timeout=60.)


def test_spawn_ends_a_stuck_collective():
    with pytest.raises(TimeoutError):
        spawn(w.stall, 2, timeout=5.)
