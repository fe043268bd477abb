# -*- coding: utf-8 -*-
"""The port's time-sharded and three-axis plans (`ssqueezepy_tpu_torch.
parallel.time_sharded`, `full_sharded`) on gloo ranks on the CPU, against
two references on the same seeded chirps: the JAX package's plan on a mesh
of the same shape (its 8 virtual CPU devices), and the port's one-device
call. Overlap-save equals the global transform up to the wavelet's tail
beyond the halo, so the planes are compared on interior columns, trimmed
as the JAX package's tests trim them:

  * Wx within 5e-3 of max (1e-3 for the scale types of
    `tests/test_time_sharded.py:98`), the exact rows of a small halo
    within 2e-5;
  * Tx by its column sums (the inversion integrals) within 5e-3 of max,
    and the fraction of cells that differ by more than 6e-3;
  * round trips at mad_rms < 0.1.

Time meshes (1, 2), (2, 2) and (1, 4), three-axis meshes (1, 2, 2) and
(2, 2, 2): one spawned world each (`tests/torch_dist_worker.py`), every
leg run once.
"""
import numpy as np
import pytest
import torch

import ssqueezepy_tpu as jstq
from ssqueezepy_tpu import parallel as jpar
from ssqueezepy_tpu.parallel.time_sharded import _next_fft_len

import ssqueezepy_tpu_torch as tstq
from ssqueezepy_tpu_torch.ops.fft import next_fft_len
from ssqueezepy_tpu_torch.parallel.distributed import spawn
from torch_jax_reference import xla_reference  # noqa: F401
import torch_dist_worker as w


def _np(c):
    if isinstance(c, torch.Tensor):
        return c.detach().cpu().numpy()
    if hasattr(c, 're'):
        return np.asarray(c.re) + 1j * np.asarray(c.im)
    return np.asarray(c)


def rel(a, b, m=0):
    """max |a - b| / max |b| over columns [m, N - m)."""
    a, b = _np(a), _np(b)
    if m:
        a, b = a[..., m:-m], b[..., m:-m]
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def colsums(Tx, ref, m=0, tol=5e-3):
    Tx, ref = _np(Tx), _np(ref)
    assert Tx.shape == ref.shape
    assert rel(Tx.real.sum(-2), ref.real.sum(-2), m) < tol


def few_cells_differ(Tx, ref):
    """At most 0.01% of cells move by more than 6e-3: float32 bin-boundary
    flips (the JAX package's criterion, `tests/test_full_sharded.py:37`)."""
    assert (np.abs(_np(Tx) - _np(ref)) > 6e-3).mean() < 1e-4


def spawned(fn, world, args, tmp):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('SSQ_TPU_TORCH_CACHE', str(tmp))
        return spawn(fn, world, args, timeout=240.)[0]


@pytest.fixture(scope='module', params=[(1, 2), (2, 2), (1, 4)],
                ids=lambda s: 'time%dx%d' % s)
def tworld(request, tmp_path_factory):
    b, t = request.param
    res = spawned(w.time_world, b * t, (b, t),
                  tmp_path_factory.mktemp('plans'))
    res['shape'] = request.param
    return res


@pytest.fixture(scope='module', params=[(1, 2, 2), (2, 2, 2)],
                ids=lambda s: 'mesh%dx%dx%d' % s)
def fworld(request, tmp_path_factory):
    res = spawned(w.full_world, int(np.prod(request.param)), request.param,
                  tmp_path_factory.mktemp('plans'))
    res['shape'] = request.param
    return res


def jmesh_time(shape):
    import jax
    b, t = shape
    return jpar.make_mesh_time(batch=b, time=t, devices=jax.devices()[:b * t])


def jmesh3(shape):
    import jax
    b, s, t = shape
    return jpar.make_mesh3(batch=b, scale=s, time=t,
                           devices=jax.devices()[:b * s * t])


def signal(tworld, N=4096):
    return w.chirps(N, max(2, tworld['shape'][0]))


def test_time_sharded_cwt_matches_unsharded(tworld):
    x = signal(tworld)
    Wx, sc = tworld['cwt']
    Wj, scj = jpar.time_sharded_cwt(x, w.G32, scales='log', nv=16,
                                    mesh=jmesh_time(tworld['shape']))
    Wt, sct = tstq.cwt(x, w.G32, scales='log', nv=16, device='cpu')
    assert np.allclose(sc, scj) and np.allclose(sc, sct)
    assert Wx.shape == _np(Wt).shape
    assert rel(Wx, Wj, 64) < 5e-3
    assert rel(Wx, Wt, 64) < 5e-3
    assert not tworld['jax_imported']


@pytest.mark.parametrize('scales', ['log-piecewise', 'linear'])
def test_time_sharded_cwt_scaletypes(tworld, scales):
    x = signal(tworld)
    Wx = tworld['cwt_' + scales]
    Wj, _ = jpar.time_sharded_cwt(x, w.G32, scales=scales, nv=16,
                                  mesh=jmesh_time(tworld['shape']))
    Wt, _ = tstq.cwt(x, w.G32, scales=scales, nv=16, device='cpu')
    assert rel(Wx, Wj, 64) < 1e-3
    assert rel(Wx, Wt, 64) < 1e-3


@pytest.mark.parametrize('scales', ['log', 'log-piecewise'])
def test_time_sharded_ssq_cwt_reconstructs(tworld, scales):
    x = signal(tworld)
    Tx, Wx, dWx = tworld['ssq_' + scales]
    Tj, Wj, dWj = jpar.TimeShardedSSQCWT(
        4096, w.G32, scales=scales, nv=16,
        mesh=jmesh_time(tworld['shape']))(x)
    Tt, Wt, *_, dWt = tstq.ssq_cwt(x, w.G32, scales=scales, nv=16,
                                   get_dWx=True, device='cpu')
    for b in range(len(x)):
        assert jstq.toolkit.mad_rms(x[b], tstq.issq_cwt(Tx[b], w.G32)) < .1
    colsums(Tx, Tj, 256)
    colsums(Tx, Tt, 256)
    for W, ref in ((Wx, Wj), (Wx, Wt), (dWx, dWj), (dWx, dWt)):
        assert rel(W, ref, 64) < 5e-3


def test_time_sharded_bins_route(tworld):
    """`derivative=False`: the bins mode (B1 / B3b) on the interior and
    exact rows, the merged bins, B2; the same Wx as the derivative route
    and its Tx by the column sums."""
    x = signal(tworld)
    Tb, Wb = tworld['bins']
    Tx, Wx, _ = tworld['ssq_log']
    assert rel(Wb, Wx) < 1e-5
    colsums(Tb, Tx, 0, 1e-4)
    Tt, *_ = tstq.ssq_cwt(x, w.G32, scales='log', nv=16, device='cpu')
    colsums(Tb, Tt, 256)


def test_time_sharded_small_halo_triggers_allgather(tworld):
    """A halo too small for the largest scales sends them to the exact
    rows (all-gathered signal); those rows equal the global transform."""
    x = w.chirps(2048, max(2, tworld['shape'][0]))
    Wx, n_local, na, n_lo = tworld['small_halo']
    assert 0 < n_local < na
    Wt, _ = tstq.cwt(x, w.G32, scales='log', nv=16, device='cpu')
    Wj = jpar.TimeShardedSSQCWT(2048, w.G32, scales='log', nv=16, halo=96,
                                mesh=jmesh_time(tworld['shape']))(x)[1]
    for ref in (Wt, Wj):
        ref = _np(ref)
        assert rel(Wx, ref, 64) < 2e-3
        assert rel(Wx[..., n_local:, :], ref[..., n_local:, :]) < 2e-5
        assert rel(Wx[..., :n_lo, :], ref[..., :n_lo, :]) < 2e-5


def test_next_fft_len_matches_jax():
    """The time plans' extended length: the JAX package's `_next_fft_len`
    of `parallel/time_sharded.py`, 2^a {1, 3, 5, 9, 15}, 7-smooth."""
    for n in range(1, 20000, 7):
        assert next_fft_len(n) == _next_fft_len(n)


@pytest.mark.parametrize('scales', ['log', 'log-piecewise'])
def test_full_sharded_matches_unsharded(fworld, scales):
    x = w.chirps(2048, 2)
    Tx = fworld[scales]
    Tj = jpar.FullShardedSSQCWT(2048, w.G32, scales, nv=16,
                                mesh=jmesh3(fworld['shape']))(x)
    Tt, *_ = tstq.ssq_cwt(x, w.G32, scales=scales, nv=16, device='cpu')
    for ref in (Tj, Tt):
        few_cells_differ(Tx, ref)
        colsums(Tx, ref)
    assert not fworld['jax_imported']


def test_full_sharded_reconstructs(fworld):
    x = w.chirps(2048, 2)
    for b in range(2):
        xr = tstq.issq_cwt(fworld['log'][b], w.G32)
        assert jstq.toolkit.mad_rms(x[b], xr) < .1


def test_full_sharded_exact_rows_replicated(fworld):
    """A small halo: exact rows, replicated over 'scale' with their
    constant divided by its size."""
    x = w.chirps(2048, 2)
    Tx, n_exact = fworld['exact']
    assert n_exact > 0
    Tj = jpar.FullShardedSSQCWT(2048, w.G32, 'log', nv=8, halo=128,
                                mesh=jmesh3(fworld['shape']))(x)
    Tt, *_ = tstq.ssq_cwt(x, w.G32, scales='log', nv=8, device='cpu')
    for ref in (Tj, Tt):
        colsums(Tx, ref)
