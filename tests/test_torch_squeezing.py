# -*- coding: utf-8 -*-
"""The port's synchrosqueezing routes through the generic scatter (B5)
and every squeezing option of `ssqueeze` and `ssq_cwt` (device='cpu',
i.e. the kernels' plain PyTorch versions) against the JAX package on the
CPU:

  * `ssqueeze` from a precomputed `w`, and with 'lebesgue', 'abs' and a
    callable squeezing (the phase transform of the raw Wx, then the
    generic scatter), for the CWT (one signal and a batch) and the STFT;
  * `ssq_cwt(get_dWx=True)` with 'lebesgue' and 'abs', one signal and a
    batch; `ssq_cwt(get_w=True)` with difftype 'trig' and 'phase';
  * `ssq_cwt` with a callable squeezing (the port's bins route against
    the JAX package's compositional route);
  * the property the JAX package's tests/test_option_grid.py checks: the
    `get_w` route's Tx equals the fast route's.

Tolerances: float64 planes (Wx, w, Tx) within 1e-9 of their max where
both sides run the same route; Tx by the bins criterion (column sums
within 1e-4 of max, energy within 5e-3) in float32, and where the port's
route differs from the JAX package's (bins from the CWT kernel against
bins from an explicit w) even in float64.
"""
import numpy as np
import pytest
import torch

import ssqueezepy_tpu as jstq
from ssqueezepy_tpu.ops.complexlib import Complex
from ssqueezepy_tpu.ops.phase import phase_cwt as jphase_cwt

import ssqueezepy_tpu_torch as tstq
from ssqueezepy_tpu_torch.models.cwt import resolve_wavelet
from torch_jax_reference import xla_reference  # noqa: F401


def _np(c):
    if isinstance(c, torch.Tensor):
        return c.numpy()
    if isinstance(c, Complex):
        return np.asarray(c.re) + 1j * np.asarray(c.im)
    return np.asarray(c)


def _rel(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    return np.abs(a - b).max() / np.abs(b).max()


def _bins_criterion(Tx_t, Tx_j):
    Tx_t, Tx_j = _np(Tx_t), _np(Tx_j)
    assert Tx_t.shape == Tx_j.shape
    m = np.abs(Tx_j).max()
    assert np.abs(Tx_t.sum(-2) - Tx_j.sum(-2)).max() < 1e-4 * m
    e_t, e_j = np.abs(Tx_t).sum(), np.abs(Tx_j).sum()
    assert abs(e_t - e_j) / e_j < 5e-3


def _w_close(w_t, w_j):
    """Phase transforms: the same cells gated (inf), the rest within
    1e-9 of max."""
    w_t, w_j = _np(w_t), _np(w_j)
    assert w_t.shape == w_j.shape
    inf = np.isinf(w_j)
    assert np.array_equal(np.isinf(w_t), inf)
    assert np.abs(w_t[~inf] - w_j[~inf]).max() <= 1e-9 * np.abs(
        w_j[~inf]).max()


def _cube(W):
    """A callable squeezing both packages can run: Wx * |Wx|."""
    return W * W.abs()


@pytest.mark.parametrize('case', ['w', 'abs', 'lebesgue', 'callable',
                                  'batch-abs'])
def test_ssqueeze_cwt_routes_vs_jax(case):
    """float64 CWT planes: from a precomputed `w` and with each non-'sum'
    squeezing (the phase transform of the raw Wx, then the generic
    scatter)."""
    rng = np.random.default_rng(12)
    N = 900
    x = rng.standard_normal((2, N) if case.startswith('batch') else N)
    scales = tstq.process_scales('log', N, resolve_wavelet('gmw'), nv=12)
    Wx, _, dWx = tstq.cwt(x, ('gmw', {'dtype': 'float64'}), scales=scales,
                          nv=12, derivative=True, device='cpu',
                          astensor=False)
    gamma = 1e-6
    kw = dict(scales=scales, flipud=True)
    if case == 'w':
        w = np.asarray(jphase_cwt(Complex.from_numpy(Wx),
                                  Complex.from_numpy(dWx), 'trig', gamma))
        kw['w'] = w
    else:
        sq = case.split('-')[-1]
        kw.update(dWx=dWx, gamma=gamma,
                  squeezing=(lambda W: W * W.abs()) if sq == 'callable'
                  else sq)
    Tx_j, fr_j = jstq.ssqueeze(Wx, **kw)
    if case == 'w':
        kw['w'] = torch.from_numpy(w.copy())
    Tx_t, fr_t = tstq.ssqueeze(Wx, device='cpu', **kw)
    assert isinstance(Tx_t, np.ndarray) and np.array_equal(fr_t, fr_j)
    assert _rel(Tx_t, Tx_j) <= 1e-9


@pytest.mark.parametrize('squeezing', ['abs', 'lebesgue'])
def test_ssqueeze_stft_routes_vs_jax(squeezing):
    """float64 STFT planes with Sfs: the phase transform offset from Sfs,
    then the generic scatter."""
    x = np.random.default_rng(13).standard_normal(800)
    Sx, dSx = tstq.stft(x, n_fft=96, derivative=True, dtype='float64',
                        device='cpu')
    Sx, dSx = Sx.numpy(), dSx.numpy()
    Sfs = np.linspace(0, .5, 49)
    kw = dict(dWx=dSx, gamma=1e-8, ssq_freqs=Sfs, Sfs=Sfs,
              transform='stft', squeezing=squeezing)
    Tx_j, _ = jstq.ssqueeze(Sx, **kw)
    Tx_t, _ = tstq.ssqueeze(torch.from_numpy(Sx), device='cpu', **kw)
    assert isinstance(Tx_t, torch.Tensor)
    assert _rel(Tx_t, Tx_j) <= 1e-9


def test_ssqueeze_rejects_negative_w():
    Wx = np.ones((4, 16), np.complex64)
    w = -torch.ones((4, 16))
    with pytest.raises(ValueError, match='negatives'):
        tstq.ssqueeze(Wx, w=w, scales=np.geomspace(2, 8, 4)[:, None],
                      device='cpu')


@pytest.mark.parametrize('squeezing,dtype,ndim', [
    ('abs', 'float64', 1), ('lebesgue', 'float64', 1),
    ('abs', 'float32', 2), ('lebesgue', 'float32', 2)])
def test_ssq_cwt_get_dWx_squeezing_vs_jax(squeezing, dtype, ndim):
    """The derivative CWT, the phase transform of the raw Wx, the
    squeezed values through the generic scatter; dWx returned."""
    rng = np.random.default_rng(31)
    x = rng.standard_normal((2, 1000) if ndim == 2 else 1000).astype(dtype)
    kw = dict(wavelet=('gmw', {'dtype': dtype}), nv=16, get_dWx=True,
              squeezing=squeezing, astensor=False)
    Tx_j, Wx_j, fr_j, _, dWx_j = jstq.ssq_cwt(x, **kw)
    Tx_t, Wx_t, fr_t, _, dWx_t = tstq.ssq_cwt(x, device='cpu', **kw)
    assert np.array_equal(fr_t, fr_j)
    tol = 1e-5 if dtype == 'float32' else 1e-9
    assert _rel(Wx_t, Wx_j) <= tol and _rel(dWx_t, dWx_j) <= tol
    if dtype == 'float32':
        _bins_criterion(Tx_t, Tx_j)
    else:
        assert _rel(Tx_t, Tx_j) <= 1e-9


@pytest.mark.parametrize('difftype,get_dWx,squeezing', [
    ('trig', False, 'sum'), ('trig', True, 'abs'), ('phase', False, 'sum'),
    ('phase', True, 'lebesgue')])
def test_ssq_cwt_get_w_vs_jax(difftype, get_dWx, squeezing):
    """float64: (Tx, Wx, ssq_freqs, scales, w[, dWx]) as the JAX
    package's compositional route returns them."""
    x = np.random.default_rng(32).standard_normal(1000)
    kw = dict(wavelet=('gmw', {'dtype': 'float64'}), nv=16, get_w=True,
              difftype=difftype, get_dWx=get_dWx, squeezing=squeezing,
              astensor=False)
    out_j = jstq.ssq_cwt(x, **kw)
    out_t = tstq.ssq_cwt(x, device='cpu', **kw)
    assert len(out_t) == len(out_j) == (6 if get_dWx else 5)
    assert np.array_equal(out_t[2], out_j[2])
    assert np.array_equal(out_t[3], out_j[3])
    assert _rel(out_t[1], out_j[1]) <= 1e-9
    _w_close(out_t[4], out_j[4])
    assert _rel(out_t[0], out_j[0]) <= 1e-9
    if get_dWx:
        assert _rel(out_t[5], out_j[5]) <= 1e-9
    # tensors out, on the device asked for
    Tx, _, _, _, w = tstq.ssq_cwt(x, device='cpu', **dict(kw, astensor=True,
                                                         get_dWx=False))
    assert isinstance(Tx, torch.Tensor) and isinstance(w, torch.Tensor)


@pytest.mark.parametrize('dtype,ndim', [('float32', 1), ('float64', 1),
                                        ('float32', 2)])
def test_ssq_cwt_callable_squeezing_vs_jax(dtype, ndim):
    """The port's bins route (the CWT kernel's k, then the user function
    on Wx, then the scatter) against the JAX compositional route."""
    rng = np.random.default_rng(33)
    x = rng.standard_normal((2, 1000) if ndim == 2 else 1000).astype(dtype)
    kw = dict(wavelet=('gmw', {'dtype': dtype}), nv=16, squeezing=_cube,
              astensor=False)
    Tx_j, Wx_j, _, _ = jstq.ssq_cwt(x, **kw)
    Tx_t, Wx_t, _, _ = tstq.ssq_cwt(x, device='cpu', **kw)
    assert _rel(Wx_t, Wx_j) <= (1e-5 if dtype == 'float32' else 1e-9)
    _bins_criterion(Tx_t, Tx_j)


@pytest.mark.parametrize('squeezing', ['sum', 'abs'])
def test_ssq_cwt_get_w_route_equals_fast_route(squeezing):
    """The port's own routes agree: Tx of `get_w=True` (phase transform +
    generic scatter) against Tx of the bins route, by the bins
    criterion."""
    N = 2048
    t = np.linspace(0, 6, N, endpoint=False)
    x = (np.cos(2 * np.pi * 2 * np.exp(t / 2))
         + .1 * np.random.default_rng(34).standard_normal(N)
         ).astype(np.float32)
    kw = dict(squeezing=squeezing, nv=16, device='cpu')
    Tx_w, Wx_w, _, _, w = tstq.ssq_cwt(x, get_w=True, **kw)
    Tx_f, Wx_f, _, _ = tstq.ssq_cwt(x, **kw)
    assert torch.equal(Wx_w, Wx_f) and w.shape == Wx_w.shape
    _bins_criterion(Tx_w, Tx_f)
    if squeezing == 'sum':
        assert tstq.toolkit.mad_rms(x, tstq.issq_cwt(Tx_w)) < 0.1
