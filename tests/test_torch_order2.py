# -*- coding: utf-8 -*-
"""The port's second-order transforms (device='cpu', i.e. the plain
PyTorch versions of the WSST2 kernel B8 and the FSST2 table kernel B7)
against the JAX package on the CPU:

  * GMW psih', psih'' in closed form against `jax.grad` of the JAX
    spectral fn (float64, 1e-12 of max);
  * `cwt_bins2_plain` and `fsst2_conv_plain` against the JAX XLA twins
    `_wsst2_rows` / `_fsst2_rows` + `_bins_from_w`, on the same spectrum
    and plan: W/V within 1e-5 of max (float32) and 1e-9 (float64), k equal
    but on at most 0.1% of cells of white noise;
  * `ssq_cwt2`/`ssq_stft2` against `ssqueezepy_tpu.ssq_cwt2`/`ssq_stft2`,
    and against the JAX fused kernels run in interpret mode (W/V within
    2e-5 of max);
  * exactness on linear chirps, the round trips, and the slice's bounds.

Tx is held by the order-2 bins criterion of the JAX package's own tests
(`tests/test_ssq_cwt2.py`): column sums within 1e-4 of max|Tx|, |dTx| >
1e-3 max on under 2% of cells, total energy within 0.02. The chirp
regression cancels catastrophically where |W| is small, so one-ulp
differences (closed-form vs autodiff derivatives, summation order) move
w2 across bins there; the criterion weighs cells by their energy.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import ssqueezepy_tpu as jstq
from ssqueezepy_tpu.models import gmw as jgmw
from ssqueezepy_tpu.models.cwt import resolve_wavelet as jresolve_wavelet
from ssqueezepy_tpu.models.ssq_cwt2 import _wsst2_rows, _wavelet_grad_fns
from ssqueezepy_tpu.models.ssq_stft import _fsst2_bank as j_fsst2_bank, \
    _fsst2_rows
from ssqueezepy_tpu.ops.complexlib import Complex
from ssqueezepy_tpu.ops.fft import fft as jfft
from ssqueezepy_tpu.ops.pad import padsignal as jpadsignal
from ssqueezepy_tpu.ops.ssq_kernels import ssq_bin_params as jbin_params
from ssqueezepy_tpu.ops.ssq_pallas import _bins_from_w
from ssqueezepy_tpu.ops.stft_conv import (_bank_key, _conv_filterbank_multi,
                                          _next_fft_len)

import ssqueezepy_tpu_torch as tstq
from ssqueezepy_tpu_torch.convert import fsst2_plan_from_numpy, \
    plan_from_numpy
from ssqueezepy_tpu_torch.models import gmw as tgmw
from ssqueezepy_tpu_torch.models.cwt import resolve_wavelet
from ssqueezepy_tpu_torch.models.ssq_stft import fsst2_plan
from ssqueezepy_tpu_torch.models.stft import signal_spectrum
from ssqueezepy_tpu_torch.ops.cwt_cuda import (cwt_bins2, cwt_bins2_plain,
                                               wsst2_rows)
from ssqueezepy_tpu_torch.ops.fft import rfft
from ssqueezepy_tpu_torch.ops.pad import pad_params, padsignal
from ssqueezepy_tpu_torch.ops.stft_conv import conv_bank
from ssqueezepy_tpu_torch.ops.stft_cuda import (fsst2_conv, fsst2_conv_plain,
                                                fsst2_rows)
from torch_jax_reference import xla_reference  # noqa: F401

TOL = {'float32': 1e-5, 'float64': 1e-9}


def _np(c):
    if isinstance(c, torch.Tensor):
        return c.numpy()
    if isinstance(c, Complex):
        return np.asarray(c.re) + 1j * np.asarray(c.im)
    return np.asarray(c)


def _rel(a, b):
    return np.abs(_np(a) - _np(b)).max() / np.abs(_np(b)).max()


def _noise(N, dtype='float32', seed=0):
    return np.random.default_rng(seed).standard_normal(N).astype(dtype)


def _chirp(N, c, r, dtype='float64'):
    n = np.arange(N)
    return np.cos(2 * np.pi * (c * n + r / 2 * n ** 2)).astype(dtype)


def _bins2_criterion(Tx_t, Tx_j):
    Tx_t, Tx_j = _np(Tx_t), _np(Tx_j)
    m = np.abs(Tx_j).max()
    assert np.abs(Tx_t.sum(-2) - Tx_j.sum(-2)).max() < 1e-4 * m
    assert (np.abs(Tx_t - Tx_j) > 1e-3 * m).mean() < 0.02
    e_t, e_j = np.abs(Tx_t).sum(), np.abs(Tx_j).sum()
    assert abs(e_t - e_j) / e_j < 0.02


def _k_agree(k_t, k_j):
    k_t, k_j = _np(k_t), _np(k_j)
    assert k_t.dtype == np.int32
    assert (k_t != k_j).mean() <= 1e-3


# ---- GMW derivatives ---------------------------------------------------
@pytest.mark.parametrize('norm', ['bandpass', 'energy'])
@pytest.mark.parametrize('centered', [False, True])
@pytest.mark.parametrize('gamma,beta', [(3., 60.), (2., 12.)])
def test_gmw_derivatives_vs_jax_grad(norm, centered, gamma, beta):
    make = 'gmw_l1' if norm == 'bandpass' else 'gmw_l2'
    fn_t = getattr(tgmw, make)(gamma, beta, centered_scale=centered)
    fn_j = getattr(jgmw, make)(gamma, beta, centered_scale=centered)
    g1 = jax.grad(lambda w: jnp.sum(fn_j(w, xp=jnp)))
    g2 = jax.jit(jax.grad(lambda w: jnp.sum(g1(w))))
    g1 = jax.jit(g1)
    w = np.concatenate([np.linspace(-1., 0., 11),
                        np.linspace(1e-3, 4 * tgmw.morsefreq(gamma, beta),
                                    4001)])
    d1, d2 = fn_t.derivatives(torch.from_numpy(w))
    d1_j, d2_j = (np.asarray(g(jnp.asarray(w))) for g in (g1, g2))
    for a, b in ((d1, d1_j), (d2, d2_j)):
        assert np.abs(a.numpy() - b).max() <= 1e-12 * np.abs(b).max()
        assert np.all(a.numpy()[w <= 0] == 0)


# ---- B8: the WSST2 rows ------------------------------------------------
def _wsst2_inputs(N, dtype, x, nv=16):
    """The JAX spectrum and plan, and the same as torch tensors."""
    spec = ('gmw', {'dtype': dtype})
    wav_j = jresolve_wavelet(spec, l1_norm=True, N=N)
    wav_t = resolve_wavelet(spec, N=N)
    scales = jstq.process_scales('log-piecewise', N, wav_j, nv=nv)
    plan = plan_from_numpy(scales, None, spec, N)
    n_up, n1, _ = pad_params(N, 'reflect')
    xp = jpadsignal(jnp.asarray(x), 'reflect')
    xh = jfft(Complex(xp, jnp.zeros_like(xp)), axis=-1,
              out_range=(0, n_up // 2 + 1), imag_zero=True, engine='xla')
    xh_t = torch.from_numpy(_np(xh))
    sc_t = torch.from_numpy(scales.ravel().astype(dtype))
    return wav_j, wav_t, scales, plan, n_up, n1, xh, xh_t, sc_t


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_cwt_bins2_plain_vs_jax_twin(dtype):
    N = 2048
    x = _noise(N, dtype)
    wav_j, wav_t, scales, plan, n_up, n1, xh, xh_t, sc_t = _wsst2_inputs(
        N, dtype, x)
    gamma = 10 * float(np.finfo(dtype).eps)
    tiny = float(np.finfo(dtype).tiny * 1e3)
    params = plan['params']

    @jax.jit
    def twin(re, im, sc):
        W, w2 = _wsst2_rows(Complex(re[None], im[None]), sc,
                            _wavelet_grad_fns(wav_j), n_up, n1, N, 1.,
                            gamma, dtype, tiny)
        k, valid = _bins_from_w(w2, jnp.isfinite(w2), params, True,
                                params['mode'])
        return W, jnp.where(valid, k, -1)

    W_j, k_j = twin(xh.re, xh.im, jnp.asarray(scales.reshape(-1, 1), dtype))
    # the wrapper on CPU tensors is the plain version
    for fn in (cwt_bins2_plain, cwt_bins2):
        W_t, k_t = fn(xh_t, sc_t, wav_t, n_up, n1, N, 1., params, gamma,
                      True)
        assert W_t.shape == (len(scales), N) and W_t.is_contiguous()
        assert _rel(W_t, W_j) <= TOL[dtype]
        _k_agree(k_t, k_j)


def test_wsst2_exact_on_linear_chirp():
    """w2 of the plain rows is the chirp's instantaneous frequency at every
    energetic cell, to float precision (as tests/test_ssq_cwt2.py asserts
    for the JAX package)."""
    N = 8192
    c, r = 0.02, 0.36 / N
    x = torch.from_numpy(_chirp(N, c, r))
    wav = resolve_wavelet(('gmw', {'dtype': 'float64'}), N=N)
    scales = tstq.process_scales('log-piecewise', N, wav, nv=32)
    n_up, n1, _ = pad_params(N, 'reflect')
    W, w2 = wsst2_rows(rfft(padsignal(x, 'reflect')),
                       torch.from_numpy(scales.ravel()), wav, n_up, n1, N,
                       1., 10 * float(np.finfo(np.float64).eps))
    m = N // 6
    E = np.abs(W.numpy()[:, m:-m]) ** 2
    act = E > 1e-4 * E.max()
    w2 = w2.numpy()[:, m:-m]
    f = (c + r * np.arange(N))[m:-m][None]
    err = (np.abs(np.where(act, w2, 0) - f) * E * act).sum() / (E * act).sum()
    assert err < 1e-6, err


# ---- ssq_cwt2 ----------------------------------------------------------
@pytest.mark.parametrize('case', [
    dict(), dict(dtype='float64'), dict(scales='log', fs=4.),
    dict(flipud=False), dict(bench=True)],
    ids=lambda c: '-'.join('%s=%s' % kv for kv in c.items()) or 'default')
def test_ssq_cwt2_vs_jax(case):
    case = dict(case)
    dtype = case.pop('dtype', 'float32')
    N = 2048
    x = _chirp(N, .02, .3 / N, dtype) + .1 * _noise(N, dtype, seed=3)
    spec = ('gmw', {'dtype': dtype})
    kw = dict(astensor=False, **case)
    if kw.pop('bench', False):
        # the bench's call: a scales array and no ssq_freqs
        kw['scales'] = jstq.process_scales(
            'log-piecewise', N, jresolve_wavelet(spec, True, N))
    else:
        kw['nv'] = 16
    Tx_j, Wx_j, fr_j, sc_j = jstq.ssq_cwt2(x, spec, **kw)
    Tx_t, Wx_t, fr_t, sc_t = tstq.ssq_cwt2(x, spec, device='cpu', **kw)
    assert Tx_t.shape == Tx_j.shape and Wx_t.shape == Wx_j.shape
    assert Tx_t.dtype == Tx_j.dtype
    assert np.array_equal(fr_t, fr_j) and np.array_equal(sc_t, sc_j)
    assert _rel(Wx_t, Wx_j) <= TOL[dtype]
    _bins2_criterion(Tx_t, Tx_j)


def test_ssq_cwt2_vs_jax_fused_interpret():
    """The plain path against the JAX fused WSST2 kernel run in interpret
    mode at full-precision auxiliary banks (tests/test_ssq_cwt2.py)."""
    from ssqueezepy_tpu.configs import configure, reset_config
    N = 2048
    n = np.arange(N)
    x = (np.cos(2 * np.pi * (0.02 * n + 0.3 / (2 * N) * n ** 2))
         + 0.1 * _noise(N, 'float64', seed=3)).astype(np.float32)
    kw = dict(scales='log-piecewise', nv=8, astensor=False)
    spec = ('gmw', {'dtype': 'float32'})
    try:
        configure(backend='tpu', pallas_interpret=True,
                  ssq_lowprec_deriv=False)
        Tx_j, Wx_j, fr_j, _ = jstq.ssq_cwt2(x, spec, **kw)
    finally:
        reset_config()
    Tx_t, Wx_t, fr_t, _ = tstq.ssq_cwt2(x, spec, device='cpu', **kw)
    assert np.allclose(fr_t, fr_j)
    assert _rel(Wx_t, Wx_j) <= 2e-5
    _bins2_criterion(Tx_t, Tx_j)


def test_ssq_cwt2_round_trip_and_tensor_out():
    N = 4096
    t = np.linspace(0, 6, N, endpoint=False)
    x = np.cos(2 * np.pi * 2 * np.exp(t / 2)).astype(np.float32)
    Tx, Wx, fr, sc = tstq.ssq_cwt2(x, device='cpu')
    assert isinstance(Tx, torch.Tensor) and Tx.dtype == torch.complex64
    assert Wx.shape == (len(sc), N) and Tx.shape == (len(fr), N)
    assert tstq.toolkit.mad_rms(x, tstq.issq_cwt(Tx)) < 0.1
    Tx2, _, _, _ = tstq.ssq_cwt2(torch.from_numpy(x), device='cpu')
    assert torch.equal(Tx, Tx2)


# ---- B7: the FSST2 rows ------------------------------------------------
def _fsst2_inputs(N, n_fft, dtype, x, window=None, modulated=True, fs=1.):
    bank = j_fsst2_bank(window, n_fft, n_fft, dtype)
    padlength = N + n_fft - 1
    Np2 = _next_fft_len(padlength)
    xp = jpadsignal(jnp.asarray(x), 'reflect', padlength=padlength)
    xh = jfft(Complex(xp, jnp.zeros_like(xp)), n=Np2, imag_zero=True,
              engine='xla')
    Sfs = np.linspace(0, .5 * fs, n_fft // 2 + 1, dtype=dtype)
    plan = fsst2_plan_from_numpy(bank, Sfs, params=jbin_params(Sfs, False))
    tables = conv_bank(plan.bank, n_fft, Np2, modulated, dtype, 'cpu')
    return bank, Np2, xh, Sfs, plan, tables


@pytest.mark.parametrize('dtype,window,modulated', [
    ('float32', None, True), ('float32', 'hann', False),
    ('float64', None, True)])
def test_fsst2_conv_plain_vs_jax_twin(dtype, window, modulated):
    N, n_fft, fs = 1500, 128, 3.
    x = _noise(N, dtype, seed=1)
    bank, Np2, xh, Sfs, plan, tables = _fsst2_inputs(
        N, n_fft, dtype, x, window, modulated, fs)
    n_rows = n_fft // 2 + 1
    # the port's own plan and tables are the JAX package's
    own = fsst2_plan(window, None, n_fft, n_fft, fs, dtype)
    assert np.array_equal(own.bank, bank) and np.array_equal(own.Sfs, Sfs)
    Hre, Him = _conv_filterbank_multi(_bank_key(bank), n_fft, Np2,
                                      modulated, dtype)
    H_j = (Hre + 1j * Him).reshape(5, n_rows, Np2)
    assert tables.shape == (5, n_rows, Np2)
    assert _rel(tables, H_j) <= TOL[dtype]
    gamma = 10 * float(np.finfo(dtype).eps)
    @jax.jit
    def twin(xh, Hre, Him):
        V, w2 = _fsst2_rows(xh, Hre, Him, n_rows, Np2, N, fs, Sfs, gamma,
                            dtype, float(np.finfo(dtype).tiny * 1e3))
        k, valid = _bins_from_w(w2, jnp.isfinite(w2), plan.params, False,
                                'lin')
        return V, jnp.where(valid, k, -1)

    V_j, k_j = twin(xh, jnp.asarray(Hre), jnp.asarray(Him))
    bins = dict(Sfs=torch.from_numpy(Sfs), params=plan.params, gamma=gamma,
                flipud=False)
    xh_t = torch.from_numpy(_np(xh))
    for fn in (fsst2_conv_plain, fsst2_conv):
        V_t, k_t = fn(xh_t, tables, N, fs, bins)
        assert V_t.shape == (n_rows, N)
        assert _rel(V_t, V_j) <= TOL[dtype]
        _k_agree(k_t, k_j)


def test_fsst2_exact_on_linear_chirp():
    """w2 of the plain rows is the chirp's instantaneous frequency at every
    energetic cell (as tests/test_ssq_stft2.py asserts for the JAX
    package): mean error under 1e-3 bins."""
    N, n_fft, c = 2048, 256, 2e-4
    x = torch.from_numpy(_chirp(N, 0.05, c))
    plan = fsst2_plan(None, None, n_fft, n_fft, 1., 'float64')
    xh = signal_spectrum(x, n_fft, 'reflect')
    tables = conv_bank(plan.bank, n_fft, xh.shape[0], True, 'float64', 'cpu')
    V, w2 = fsst2_rows(xh, tables, N, 1., torch.from_numpy(plan.Sfs),
                       10 * float(np.finfo(np.float64).eps))
    m = n_fft
    E = np.abs(V.numpy()[:, m:-m]) ** 2
    w2 = w2.numpy()[:, m:-m]
    act = np.isfinite(w2) & (E > 1e-4 * E.max())
    f = (0.05 + c * np.arange(N))[m:-m][None]
    err = (np.abs(np.where(act, w2, 0) - f) * E * act).sum() \
        / (E * act).sum() * n_fft
    assert err < 1e-3, err


# ---- ssq_stft2 ---------------------------------------------------------
@pytest.mark.parametrize('case', [
    dict(), dict(dtype='float64'), dict(modulated=False),
    dict(window='hann', fs=10., flipud=True,
         ssq_freqs=np.linspace(.05, 4.5, 150))],
    ids=['default', 'float64', 'unmodulated', 'hann-grid-fs-flipud'])
def test_ssq_stft2_vs_jax(case):
    case = dict(case)
    dtype = case.pop('dtype', 'float32')
    N = 1800
    x = _chirp(N, .05, .1 / N, dtype) + .1 * _noise(N, dtype, seed=5)
    kw = dict(n_fft=128, dtype=dtype, astensor=False, **case)
    Tx_j, V_j, fr_j, Sfs_j = jstq.ssq_stft2(x, **kw)
    Tx_t, V_t, fr_t, Sfs_t = tstq.ssq_stft2(x, device='cpu', **kw)
    assert Tx_t.shape == Tx_j.shape and V_t.shape == V_j.shape
    assert Tx_t.dtype == Tx_j.dtype
    assert np.array_equal(fr_t, fr_j) and np.array_equal(Sfs_t, Sfs_j)
    assert _rel(V_t, V_j) <= TOL[dtype]
    _bins2_criterion(Tx_t, Tx_j)


def test_ssq_stft2_vs_jax_fused_interpret():
    """The plain path against the JAX fused FSST2 kernel run in interpret
    mode (tests/test_ssq_stft2.py: Np2 = 4096)."""
    from ssqueezepy_tpu.configs import configure, reset_config
    N, n_fft = 3800, 256
    n = np.arange(N)
    x = (np.cos(2 * np.pi * (0.05 * n + 0.1 / (2 * N) * n ** 2))
         + 0.1 * _noise(N, 'float64', seed=5)).astype(np.float32)
    kw = dict(n_fft=n_fft, dtype='float32', astensor=False)
    try:
        configure(backend='tpu', pallas_interpret=True,
                  ssq_lowprec_deriv=False)
        Tx_j, V_j, fr_j, _ = jstq.ssq_stft2(x, **kw)
    finally:
        reset_config()
    Tx_t, V_t, fr_t, _ = tstq.ssq_stft2(x, device='cpu', **kw)
    assert np.allclose(fr_t, fr_j)
    assert _rel(V_t, V_j) <= 2e-5
    _bins2_criterion(Tx_t, Tx_j)


def test_ssq_stft2_round_trip_and_plan_memo():
    N = 2000
    t = np.linspace(0, 1, N, endpoint=False)
    x = np.cos(2 * np.pi * (20 * t + 150 * t ** 2)).astype(np.float32)
    Tx, Sx, fr, Sfs = tstq.ssq_stft2(x, device='cpu')
    assert Tx.shape == Sx.shape == (257, N)
    assert tstq.toolkit.mad_rms(x, tstq.issq_stft(Tx)) < 0.1
    p = fsst2_plan(None, None, 512, 512, 1., 'float32')
    assert fsst2_plan(None, None, 512, 512, 1., 'float32') is p
    assert p.bank.shape == (5, 512) and p.bank.dtype == np.float64
    tab = conv_bank(p.bank, 512, 2560, True, 'float32', 'cpu')
    assert conv_bank(p.bank.copy(), 512, 2560, True, 'float32', 'cpu') is tab


def test_fsst2_conv_checks_inputs():
    xh = torch.zeros(960, dtype=torch.complex64)
    tables = torch.zeros((5, 33, 960), dtype=torch.complex64)
    bins = dict(Sfs=torch.zeros(33), params=jbin_params(
        np.linspace(0, .5, 33), False), gamma=1e-6, flipud=False)
    with pytest.raises(ValueError):
        fsst2_conv(xh, tables[:2], 100, 1., bins)
    with pytest.raises(ValueError):
        fsst2_conv(xh, tables, 100, 1., dict(bins, Sfs=torch.zeros(5)))
    with pytest.raises(TypeError):
        fsst2_conv(xh.to(torch.complex128), tables, 100, 1., bins)


# ---- squeezing other than 'sum' ------------------------------------------
def _cube(W):
    """A callable squeezing both packages can run: W * |W|."""
    return W * W.abs()


# the port squeezes the order-2 kernels' W / V and scatters it by their
# bins (B8 / B7 -> B2); the JAX package scatters the same plane by the bins
# of an explicit w2 (indexed_sum_onfly), so Tx is held by the order-2 bins
# criterion in both types
@pytest.mark.parametrize('squeezing', ['abs', 'lebesgue', 'callable'])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_ssq_cwt2_squeezing_vs_jax(squeezing, dtype):
    N = 1500
    x = _chirp(N, .02, .3 / N, dtype) + .1 * _noise(N, dtype, seed=6)
    spec = ('gmw', {'dtype': dtype})
    kw = dict(nv=16, astensor=False,
              squeezing=_cube if squeezing == 'callable' else squeezing)
    Tx_j, Wx_j, fr_j, _ = jstq.ssq_cwt2(x, spec, **kw)
    Tx_t, Wx_t, fr_t, _ = tstq.ssq_cwt2(x, spec, device='cpu', **kw)
    assert np.array_equal(fr_t, fr_j) and Tx_t.dtype == Tx_j.dtype
    assert _rel(Wx_t, Wx_j) <= TOL[dtype]
    _bins2_criterion(Tx_t, Tx_j)


@pytest.mark.parametrize('squeezing', ['abs', 'lebesgue', 'callable'])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_ssq_stft2_squeezing_vs_jax(squeezing, dtype):
    N = 1200
    x = _chirp(N, .05, .1 / N, dtype) + .1 * _noise(N, dtype, seed=7)
    kw = dict(n_fft=96, dtype=dtype, astensor=False,
              squeezing=_cube if squeezing == 'callable' else squeezing)
    Tx_j, V_j, fr_j, _ = jstq.ssq_stft2(x, **kw)
    Tx_t, V_t, fr_t, _ = tstq.ssq_stft2(x, device='cpu', **kw)
    assert np.array_equal(fr_t, fr_j) and Tx_t.dtype == Tx_j.dtype
    assert _rel(V_t, V_j) <= TOL[dtype]
    _bins2_criterion(Tx_t, Tx_j)


# ---- the slice's bounds ------------------------------------------------
# every squeezing and 2-D input are ported (compared with the JAX package
# above and in test_torch_stft_batch.py), padtype=None at lengths whose
# prime factors are at most 7 (tests/test_torch_padnone.py), and get_w
# (tests/test_torch_order2_w.py); get_w on 2-D input raises as the JAX
# package's ssq_cwt2 does. padtype=None at another length (1001 = 7 11 13,
# through `wsst2_general`) and morlet, which raised here before they were
# ported, now agree with the JAX package (W within 1e-5 of max, Tx by the
# order-2 bins criterion; more in tests/test_torch_prime_length.py and
# tests/test_torch_wavelet_routes.py)
@pytest.mark.parametrize('kw', [
    dict(x2d=True, get_w=True),
    dict(squeezing='abs', padtype=None), dict(padtype=None),
    dict(wavelet='morlet')],
    ids=lambda kw: '%s=%s' % next((k, getattr(v, '__name__', v))
                                  for k, v in kw.items()))
def test_ssq_cwt2_outside_slice_raises(kw):
    kw = dict(kw)
    x = _noise(1001 if 'padtype' in kw else 1000)
    if not kw.get('x2d'):
        out_t = tstq.ssq_cwt2(x, device='cpu', **kw)
        out_j = jstq.ssq_cwt2(x, **kw)
        assert _rel(out_t[1], out_j[1]) <= TOL['float32']
        _bins2_criterion(out_t[0], out_j[0])
        return
    kw.pop('x2d')
    x = np.stack([x, x])
    with pytest.raises(NotImplementedError,
                       match='unsupported with batched input'):
        jstq.ssq_cwt2(x, **kw)
    with pytest.raises(NotImplementedError,
                       match='unsupported with batched input'):
        tstq.ssq_cwt2(x, device='cpu', **kw)


def test_order2_default_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match='CUDA'):
        tstq.ssq_cwt2(_noise(600))
    with pytest.raises(RuntimeError, match='CUDA'):
        tstq.ssq_stft2(_noise(600))
