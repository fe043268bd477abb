# -*- coding: utf-8 -*-
"""The port's reassignment from (Wx, dWx) and its batched / non-'sum'
synchrosqueezing (device='cpu', i.e. the kernels' plain PyTorch versions)
against the JAX package on the CPU:

  * `ssqueeze_fast` against the JAX `ssqueeze_fast` (its XLA path) over the
    lin / log / log-piecewise bin maps, both `flipud`, with and without
    `Sfs`, one signal and a batch;
  * `ssq_fused_plain` (B4) against the JAX fused kernel
    `ssq_fused_pallas` run in interpret mode;
  * the batched `cwt_bins_plain` (B3b) against the JAX
    `cwt_fused_bins_pallas` in interpret mode;
  * `ssq_cwt` on a batch, with 'lebesgue' / 'abs' squeezing and with
    `get_dWx=True`; `ssq_stft` at hop > 1 and with `get_dWx=True`;
    `ssqueeze` for the CWT and the STFT; the batched `issq_cwt`;
  * `padsignal` on a batch for each padtype;
  * the routes that wait for the generic scatter before it was ported:
    non-'sum' `ssq_cwt(get_dWx=True)`, `ssqueeze` from `w` and with 'abs'.

Tolerances: Wx and dWx within 1e-5 of max in float32 and 1e-9 in float64;
Tx in float32 by the bins criterion (column sums within 1e-4 of max,
energy within 5e-3: a cell may land one bin over where float32 rounding
meets a bin boundary), in float64 within 1e-9 of max.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import ssqueezepy_tpu as jstq
from ssqueezepy_tpu.ops.complexlib import Complex
from ssqueezepy_tpu.ops.cwt_pallas import cwt_fused_bins_pallas
from ssqueezepy_tpu.ops.pad import padsignal as jpadsignal
from ssqueezepy_tpu.ops.ssq_kernels import ssqueeze_fast as jssqueeze_fast
from ssqueezepy_tpu.ops.ssq_pallas import ssq_fused_pallas
from ssqueezepy_tpu.models.wavelets import Wavelet as JWavelet

import ssqueezepy_tpu_torch as tstq
from ssqueezepy_tpu_torch.convert import plan_from_numpy
from ssqueezepy_tpu_torch.models.cwt import resolve_wavelet
from ssqueezepy_tpu_torch.ops.cwt_cuda import cwt_bins, cwt_bins_plain
from ssqueezepy_tpu_torch.ops.fft import rfft
from ssqueezepy_tpu_torch.ops.pad import (SUPPORTED_PADTYPES, pad_params,
                                          padsignal)
from ssqueezepy_tpu_torch.ops.ssq_cuda import (scatter_kv, scatter_kv_plain,
                                               ssq_fused, ssq_fused_plain)
from ssqueezepy_tpu_torch.ops.ssq_kernels import ssq_bin_params
from torch_jax_reference import xla_reference  # noqa: F401


def _np(c):
    """numpy complex from a JAX `Complex` or a torch tensor."""
    if isinstance(c, torch.Tensor):
        return c.numpy()
    return np.asarray(c.re) + 1j * np.asarray(c.im)


def _bins_criterion(Tx_t, Tx_j):
    m = np.abs(Tx_j).max()
    assert np.abs(Tx_t.sum(-2) - Tx_j.sum(-2)).max() < 1e-4 * m
    e_t, e_j = np.abs(Tx_t).sum(), np.abs(Tx_j).sum()
    assert abs(e_t - e_j) / e_j < 5e-3


def _close(Tx_t, Tx_j, dtype):
    assert Tx_t.shape == Tx_j.shape
    if dtype == 'float32':
        _bins_criterion(Tx_t, Tx_j)
    else:
        assert np.abs(Tx_t - Tx_j).max() <= 1e-9 * np.abs(Tx_j).max()


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def _grid(mode, n):
    """ssq frequency grid of each bin-map mode (as tests/test_ssq_pallas.py
    builds them)."""
    if mode == 'lin':
        return np.linspace(0.008, 0.5, n)
    if mode == 'log':
        return 2 ** np.linspace(np.log2(1 / 2048), np.log2(0.5), n)
    n0 = n // 2
    lo, mid = np.log2(1 / 2048), np.log2(1 / 64)
    seg0 = 2 ** (lo + (mid - lo) / n0 * np.arange(n0 + 1))
    seg1 = seg0[-1] * 2 ** ((mid - lo) / n0 / 4 * np.arange(1, n - n0))
    return np.concatenate([seg0, seg1])


def _planes(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    cdt = np.complex64 if dtype == 'float32' else np.complex128
    z = lambda: (rng.standard_normal(shape) + 1j * rng.standard_normal(
        shape)).astype(cdt) * 0.1
    return z(), z()


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
@pytest.mark.parametrize('flipud', [True, False])
@pytest.mark.parametrize('mode', ['lin', 'log', 'log-piecewise'])
def test_ssqueeze_fast_vs_jax(mode, flipud, dtype):
    """One signal without Sfs, a batch of three with Sfs."""
    na, N = 40, 96
    freqs = _grid(mode, na)
    params = ssq_bin_params(freqs, logscale=mode != 'lin')
    assert params['mode'] == mode
    const = np.random.default_rng(7).random(na).astype(dtype) + 0.5
    gamma = 1e-3
    for shape, Sfs in (((na, N), None),
                       ((3, na, N), np.linspace(0, .5, na).astype(dtype))):
        Wx, dWx = _planes(shape, dtype, hash((mode, flipud, dtype)) % 2**32)
        # one compiled program per shape (eager dispatch compiles each op)
        Tx_j = jax.jit(lambda w, d: jssqueeze_fast(
            w, d, freqs, const, mode != 'lin', flipud, gamma,
            Sfs=None if Sfs is None else jnp.asarray(Sfs)))(
                Complex.from_numpy(Wx), Complex.from_numpy(dWx))
        Tx_t = tstq.ssqueeze_fast(torch.from_numpy(Wx),
                                  torch.from_numpy(dWx), freqs, const,
                                  mode != 'lin', flipud, gamma, Sfs=Sfs,
                                  device='cpu')
        assert Tx_t.shape == shape[:-2] + (na, N)
        _close(Tx_t.numpy(), _np(Tx_j), dtype)


@pytest.mark.parametrize('mode,flipud,sfs', [
    ('lin', True, False), ('log', False, False),
    ('log-piecewise', True, False), ('lin', False, True)])
def test_ssq_fused_plain_vs_jax_pallas(mode, flipud, sfs):
    """B4's plain version against the JAX fused kernel in interpret mode,
    on the planes and grids of tests/test_ssq_pallas.py (na = 61, N = 130;
    the STFT variant na = 48 with Sfs); both drop gated cells."""
    na, N = (48, 120) if sfs else (61, 130)
    freqs = np.linspace(0, 0.5, na) if sfs else _grid(mode, na)
    params = ssq_bin_params(freqs, logscale=mode != 'lin')
    rng = np.random.default_rng(hash((mode, flipud, sfs)) % 2**32)
    Wx, dWx = (rng.standard_normal((na, N)) + 1j * rng.standard_normal(
        (na, N)) for _ in range(2))
    Wx, dWx = Wx.astype(np.complex64), dWx.astype(np.complex64)
    Wx[3, :20] = 1e-6                                   # gated cells
    const = (rng.random(na) + 0.5).astype(np.float32)
    Sfs = freqs.astype(np.float32) if sfs else None
    gamma = 1e-4
    Tx_j = ssq_fused_pallas(
        Complex.from_numpy(Wx), Complex.from_numpy(dWx), const, params,
        gamma, flipud, None, Sfs=None if Sfs is None else jnp.asarray(Sfs),
        interpret=True, T=128)
    Tx_t = ssq_fused(torch.from_numpy(Wx), torch.from_numpy(dWx),
                     torch.from_numpy(const), params, gamma, flipud,
                     None if Sfs is None else torch.from_numpy(Sfs))
    Tx_j = _np(Tx_j)
    _bins_criterion(Tx_t.numpy(), Tx_j)
    m = np.abs(Tx_j).max()
    assert (np.abs(Tx_t.numpy() - Tx_j) > 1e-4 * m).mean() < 0.01


def test_ssq_fused_plain_is_phase_bins_then_scatter():
    """B4's plain version equals the phase transform + bins of B1's plain
    epilogue followed by B2's plain version, one signal and a batch."""
    from ssqueezepy_tpu_torch.ops.phase import phase_transform_w
    from ssqueezepy_tpu_torch.ops.ssq_kernels import compute_bins
    na, N = 33, 70
    params = ssq_bin_params(_grid('log', na), True)
    Wx, dWx = (torch.from_numpy(p) for p in _planes((2, na, N), 'float64',
                                                    3))
    c = torch.from_numpy(np.random.default_rng(4).random(na))
    k, valid = compute_bins(phase_transform_w(Wx, dWx, 1e-3), params, True)
    k = torch.where(valid, k, torch.full_like(k, -1))
    Tx = ssq_fused_plain(Wx, dWx, c, params, 1e-3, True)
    assert torch.equal(Tx, scatter_kv_plain(Wx, k, c, na))
    assert torch.equal(Tx[1], ssq_fused(Wx[1], dWx[1], c, params, 1e-3,
                                        True))
    assert torch.equal(scatter_kv(Wx, k, c, na)[0],
                       scatter_kv(Wx[0].contiguous(), k[0].contiguous(), c,
                                  na))


def test_cwt_bins_plain_batched_vs_jax_pallas():
    """B3b's plain version on a batch of two against the JAX batched CWT +
    bins kernel in interpret mode (N = 512, 12 scales)."""
    N, spec = 512, ('gmw', {'dtype': 'float32'})
    scales = np.geomspace(2., 64., 12).reshape(-1, 1)
    plan = plan_from_numpy(scales, None, spec, N)
    n_up, n1, _ = pad_params(N, 'reflect')
    x = np.random.default_rng(5).standard_normal((2, N)).astype(np.float32)
    xh = rfft(padsignal(torch.from_numpy(x), 'reflect')).contiguous()
    gamma = float(10 * np.finfo(np.float32).eps)
    sc = plan['scales'].ravel().astype(np.float32)
    Wx_j, k_j = cwt_fused_bins_pallas(
        Complex.from_numpy(xh.numpy()), jnp.asarray(sc), JWavelet(spec, N=N),
        n_up, n1, N, 1.0, True, plan['params'], gamma, True, interpret=True,
        deriv_lowprec=False)
    Wx_t, k_t = cwt_bins(xh, torch.from_numpy(sc), resolve_wavelet(spec, N=N),
                         n_up, n1, N, 1.0, True, plan['params'], gamma, True)
    assert Wx_t.shape == k_t.shape == (2, len(sc), N)
    Wx_j, k_j = _np(Wx_j), np.asarray(k_j)
    assert _rel(Wx_t.numpy(), Wx_j) <= 1e-5
    k_t = k_t.numpy()
    assert np.array_equal(k_t == -1, k_j == -1)
    valid = k_j >= 0
    assert (k_t[valid] == k_j[valid]).mean() >= 0.99
    assert np.abs(k_t[valid] - k_j[valid]).max() <= 1
    # each row of the batch is the plain version of its own signal
    for b in range(2):
        Wb, kb = cwt_bins_plain(xh[b].contiguous(), torch.from_numpy(sc),
                                resolve_wavelet(spec, N=N), n_up, n1, N, 1.0,
                                True, plan['params'], gamma, True)
        assert _rel(Wx_t[b].numpy(), Wb.numpy()) <= 1e-6
        assert (k_t[b] == kb.numpy()).mean() >= 0.999


@pytest.mark.parametrize('padtype', SUPPORTED_PADTYPES)
def test_padsignal_batched_vs_jax(padtype):
    x = np.random.default_rng(2).standard_normal((3, 301))
    xp_t = padsignal(torch.from_numpy(x), padtype).numpy()
    assert np.array_equal(xp_t, np.asarray(jpadsignal(jnp.asarray(x),
                                                      padtype)))
    assert np.array_equal(xp_t[1], padsignal(torch.from_numpy(x[1]),
                                             padtype).numpy())


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_ssq_cwt_batched_vs_jax(dtype):
    """B = 3, N = 2048, the default scales: against the JAX batched
    `ssq_cwt` and against a loop of 1-D port calls."""
    x = np.random.default_rng(11).standard_normal((3, 2048)).astype(dtype)
    kw = dict(wavelet=('gmw', {'dtype': dtype}), astensor=False)
    Tx_j, Wx_j, fr_j, sc_j = jstq.ssq_cwt(x, **kw)
    Tx_t, Wx_t, fr_t, sc_t = tstq.ssq_cwt(x, device='cpu', **kw)
    assert Tx_t.shape == Tx_j.shape and Wx_t.shape == Wx_j.shape
    assert Tx_t.shape[0] == 3
    assert np.array_equal(fr_t, fr_j) and np.array_equal(sc_t, sc_j)
    assert _rel(Wx_t, Wx_j) <= (1e-5 if dtype == 'float32' else 1e-9)
    _close(Tx_t, Tx_j, dtype)
    for b in range(3):
        Tx_b, Wx_b, _, _ = tstq.ssq_cwt(x[b], device='cpu', **kw)
        assert _rel(Wx_t[b], Wx_b) <= (1e-6 if dtype == 'float32'
                                       else 1e-12)
        _close(Tx_t[b], Tx_b, dtype)


@pytest.mark.parametrize('squeezing', ['lebesgue', 'abs'])
@pytest.mark.parametrize('ndim', [1, 2])
def test_ssq_cwt_squeezing_vs_jax(squeezing, ndim):
    rng = np.random.default_rng(ndim)
    x = rng.standard_normal((2, 1024) if ndim == 2 else 1024)
    kw = dict(wavelet=('gmw', {'dtype': 'float32'}), nv=16,
              squeezing=squeezing, astensor=False)
    Tx_j, Wx_j, _, _ = jstq.ssq_cwt(x.astype(np.float32), **kw)
    Tx_t, Wx_t, _, _ = tstq.ssq_cwt(x.astype(np.float32), device='cpu',
                                    **kw)
    assert Tx_t.shape == Tx_j.shape and Tx_t.dtype == Tx_j.dtype
    assert _rel(Wx_t, Wx_j) <= 1e-5
    _bins_criterion(Tx_t, Tx_j)


@pytest.mark.parametrize('dtype,ndim', [('float32', 1), ('float64', 1),
                                        ('float32', 2)])
def test_ssq_cwt_get_dWx_vs_jax(dtype, ndim):
    rng = np.random.default_rng(21)
    x = rng.standard_normal((2, 1500) if ndim == 2 else 1500).astype(dtype)
    kw = dict(wavelet=('gmw', {'dtype': dtype}), nv=16, get_dWx=True,
              astensor=False)
    out_j = jstq.ssq_cwt(x, **kw)
    out_t = tstq.ssq_cwt(x, device='cpu', **kw)
    assert len(out_t) == len(out_j) == 5
    Tx_j, Wx_j, fr_j, _, dWx_j = out_j
    Tx_t, Wx_t, fr_t, _, dWx_t = out_t
    assert np.array_equal(fr_t, fr_j)
    tol = 1e-5 if dtype == 'float32' else 1e-9
    assert _rel(Wx_t, Wx_j) <= tol and _rel(dWx_t, dWx_j) <= tol
    _close(Tx_t, Tx_j, dtype)
    # the fused route and the bins route agree on the same signal
    Tx_b, Wx_b, _, _ = tstq.ssq_cwt(x, device='cpu', **dict(kw,
                                                            get_dWx=False))
    assert _rel(Wx_b, Wx_t) <= tol
    _close(Tx_b, Tx_t, dtype)


@pytest.mark.parametrize('hop,get_dWx,dtype', [
    (4, False, 'float32'), (1, True, 'float32'), (3, True, 'float64')])
def test_ssq_stft_hop_and_dwx_vs_jax(hop, get_dWx, dtype):
    x = np.random.default_rng(9).standard_normal(1000).astype(dtype)
    kw = dict(n_fft=128, hop_len=hop, get_dWx=get_dWx, dtype=dtype,
              fs=2., astensor=False)
    out_j = jstq.ssq_stft(x, **kw)
    out_t = tstq.ssq_stft(x, device='cpu', **kw)
    assert len(out_t) == len(out_j) == (5 if get_dWx else 4)
    Tx_j, Sx_j, fr_j, Sfs_j = out_j[:4]
    Tx_t, Sx_t, fr_t, Sfs_t = out_t[:4]
    assert Tx_t.shape == Tx_j.shape == (65, -(-1000 // hop))
    assert np.array_equal(fr_t, fr_j) and np.array_equal(Sfs_t, Sfs_j)
    tol = 2e-5 if dtype == 'float32' else 1e-9
    assert _rel(Sx_t, Sx_j) <= tol
    if get_dWx:
        assert _rel(out_t[4], out_j[4]) <= tol
    _close(Tx_t, Tx_j, dtype)


@pytest.mark.parametrize('transform,as_numpy', [('cwt', True),
                                                ('cwt', False),
                                                ('stft', True)])
def test_ssqueeze_vs_jax(transform, as_numpy):
    rng = np.random.default_rng(13)
    x = rng.standard_normal(1200)
    if transform == 'cwt':
        scales = tstq.process_scales('log', 1200, resolve_wavelet('gmw'),
                                     nv=16)
        Wx, _, dWx = tstq.cwt(x, scales=scales, nv=16, derivative=True,
                              device='cpu', astensor=False)
        kw = dict(scales=scales, transform='cwt', flipud=True)
    else:
        Wx, dWx = tstq.stft(x, n_fft=128, derivative=True, device='cpu')
        Wx, dWx = Wx.numpy(), dWx.numpy()
        Sfs = np.linspace(0, .5, 65, dtype=np.float32)
        kw = dict(ssq_freqs=Sfs, Sfs=Sfs, transform='stft')
    gamma = 10 * np.finfo(np.float32).eps
    Tx_j, fr_j = jstq.ssqueeze(Wx, dWx=dWx, gamma=gamma, **kw)
    args = (Wx, dWx) if as_numpy else (torch.from_numpy(Wx),
                                       torch.from_numpy(dWx))
    Tx_t, fr_t = tstq.ssqueeze(args[0], dWx=args[1], gamma=gamma,
                               device='cpu', **kw)
    assert isinstance(Tx_t, np.ndarray if as_numpy else torch.Tensor)
    Tx_t = np.asarray(Tx_t)
    assert np.array_equal(fr_t, fr_j)
    _bins_criterion(Tx_t, _np(Tx_j) if not isinstance(Tx_j, np.ndarray)
                    else Tx_j)


def test_issq_cwt_batched_round_trip():
    N = 2048
    t = np.linspace(0, 6, N, endpoint=False)
    xb = np.stack([np.cos(2 * np.pi * f * np.exp(t / 2))
                   for f in (2., 3., 5.)]).astype(np.float32)
    Tx, _, _, _ = tstq.ssq_cwt(xb, device='cpu')
    xr = tstq.issq_cwt(Tx)
    assert xr.shape == (3, N)
    for b in range(3):
        assert tstq.toolkit.mad_rms(xb[b], xr[b]) < 0.1
    assert np.allclose(tstq.issq_cwt(Tx.numpy()),
                       jstq.issq_cwt(Tx.numpy()), rtol=1e-5, atol=1e-5)


# these routes took the generic scatter (B5) before the port had it and
# raised; now each is held against the JAX package (float64, 1e-9)
@pytest.mark.parametrize('call', [
    'ssq_cwt-abs-dwx', 'ssq_cwt-lebesgue-dwx', 'ssqueeze-w',
    'ssqueeze-abs'])
def test_b5_routes_raise(call):
    x = np.random.default_rng(0).standard_normal(512)
    spec = ('gmw', {'dtype': 'float64'})
    if call.startswith('ssq_cwt'):
        kw = dict(wavelet=spec, nv=16, squeezing=call.split('-')[1],
                  get_dWx=True, astensor=False)
        out_j = jstq.ssq_cwt(x, **kw)
        out_t = tstq.ssq_cwt(x, device='cpu', **kw)
        assert len(out_t) == len(out_j) == 5
        for a, b in zip(out_t[:2] + out_t[4:], out_j[:2] + out_j[4:]):
            assert _rel(a, b) <= 1e-9
        return
    scales = 2 ** (1 + np.arange(20) / 4).reshape(-1, 1)      # nv = 4
    Wx, _, dWx = tstq.cwt(x, spec, scales=scales, nv=4, derivative=True,
                          device='cpu', astensor=False)
    gamma = 1e-8
    if call == 'ssqueeze-w':
        from ssqueezepy_tpu.ops.phase import phase_transform_w
        kw = dict(w=np.asarray(phase_transform_w(
            Complex.from_numpy(Wx), Complex.from_numpy(dWx), gamma)))
    else:
        kw = dict(dWx=dWx, gamma=gamma, squeezing='abs')
    Tx_j, fr_j = jstq.ssqueeze(Wx, scales=scales, **kw)
    Tx_t, fr_t = tstq.ssqueeze(Wx, scales=scales, device='cpu', **kw)
    assert np.array_equal(fr_t, fr_j)
    assert _rel(Tx_t, _np(Tx_j) if isinstance(Tx_j, Complex) else Tx_j) \
        <= 1e-9


def test_ssq_fused_checks_inputs():
    Wx = torch.zeros((3, 8), dtype=torch.complex64)
    c = torch.ones(3)
    params = ssq_bin_params(np.linspace(0, .5, 4), False)
    with pytest.raises(ValueError):
        ssq_fused(Wx, Wx[:2], c, params, 1e-6, False)
    with pytest.raises(TypeError):
        ssq_fused(Wx, Wx, c.double(), params, 1e-6, False)
    with pytest.raises(ValueError):
        ssq_fused(Wx, Wx, c, params, 1e-6, False, Sfs=torch.ones(4))
    with pytest.raises(ValueError):
        tstq.ssqueeze_fast(Wx, Wx, None, c, params=params, device='cpu')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            tstq.ssqueeze_fast(Wx, Wx, None, c, gamma=1e-6, params=params)
        with pytest.raises(RuntimeError, match='CUDA'):
            tstq.ssqueeze(Wx.numpy(), dWx=Wx.numpy(), gamma=1e-6,
                          scales=np.geomspace(2., 8., 3).reshape(-1, 1))
