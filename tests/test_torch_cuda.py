# -*- coding: utf-8 -*-
"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device: it is marked `cuda` and skips
(from inside its fixture) where there is none. This file imports no JAX,
so it runs on a machine with only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Tolerances: Wx, Sx and dSx within 2e-5 of their max in float32 (the
kernels' own DFTs vs cuFFT in the plain versions) and 1e-9 relative in
float64; bins may differ on at most 1% of cells in float32 (w rounding at
bin boundaries), Tx then by the bins criterion; the scatter within 1e-5
of max|Tx| (summation order) and bit-identical from run to run. The
second-order kernels (B8, B7) on white noise the same; on a chirp their
k is held by the order-2 bins criterion alone (column sums 1e-4 of max,
|dTx| > 1e-3 max on under 2% of cells, energy 0.02): the chirp regression
cancels where |W| is small, so float rounding moves w2 across bins there.
The fused reassignment (B4) by the bins criterion in float32 and within
1e-9 of max|Tx| in float64, bit-identical from run to run; the batched
CWT + bins (B3b) and scatter (B2) rows bit-identical to one signal run
alone.
"""
import numpy as np
import pytest
import torch

import ssqueezepy_tpu_torch as stq
from ssqueezepy_tpu_torch.models.cwt import resolve_wavelet
from ssqueezepy_tpu_torch.models.ssq_cwt import _ssq_cwt_plan
from ssqueezepy_tpu_torch.models.ssq_stft import stft_plan
from ssqueezepy_tpu_torch.models.stft import signal_spectrum
from ssqueezepy_tpu_torch.ops import cwt_cuda
from ssqueezepy_tpu_torch.ops.cwt_cuda import (cwt_bins, cwt_bins_plain,
                                               cwt_bins2, cwt_bins2_plain,
                                               cwt_fused, cwt_fused_plain)
from ssqueezepy_tpu_torch.ops.fft import rfft
from ssqueezepy_tpu_torch.ops.pad import pad_params, padsignal
from ssqueezepy_tpu_torch.ops.ssq_cuda import (scatter_kv, scatter_kv_plain,
                                               ssq_fused, ssq_fused_plain)
from ssqueezepy_tpu_torch.ops.ssq_kernels import ssq_bin_params
from ssqueezepy_tpu_torch.models.ssq_stft import fsst2_plan
from ssqueezepy_tpu_torch.ops.stft_conv import conv_bank, conv_table
from ssqueezepy_tpu_torch.ops.stft_cuda import (fsst2_conv, fsst2_conv_plain,
                                                stft_conv, stft_conv_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device('cuda')


def _chirp(N):
    n = np.arange(N)
    return np.cos(2 * np.pi * (0.02 * n + 0.3 / (2 * N) * n ** 2))


def _inputs(N, dtype, scales, dev, padtype='reflect', seed=0, x=None):
    spec = ('gmw', {'dtype': dtype})
    wav = resolve_wavelet(spec, N=N)
    plan, _ = _ssq_cwt_plan(wav, N, scales, 16, None, 'peak', True, 1.)
    scales_np, const, params = plan.scales, plan.const, plan.params
    n_up, n1, _ = pad_params(N, padtype)
    tdt = getattr(torch, dtype)
    if x is None:
        x = np.random.default_rng(seed).standard_normal(N)
    x = torch.as_tensor(x, dtype=tdt, device=dev)
    xh = rfft(padsignal(x, padtype))
    sc = torch.as_tensor(scales_np.ravel(), dtype=tdt, device=dev)
    c = torch.as_tensor(np.broadcast_to(np.ravel(const), (len(sc),)).copy(),
                        dtype=tdt, device=dev)
    gamma = 10 * float(np.finfo(dtype).eps)
    return xh, sc, c, wav, n_up, n1, params, gamma


def _bins_criterion(Tx_k, Tx_p):
    m = Tx_p.abs().max()
    assert (Tx_k.sum(-2) - Tx_p.sum(-2)).abs().max() < 1e-4 * m
    e_k, e_p = Tx_k.abs().sum(), Tx_p.abs().sum()
    assert abs(e_k - e_p) / e_p < 5e-3


def _bins2_criterion(Tx_k, Tx_p):
    m = Tx_p.abs().max()
    assert (Tx_k.sum(-2) - Tx_p.sum(-2)).abs().max() < 1e-4 * m
    assert ((Tx_k - Tx_p).abs() > 1e-3 * m).double().mean() < 0.02
    e_k, e_p = Tx_k.abs().sum(), Tx_p.abs().sum()
    assert abs(e_k - e_p) / e_p < 0.02


@pytest.mark.parametrize('N,scales,padtype', [
    (1000, 'log-piecewise', 'reflect'), (4096, 'log', 'symmetric'),
    (3001, 'linear', 'zero'), (160000, 'log-piecewise', 'reflect')])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_cwt_bins_kernel_vs_plain(dev, N, scales, padtype, dtype):
    xh, sc, c, wav, n_up, n1, params, gamma = _inputs(N, dtype, scales, dev,
                                                      padtype)
    n0 = cwt_bins.launches
    Wx_k, k_k = cwt_bins(xh, sc, wav, n_up, n1, N, 1., True, params, gamma,
                         True)
    torch.cuda.synchronize()
    assert cwt_bins.launches > n0
    Wx_p, k_p = cwt_bins_plain(xh, sc, wav, n_up, n1, N, 1., True, params,
                               gamma, True)
    err = (Wx_k - Wx_p).abs().max() / Wx_p.abs().max()
    assert err <= (2e-5 if dtype == 'float32' else 1e-9), float(err)
    assert (k_k != k_p).double().mean() <= 0.01
    nbins = params['omax'] + 1
    _bins_criterion(scatter_kv_plain(Wx_k, k_k, c, nbins),
                    scatter_kv_plain(Wx_p, k_p, c, nbins))


def test_cwt_bins_row_chunks(dev, monkeypatch):
    """Scratch smaller than the whole plane: rows run in chunks."""
    xh, sc, c, wav, n_up, n1, params, gamma = _inputs(5000, 'float32',
                                                      'log', dev)
    full = cwt_bins(xh, sc, wav, n_up, n1, 5000, 1., True, params, gamma,
                    True)
    monkeypatch.setattr(cwt_cuda, '_SCRATCH_BUDGET', 2 * n_up * 8 * 7)
    n0 = cwt_bins.launches
    chunked = cwt_bins(xh, sc, wav, n_up, n1, 5000, 1., True, params, gamma,
                       True)
    assert cwt_bins.launches - n0 == -(-len(sc) // 7)
    assert torch.equal(full[0], chunked[0])
    assert torch.equal(full[1], chunked[1])


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_scatter_kv_kernel_vs_plain(dev, dtype):
    na, N, nbins = 300, 20000, 290
    g = torch.Generator(device='cpu').manual_seed(0)
    cdt = torch.complex64 if dtype == 'float32' else torch.complex128
    Wx = torch.randn(na, N, dtype=cdt, generator=g).to(dev)
    k = torch.randint(-3, nbins + 3, (na, N), dtype=torch.int32,
                      generator=g).to(dev)
    c = torch.rand(na, dtype=getattr(torch, dtype), generator=g).to(dev)
    n0 = scatter_kv.launches
    Tx1 = scatter_kv(Wx, k, c, nbins)
    Tx2 = scatter_kv(Wx, k, c, nbins)
    torch.cuda.synchronize()
    assert scatter_kv.launches - n0 == 2
    assert torch.equal(Tx1, Tx2)                     # deterministic
    Tx_p = scatter_kv_plain(Wx, k, c, nbins)
    assert (Tx1 - Tx_p).abs().max() <= 1e-5 * Tx_p.abs().max()


def test_ssq_cwt_on_card_round_trip(dev):
    N = 19531
    t = np.linspace(0, 6, N, endpoint=False)
    x = np.cos(2 * np.pi * 2 * np.exp(t / 2)).astype(np.float32)
    n1, n2 = cwt_bins.launches, scatter_kv.launches
    Tx, Wx, fr, sc = stq.ssq_cwt(x)
    assert Tx.is_cuda and Wx.is_cuda
    assert cwt_bins.launches > n1 and scatter_kv.launches > n2
    assert torch.isfinite(torch.view_as_real(Tx)).all()
    assert stq.toolkit.mad_rms(x, stq.issq_cwt(Tx)) < 0.1
    Tx_c, _, _, _ = stq.ssq_cwt(x, device='cpu')
    _bins_criterion(Tx.cpu(), Tx_c)


def _rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max())


# (N, n_fft) whose transform length N + n_fft - 1 -> next_fft_len has the
# odd factor 1 (2^12), 3 (3 x 2^12), 5 (the ssq_stft headline, 5 x 2^15),
# 9 (9 x 2^10) and 15 (15 x 2^9)
STFT_SHAPES = [(4000, 97, 1), (10000, 512, 3), (160000, 598, 5),
               (9000, 128, 9), (7000, 256, 15)]


def _stft_inputs(N, n_fft, dtype, dev, modulated=True, seed=0):
    x = torch.as_tensor(np.random.default_rng(seed).standard_normal(N),
                        dtype=getattr(torch, dtype), device=dev)
    xh = signal_spectrum(x, n_fft, 'reflect')
    plan = stft_plan(None, None, n_fft, n_fft, 1., dtype)
    H = conv_table(plan.window, n_fft, xh.shape[0], modulated, dtype, dev)
    Hd = conv_table(plan.diff_window, n_fft, xh.shape[0], modulated, dtype,
                    dev)
    bins = dict(Sfs=torch.as_tensor(plan.Sfs, device=dev),
                params=plan.params, flipud=False,
                gamma=10 * float(np.finfo(dtype).eps))
    c = torch.full((H.shape[0],), plan.const, dtype=getattr(torch, dtype),
                   device=dev)
    return xh, H, Hd, bins, c


@pytest.mark.parametrize('N,n_fft,odd', STFT_SHAPES)
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_stft_conv_kernel_vs_plain(dev, N, n_fft, odd, dtype):
    xh, H, Hd, bins, c = _stft_inputs(N, n_fft, dtype, dev)
    Np2 = xh.shape[0]
    assert Np2 % odd == 0 and (Np2 // odd) & (Np2 // odd - 1) == 0
    tol = 2e-5 if dtype == 'float32' else 1e-9
    n0 = stft_conv.launches
    for Hd_, bins_ in ((None, None), (Hd, None), (Hd, bins)):
        Sx_k, o_k = stft_conv(xh, H, Hd_, N, 2., bins_)
        torch.cuda.synchronize()
        Sx_p, o_p = stft_conv_plain(xh, H, Hd_, N, 2., bins_)
        assert _rel_err(Sx_k, Sx_p) <= tol
        if bins_ is None and Hd_ is not None:
            assert _rel_err(o_k, o_p) <= tol
        elif bins_ is not None:
            assert o_k.dtype == torch.int32
            assert (o_k != o_p).double().mean() <= 0.01
            nbins = bins['params']['omax'] + 1
            _bins_criterion(scatter_kv_plain(Sx_k, o_k, c, nbins),
                            scatter_kv_plain(Sx_p, o_p, c, nbins))
    assert stft_conv.launches - n0 == 3


def test_stft_conv_unmodulated_and_row_chunks(dev, monkeypatch):
    N, n_fft = 3001, 64
    xh, H, Hd, bins, _ = _stft_inputs(N, n_fft, 'float32', dev,
                                      modulated=False)
    full = stft_conv(xh, H, Hd, N, 1., bins)
    assert _rel_err(full[0], stft_conv_plain(xh, H, Hd, N, 1., bins)[0]) \
        <= 2e-5
    from ssqueezepy_tpu_torch.ops import stft_cuda
    monkeypatch.setattr(stft_cuda, '_SCRATCH_BUDGET',
                        2 * xh.shape[0] * 8 * 5)
    n0 = stft_conv.launches
    chunked = stft_conv(xh, H, Hd, N, 1., bins)
    assert stft_conv.launches - n0 == -(-H.shape[0] // 5)
    assert torch.equal(full[0], chunked[0])
    assert torch.equal(full[1], chunked[1])


@pytest.mark.parametrize('shape,scales', [((1000,), 'log-piecewise'),
                                          ((4, 3000), 'log'),
                                          ((160000,), 'log-piecewise')])
@pytest.mark.parametrize('derivative', [False, True])
@pytest.mark.parametrize('dtype,l1_norm', [('float32', True),
                                           ('float64', True),
                                           ('float32', False)])
def test_cwt_fused_kernel_vs_plain(dev, shape, scales, derivative, dtype,
                                   l1_norm):
    N = shape[-1]
    spec = ('gmw', {'dtype': dtype,
                    'norm': 'bandpass' if l1_norm else 'energy'})
    wav = resolve_wavelet(spec, l1_norm=l1_norm, N=N)
    sc = torch.as_tensor(stq.process_scales(scales, N, wav).ravel(),
                         dtype=getattr(torch, dtype), device=dev)
    n_up, n1, _ = pad_params(N, 'reflect')
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(shape),
                        dtype=getattr(torch, dtype), device=dev)
    xh = rfft(padsignal(x, 'reflect')).contiguous()
    n0 = cwt_fused.launches
    Wx_k, dWx_k = cwt_fused(xh, sc, wav, n_up, n1, N, 1., derivative,
                            l1_norm)
    torch.cuda.synchronize()
    assert cwt_fused.launches > n0
    Wx_p, dWx_p = cwt_fused_plain(xh, sc, wav, n_up, n1, N, 1., derivative,
                                  l1_norm)
    assert Wx_k.shape == shape[:-1] + (len(sc), N)
    tol = 2e-5 if dtype == 'float32' else 1e-9
    assert _rel_err(Wx_k, Wx_p) <= tol
    assert (dWx_k is None) == (not derivative)
    if derivative:
        assert _rel_err(dWx_k, dWx_p) <= tol


def test_public_stft_family_on_card(dev):
    N = 19531
    t = np.linspace(0, 6, N, endpoint=False)
    x = np.cos(2 * np.pi * 2 * np.exp(t / 2)).astype(np.float32)
    n1, n2 = stft_conv.launches, scatter_kv.launches
    Tx, Sx, fr, Sfs = stq.ssq_stft(x)
    assert Tx.is_cuda and Sx.is_cuda
    assert stft_conv.launches > n1 and scatter_kv.launches > n2
    assert stq.toolkit.mad_rms(x, stq.issq_stft(Tx)) < 0.1
    Tx_c, Sx_c, _, _ = stq.ssq_stft(x, device='cpu')
    assert _rel_err(Sx.cpu(), Sx_c) <= 2e-5
    _bins_criterion(Tx.cpu(), Tx_c)
    x64 = np.random.default_rng(0).standard_normal(5000)
    for hop in (1, 4):
        S = stq.stft(x64, n_fft=256, hop_len=hop, dtype='float64')
        assert S.is_cuda
        assert np.abs(stq.istft(S, n_fft=256, hop_len=hop, N=5000)
                      - x64).mean() < 1e-12


def test_public_cwt_on_card(dev):
    N = 19531
    t = np.linspace(0, 6, N, endpoint=False)
    x = np.cos(2 * np.pi * 2 * np.exp(t / 2)).astype(np.float32)
    n0 = cwt_fused.launches
    Wx, scales = stq.cwt(x, scales='log')
    assert Wx.is_cuda and cwt_fused.launches > n0
    assert stq.toolkit.mad_rms(x, stq.icwt(Wx, scales='log')) < 0.1
    Wx_c, _ = stq.cwt(x, scales='log', device='cpu')
    assert _rel_err(Wx.cpu(), Wx_c) <= 2e-5


@pytest.mark.parametrize('N,scales,signal', [
    (2048, 'log-piecewise', 'noise'), (2048, 'log-piecewise', 'chirp'),
    (4096, 'log', 'noise'), (160000, 'log-piecewise', 'noise')])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_cwt_bins2_kernel_vs_plain(dev, N, scales, signal, dtype):
    xh, sc, c, wav, n_up, n1, params, gamma = _inputs(
        N, dtype, scales, dev, x=_chirp(N) if signal == 'chirp' else None)
    n0 = cwt_bins2.launches
    W_k, k_k = cwt_bins2(xh, sc, wav, n_up, n1, N, 1., params, gamma, True)
    torch.cuda.synchronize()
    assert cwt_bins2.launches > n0
    W_p, k_p = cwt_bins2_plain(xh, sc, wav, n_up, n1, N, 1., params, gamma,
                               True)
    assert _rel_err(W_k, W_p) <= (2e-5 if dtype == 'float32' else 1e-9)
    nbins = params['omax'] + 1
    Tx_k = scatter_kv_plain(W_k, k_k, c, nbins)
    Tx_p = scatter_kv_plain(W_p, k_p, c, nbins)
    if signal == 'noise':
        assert (k_k != k_p).double().mean() <= 0.01
        _bins_criterion(Tx_k, Tx_p)
    else:
        _bins2_criterion(Tx_k, Tx_p)


def test_cwt_bins2_row_chunks_and_repeats(dev, monkeypatch):
    """Five scratch planes over a budget of 7 rows: rows run in chunks,
    bit-identical to one chunk; the scatter of (W, k) repeats bit for
    bit."""
    xh, sc, c, wav, n_up, n1, params, gamma = _inputs(5000, 'float32', 'log',
                                                      dev)
    args = (xh, sc, wav, n_up, n1, 5000, 1., params, gamma, True)
    full = cwt_bins2(*args)
    monkeypatch.setattr(cwt_cuda, '_SCRATCH_BUDGET', 5 * n_up * 8 * 7)
    n0 = cwt_bins2.launches
    chunked = cwt_bins2(*args)
    assert cwt_bins2.launches - n0 == -(-len(sc) // 7)
    assert torch.equal(full[0], chunked[0])
    assert torch.equal(full[1], chunked[1])
    nbins = params['omax'] + 1
    assert torch.equal(scatter_kv(*full, c, nbins),
                       scatter_kv(*full, c, nbins))


def _fsst2_inputs(N, n_fft, dtype, dev, x=None, modulated=True):
    if x is None:
        x = np.random.default_rng(0).standard_normal(N)
    x = torch.as_tensor(x, dtype=getattr(torch, dtype), device=dev)
    xh = signal_spectrum(x, n_fft, 'reflect')
    plan = fsst2_plan(None, None, n_fft, n_fft, 1., dtype)
    tables = conv_bank(plan.bank, n_fft, xh.shape[0], modulated, dtype, dev)
    bins = dict(Sfs=torch.as_tensor(plan.Sfs, device=dev),
                params=plan.params, flipud=False,
                gamma=10 * float(np.finfo(dtype).eps))
    c = torch.full((tables.shape[1],), plan.const,
                   dtype=getattr(torch, dtype), device=dev)
    return xh, tables, bins, c


@pytest.mark.parametrize('N,n_fft,signal', [
    (10000, 598, 'noise'), (10000, 598, 'chirp'), (4000, 97, 'noise'),
    (160000, 598, 'noise')])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_fsst2_conv_kernel_vs_plain(dev, N, n_fft, signal, dtype):
    xh, tables, bins, c = _fsst2_inputs(
        N, n_fft, dtype, dev, _chirp(N) if signal == 'chirp' else None)
    if N == 10000:
        assert xh.shape[0] == 12288               # 3 x 2^12
    n0 = fsst2_conv.launches
    V_k, k_k = fsst2_conv(xh, tables, N, 2., bins)
    torch.cuda.synchronize()
    assert fsst2_conv.launches > n0 and k_k.dtype == torch.int32
    V_p, k_p = fsst2_conv_plain(xh, tables, N, 2., bins)
    assert _rel_err(V_k, V_p) <= (2e-5 if dtype == 'float32' else 1e-9)
    nbins = bins['params']['omax'] + 1
    Tx_k = scatter_kv_plain(V_k, k_k, c, nbins)
    Tx_p = scatter_kv_plain(V_p, k_p, c, nbins)
    if signal == 'noise':
        assert (k_k != k_p).double().mean() <= 0.01
        _bins_criterion(Tx_k, Tx_p)
    else:
        _bins2_criterion(Tx_k, Tx_p)


def test_fsst2_conv_unmodulated_chunks_and_repeats(dev, monkeypatch):
    N, n_fft = 3001, 64
    xh, tables, bins, c = _fsst2_inputs(N, n_fft, 'float32', dev,
                                        modulated=False)
    full = fsst2_conv(xh, tables, N, 1., bins)
    assert _rel_err(full[0], fsst2_conv_plain(xh, tables, N, 1., bins)[0]) \
        <= 2e-5
    from ssqueezepy_tpu_torch.ops import stft_cuda
    monkeypatch.setattr(stft_cuda, '_SCRATCH_BUDGET',
                        5 * xh.shape[0] * 8 * 5)
    n0 = fsst2_conv.launches
    chunked = fsst2_conv(xh, tables, N, 1., bins)
    assert fsst2_conv.launches - n0 == -(-tables.shape[1] // 5)
    assert torch.equal(full[0], chunked[0])
    assert torch.equal(full[1], chunked[1])
    nbins = bins['params']['omax'] + 1
    assert torch.equal(scatter_kv(*full, c, nbins),
                       scatter_kv(*full, c, nbins))


def test_public_order2_on_card(dev):
    N = 19531
    t = np.linspace(0, 6, N, endpoint=False)
    x = np.cos(2 * np.pi * 2 * np.exp(t / 2)).astype(np.float32)
    n1, n2 = cwt_bins2.launches, scatter_kv.launches
    Tx, Wx, fr, sc = stq.ssq_cwt2(x)
    assert Tx.is_cuda and Wx.is_cuda
    assert cwt_bins2.launches > n1 and scatter_kv.launches > n2
    assert stq.toolkit.mad_rms(x, stq.issq_cwt(Tx)) < 0.1
    Tx_c, Wx_c, _, _ = stq.ssq_cwt2(x, device='cpu')
    assert _rel_err(Wx.cpu(), Wx_c) <= 2e-5
    _bins2_criterion(Tx.cpu(), Tx_c)
    n1, n2 = fsst2_conv.launches, scatter_kv.launches
    Tx, Sx, fr, Sfs = stq.ssq_stft2(x)
    assert Tx.is_cuda and Sx.is_cuda
    assert fsst2_conv.launches > n1 and scatter_kv.launches > n2
    assert stq.toolkit.mad_rms(x, stq.issq_stft(Tx)) < 0.1
    Tx_c, Sx_c, _, _ = stq.ssq_stft2(x, device='cpu')
    assert _rel_err(Sx.cpu(), Sx_c) <= 2e-5
    _bins2_criterion(Tx.cpu(), Tx_c)


def _grid(mode, n):
    """ssq frequency grid of each bin-map mode."""
    if mode == 'lin':
        return np.linspace(0.008, 0.5, n)
    if mode == 'log':
        return 2 ** np.linspace(np.log2(1 / 2048), np.log2(0.5), n)
    n0 = n // 2
    lo, mid = np.log2(1 / 2048), np.log2(1 / 64)
    seg0 = 2 ** (lo + (mid - lo) / n0 * np.arange(n0 + 1))
    seg1 = seg0[-1] * 2 ** ((mid - lo) / n0 / 4 * np.arange(1, n - n0))
    return np.concatenate([seg0, seg1])


def _noise_planes(shape, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    cdt = torch.complex64 if dtype == 'float32' else torch.complex128
    return tuple(torch.as_tensor(rng.standard_normal(shape)
                                 + 1j * rng.standard_normal(shape),
                                 dtype=cdt, device=dev) for _ in range(2))


def _fused_close(Tx_k, Tx_p, dtype):
    if dtype == 'float32':
        _bins_criterion(Tx_k, Tx_p)
    else:
        assert (Tx_k - Tx_p).abs().max() <= 1e-9 * Tx_p.abs().max()


@pytest.mark.parametrize('mode', ['lin', 'log', 'log-piecewise'])
@pytest.mark.parametrize('flipud', [True, False])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_ssq_fused_kernel_vs_plain(dev, mode, flipud, dtype):
    """White-noise planes, one signal and a batch of three (with Sfs);
    repeats bit-identical; the batch rows equal single-signal launches."""
    na, N = 96, 20000
    params = ssq_bin_params(_grid(mode, na), mode != 'lin')
    rdt = getattr(torch, dtype)
    c = torch.as_tensor(np.random.default_rng(1).random(na) + .5,
                        dtype=rdt, device=dev)
    Sfs = torch.linspace(0, .5, na, dtype=rdt, device=dev)
    gamma = 1e-2
    for shape, sfs in (((na, N), None), ((3, na, N), Sfs)):
        Wx, dWx = _noise_planes(shape, dtype, dev)
        n0 = ssq_fused.launches
        Tx1 = ssq_fused(Wx, dWx, c, params, gamma, flipud, sfs)
        Tx2 = ssq_fused(Wx, dWx, c, params, gamma, flipud, sfs)
        torch.cuda.synchronize()
        assert ssq_fused.launches - n0 == 2
        assert Tx1.shape == shape[:-2] + (na, N) and torch.equal(Tx1, Tx2)
        _fused_close(Tx1, ssq_fused_plain(Wx, dWx, c, params, gamma, flipud,
                                          sfs), dtype)
        if len(shape) == 3:
            assert torch.equal(Tx1[2], ssq_fused(Wx[2], dWx[2], c, params,
                                                 gamma, flipud, sfs))


def test_ssq_fused_narrow_blocks(dev):
    """nbins = 1000 in float64 leaves the accumulator room for 8 columns
    per block (tc < 32)."""
    na, N, nbins = 64, 5000, 1000
    params = ssq_bin_params(_grid('log', nbins), True)
    Wx, dWx = _noise_planes((na, N), 'float64', dev, seed=2)
    c = torch.ones(na, dtype=torch.float64, device=dev)
    Tx = ssq_fused(Wx, dWx, c, params, 1e-2, True)
    assert Tx.shape == (nbins, N)
    _fused_close(Tx, ssq_fused_plain(Wx, dWx, c, params, 1e-2, True),
                 'float64')


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_ssq_fused_on_cwt_planes(dev, dtype):
    """B4 on the derivative CWT of white noise (the get_dWx route), and
    the same k as the CWT kernel's bins mode on those planes."""
    N = 10000
    xh, sc, c, wav, n_up, n1, params, gamma = _inputs(N, dtype,
                                                      'log-piecewise', dev)
    Wx, dWx = cwt_fused(xh, sc, wav, n_up, n1, N, 1., True, True)
    Tx = ssq_fused(Wx, dWx, c, params, gamma, True)
    _fused_close(Tx, ssq_fused_plain(Wx, dWx, c, params, gamma, True), dtype)
    Wx_b, k_b = cwt_bins(xh, sc, wav, n_up, n1, N, 1., True, params, gamma,
                         True)
    assert torch.equal(Wx_b, Wx)
    _fused_close(Tx, scatter_kv(Wx_b, k_b, c, params['omax'] + 1), dtype)


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_cwt_bins_batched_vs_plain_and_b1(dev, dtype, monkeypatch):
    """B3b on a (3, 10000) batch: against its plain version, each row
    bit-identical to B1 on its signal, and again with rows in chunks."""
    N, B = 10000, 3
    xh1, sc, c, wav, n_up, n1, params, gamma = _inputs(N, dtype,
                                                       'log-piecewise', dev)
    x = np.random.default_rng(3).standard_normal((B, N))
    xh = rfft(padsignal(torch.as_tensor(x, dtype=getattr(torch, dtype),
                                        device=dev), 'reflect')).contiguous()
    args = (sc, wav, n_up, n1, N, 1., True, params, gamma, True)
    n0, nb0 = cwt_bins.launches, cwt_bins.batched_launches
    Wx, k = cwt_bins(xh, *args)
    torch.cuda.synchronize()
    assert cwt_bins.launches == n0 and cwt_bins.batched_launches > nb0
    Wx_p, k_p = cwt_bins_plain(xh, *args)
    assert Wx.shape == k.shape == (B, len(sc), N)
    assert _rel_err(Wx, Wx_p) <= (2e-5 if dtype == 'float32' else 1e-9)
    assert (k != k_p).double().mean() <= 0.01
    for b in range(B):
        W1, k1 = cwt_bins(xh[b].contiguous(), *args)
        assert torch.equal(W1, Wx[b]) and torch.equal(k1, k[b])
    monkeypatch.setattr(cwt_cuda, '_SCRATCH_BUDGET',
                        2 * n_up * xh.element_size() * 50)
    nb0 = cwt_bins.batched_launches
    Wc, kc = cwt_bins(xh, *args)
    assert cwt_bins.batched_launches - nb0 == -(-B * len(sc) // 50)
    assert torch.equal(Wc, Wx) and torch.equal(kc, k)


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_scatter_kv_batched(dev, dtype):
    B, na, N, nbins = 3, 200, 9000, 190
    rng = np.random.default_rng(5)
    cdt = torch.complex64 if dtype == 'float32' else torch.complex128
    Wx = torch.as_tensor(rng.standard_normal((B, na, N))
                         + 1j * rng.standard_normal((B, na, N)), dtype=cdt,
                         device=dev)
    k = torch.as_tensor(rng.integers(-3, nbins + 3, (B, na, N)),
                        dtype=torch.int32, device=dev)
    c = torch.as_tensor(rng.random(na), dtype=getattr(torch, dtype),
                        device=dev)
    n0 = scatter_kv.launches
    Tx = scatter_kv(Wx, k, c, nbins)
    torch.cuda.synchronize()
    assert scatter_kv.launches - n0 == 1 and Tx.shape == (B, nbins, N)
    for b in range(B):
        assert torch.equal(Tx[b], scatter_kv(Wx[b], k[b], c, nbins))
    Tx_p = scatter_kv_plain(Wx, k, c, nbins)
    assert (Tx - Tx_p).abs().max() <= 1e-5 * Tx_p.abs().max()


def test_public_fifth_slice_on_card(dev):
    """Batched and 'abs' ssq_cwt, ssq_cwt(get_dWx=True), ssq_stft at hop 4
    and with get_dWx, ssqueeze: on the card, through their kernels, and
    against the plain path."""
    N = 8000
    t = np.linspace(0, 6, N, endpoint=False)
    xb = np.stack([np.cos(2 * np.pi * f * np.exp(t / 2))
                   for f in (2., 3.)]).astype(np.float32)
    nb, n2 = cwt_bins.batched_launches, scatter_kv.launches
    Tx, Wx, _, _ = stq.ssq_cwt(xb)
    assert cwt_bins.batched_launches > nb and scatter_kv.launches > n2
    xr = stq.issq_cwt(Tx)
    assert all(stq.toolkit.mad_rms(xb[b], xr[b]) < 0.1 for b in range(2))
    Tx_c, Wx_c, _, _ = stq.ssq_cwt(xb, device='cpu')
    assert _rel_err(Wx.cpu(), Wx_c) <= 2e-5
    _bins_criterion(Tx.cpu(), Tx_c)
    Tx, _, _, _ = stq.ssq_cwt(xb[0], squeezing='abs')
    _bins_criterion(Tx.cpu(), stq.ssq_cwt(xb[0], squeezing='abs',
                                          device='cpu')[0])
    n3, n4 = cwt_fused.launches, ssq_fused.launches
    Tx, Wx, _, _, dWx = stq.ssq_cwt(xb[0], get_dWx=True)
    assert cwt_fused.launches > n3 and ssq_fused.launches > n4
    Tx_c, _, _, _, dWx_c = stq.ssq_cwt(xb[0], get_dWx=True, device='cpu')
    assert _rel_err(dWx.cpu(), dWx_c) <= 2e-5
    _bins_criterion(Tx.cpu(), Tx_c)
    _, _, fr, sc = stq.ssq_cwt(xb[0])
    n4 = ssq_fused.launches
    Tx_s, _ = stq.ssqueeze(Wx, dWx=dWx, gamma=10 * np.finfo(np.float32).eps,
                           scales=sc.reshape(-1, 1),
                           ssq_freqs=fr[::-1].copy(), flipud=True)
    assert Tx_s.is_cuda and ssq_fused.launches > n4
    assert torch.equal(Tx_s, Tx)
    for kw in (dict(hop_len=4), dict(get_dWx=True)):
        n4 = ssq_fused.launches
        out = stq.ssq_stft(xb[0], n_fft=256, **kw)
        assert ssq_fused.launches > n4
        out_c = stq.ssq_stft(xb[0], n_fft=256, device='cpu', **kw)
        assert _rel_err(out[1].cpu(), out_c[1]) <= 2e-5
        _bins_criterion(out[0].cpu(), out_c[0])
