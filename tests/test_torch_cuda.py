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
1e-9 of max|Tx| in float64, bit-identical from run to run; every mode of
the CWT kernel (B1, B3, B8) bit-identical from run to run, B3's Wx
bit-identical to B1's, B1's batched form (B3b) and the batched scatter
(B2) rows bit-identical to one signal run alone. The generic scatter (B5) within 1e-5 of max|out| in float32 and
1e-12 in float64 (summation order), bit-identical from run to run and
its batch rows bit-identical to one signal run alone. B2 and the four
instantiations of B5 the same at ragged shapes (N of 1, odd, just over a
block; one row; bins from 1 to the most the launch plan takes), and the
launch plan's shared bytes and blocks per SM the kernel's and the
runtime's.
"""
import ctypes

import numpy as np
import pytest
import torch

import ssqueezepy_tpu_torch as stq
from ssqueezepy_tpu_torch.models.cwt import resolve_wavelet
from ssqueezepy_tpu_torch.models.ssq_cwt import _ssq_cwt_plan
from ssqueezepy_tpu_torch.models.ssq_stft import stft_plan
from ssqueezepy_tpu_torch.models.stft import signal_spectrum
from ssqueezepy_tpu_torch.ops import _build, cwt_cuda
from ssqueezepy_tpu_torch.ops.cwt_cuda import (cwt_bins, cwt_bins_plain,
                                               cwt_bins2, cwt_bins2_plain,
                                               cwt_fused, cwt_fused_plain)
from ssqueezepy_tpu_torch.ops.fft import rfft
from ssqueezepy_tpu_torch.ops.pad import pad_params, padsignal
from ssqueezepy_tpu_torch.ops.ssq_cuda import (scatter_kv, scatter_kv_plain,
                                               scatter_launch_plan,
                                               shift_scatter,
                                               shift_scatter_plain,
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
    (3001, 'linear', 'zero'), (160000, 'log-piecewise', 'reflect'),
    # n_up = 4, 8, 32, 2048: DFT lengths 2 to 64, odd log2 included
    (2, 'log-piecewise', 'reflect'), (3, 'log-piecewise', 'reflect'),
    (20, 'log-piecewise', 'reflect'), (1025, 'log', 'reflect')])
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


@pytest.mark.parametrize('mode', ['bins', 'wx', 'wx_dwx', 'order2'])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_cwt_bins_repeats_bit_identical(dev, dtype, mode):
    """Two launches on the same inputs give the same outputs, bit for bit,
    in every mode of the CWT kernel: Wx and k (B1), Wx (B3), Wx and dWx
    (B3), W and k of order 2 (B8)."""
    N = 10000
    xh, sc, c, wav, n_up, n1, params, gamma = _inputs(N, dtype,
                                                      'log-piecewise', dev)
    if mode == 'bins':
        def run():
            return cwt_bins(xh, sc, wav, n_up, n1, N, 1., True, params,
                            gamma, True)
    elif mode == 'order2':
        def run():
            return cwt_bins2(xh, sc, wav, n_up, n1, N, 1., params, gamma,
                             True)
    else:
        def run():
            return cwt_fused(xh, sc, wav, n_up, n1, N, 1., mode == 'wx_dwx',
                             True)
    (W1, o1), (W2, o2) = run(), run()
    assert torch.equal(W1, W2)
    assert (o1 is None and o2 is None) if mode == 'wx' else \
        torch.equal(o1, o2)


@pytest.mark.parametrize('shape', [(10000,), (3, 4000)])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_cwt_modes_wx_bit_identical_to_b1(dev, shape, dtype):
    """B3's Wx, with one plane (Wx only) and with two (Wx and dWx), is
    bit-identical to B1's (B3b's for a batch) on
    the same spectra and scales, and so is B8's W (one signal, L1 norm):
    one DFT engine, the same spectra and butterflies."""
    N = shape[-1]
    _, sc, _, wav, n_up, n1, params, gamma = _inputs(N, dtype,
                                                     'log-piecewise', dev)
    x = np.random.default_rng(4).standard_normal(shape)
    xh = rfft(padsignal(torch.as_tensor(x, dtype=getattr(torch, dtype),
                                        device=dev), 'reflect')).contiguous()
    Wx, _ = cwt_bins(xh, sc, wav, n_up, n1, N, 1., True, params, gamma, True)
    for derivative in (False, True):
        W3, _ = cwt_fused(xh, sc, wav, n_up, n1, N, 1., derivative, True)
        assert torch.equal(W3, Wx), derivative
    if len(shape) == 1:
        W8, _ = cwt_bins2(xh, sc, wav, n_up, n1, N, 1., params, gamma, True)
        assert torch.equal(W8, Wx)


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
# 9 (9 x 2^10) and 15 (15 x 2^9); and N = 2, 3, 20, 1025 with transform
# lengths 20 (5 x 4), 15 (15 x 1: no second step), 12 (3 x 4), 60
# (15 x 4) and 1152 (36 x 32)
STFT_SHAPES = [(4000, 97, 1), (10000, 512, 3), (160000, 598, 5),
               (9000, 128, 9), (7000, 256, 15), (2, 19, 5), (2, 12, 15),
               (3, 10, 3), (20, 30, 15), (1025, 64, 9)]


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


@pytest.mark.parametrize('shape,scales', [
    ((1000,), 'log-piecewise'), ((4, 3000), 'log'),
    ((160000,), 'log-piecewise'),
    # n_up = 4, 8, 32, 2048: DFT lengths 2 to 64, odd log2 included
    ((2,), 'log-piecewise'), ((3,), 'log-piecewise'),
    ((20,), 'log-piecewise'), ((1025,), 'log')])
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
    (4096, 'log', 'noise'), (160000, 'log-piecewise', 'noise'),
    # n_up = 4, 8, 32, 2048: DFT lengths 2 to 64, odd log2 included
    (2, 'log-piecewise', 'noise'), (3, 'log-piecewise', 'noise'),
    (20, 'log-piecewise', 'noise'), (1025, 'log', 'noise')])
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
    (160000, 598, 'noise'),
    # transform lengths 9 x 2^10 and 15 x 2^9; N = 2, 3, 20, 1025
    (9000, 128, 'noise'), (7000, 256, 'noise'), (2, 19, 'noise'),
    (3, 10, 'noise'), (20, 30, 'noise'), (1025, 64, 'noise')])
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


@pytest.mark.parametrize('mode', ['sx', 'sx_dsx', 'bins', 'fsst2'])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_stft_conv_repeats_bit_identical(dev, dtype, mode):
    """Two launches on the same inputs give the same outputs, bit for bit,
    in every mode of the STFT table kernel: Sx (B6 mode 0), Sx and dSx
    (1), Sx and k (2), V and k (B7)."""
    N, n_fft = 10000, 598
    if mode == 'fsst2':
        xh, tables, bins, _ = _fsst2_inputs(N, n_fft, dtype, dev)

        def run():
            return fsst2_conv(xh, tables, N, 1., bins)
    else:
        xh, H, Hd, bins, _ = _stft_inputs(N, n_fft, dtype, dev)
        Hd_ = None if mode == 'sx' else Hd
        bins_ = bins if mode == 'bins' else None

        def run():
            return stft_conv(xh, H, Hd_, N, 1., bins_)
    (S1, o1), (S2, o2) = run(), run()
    assert torch.equal(S1, S2)
    assert (o1 is None and o2 is None) if mode == 'sx' else \
        torch.equal(o1, o2)


@pytest.mark.parametrize('N,n_fft', [(10000, 598), (9000, 128),
                                     (7000, 256), (20, 30)])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_stft_modes_sx_bit_identical(dev, N, n_fft, dtype):
    """B6's Sx is bit-identical across its modes 0, 1 and 2, and B7's V is
    bit-identical to B6's Sx (mode 0) with the bank's first table as H:
    one DFT engine, the same products and butterflies."""
    xh, H, Hd, bins, _ = _stft_inputs(N, n_fft, dtype, dev)
    Sx, _ = stft_conv(xh, H, None, N)
    for Hd_, bins_ in ((Hd, None), (Hd, bins)):
        assert torch.equal(stft_conv(xh, H, Hd_, N, 1., bins_)[0], Sx)
    xh, tables, bins, _ = _fsst2_inputs(N, n_fft, dtype, dev)
    V, _ = fsst2_conv(xh, tables, N, 1., bins)
    assert torch.equal(V, stft_conv(xh, tables[0], None, N)[0])


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
    """Large accumulators in float64 on the ring's plan: nbins = 1000
    takes one 128-byte line of values per row (8 columns) at one block
    per SM; nbins = 4096 halves the line twice (2 columns per block)."""
    na, N = 64, 5000
    Wx, dWx = _noise_planes((na, N), 'float64', dev, seed=2)
    c = torch.ones(na, dtype=torch.float64, device=dev)
    for nbins, columns in ((1000, 8), (4096, 2)):
        params = ssq_bin_params(_grid('log', nbins), True)
        assert scatter_launch_plan(5, nbins, 16, dev).columns == columns
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


@pytest.mark.parametrize('N,scales', [(7001, 'log-piecewise'),
                                      (7001, 'log'), (4096, 'linear'),
                                      (160000, 'log-piecewise')])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_ssq_fused_equals_scatter_on_cwt_bins(dev, N, scales, dtype):
    """B4 on the derivative CWT planes (B3) against B2 on the CWT
    kernel's own bins (B1) of the same signal, one signal and a batch of
    two: the two kernels share the ring and `bins.cuh::phase_bin`, so
    their Tx agree within the bins criterion (float32; 1e-9 of max in
    float64), and B4's batch rows equal its one-signal launches."""
    xh, sc, c, wav, n_up, n1, params, gamma = _inputs(N, dtype, scales, dev,
                                                      seed=N)
    nbins = params['omax'] + 1
    Wx, dWx = cwt_fused(xh, sc, wav, n_up, n1, N, 1., True, True)
    Wx_b, k_b = cwt_bins(xh, sc, wav, n_up, n1, N, 1., True, params, gamma,
                         True)
    Tx = ssq_fused(Wx, dWx, c, params, gamma, True)
    _fused_close(Tx, scatter_kv(Wx_b, k_b, c, nbins), dtype)
    if N < 160000:
        Wb, dWb = torch.stack([Wx, Wx.flip(-1)]), torch.stack(
            [dWx, dWx.flip(-1)])
        Tb = ssq_fused(Wb, dWb, c, params, gamma, True)
        assert torch.equal(Tb[0], Tx)
        assert torch.equal(Tb[1], ssq_fused(Wb[1].contiguous(),
                                            dWb[1].contiguous(), c, params,
                                            gamma, True))


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


def _b5_inputs(shape, nbins, dtype, dev, seed=0):
    """White-noise v, k over [-2 nbins, 2 nbins) with k = -1, -nbins,
    -nbins - 1 and nbins planted in each signal's first row, valid false
    on ~20% of cells, a per-row const."""
    rng = np.random.default_rng(seed)
    cdt = torch.complex64 if dtype == 'float32' else torch.complex128
    v = torch.as_tensor(rng.standard_normal(shape)
                        + 1j * rng.standard_normal(shape), dtype=cdt,
                        device=dev)
    k = rng.integers(-2 * nbins, 2 * nbins, shape)
    k[..., 0, :4] = [-1, -nbins, -nbins - 1, nbins]
    valid = rng.random(shape) > .2
    valid[..., 0, :4] = True
    c = torch.as_tensor(rng.random(shape[-2]) + .5,
                        dtype=getattr(torch, dtype), device=dev)
    return (v, torch.as_tensor(k, dtype=torch.int32, device=dev),
            torch.as_tensor(valid, device=dev), c)


def _b5_close(out, ref, dtype):
    tol = 1e-5 if dtype == 'float32' else 1e-12
    assert (out - ref).abs().max() <= tol * ref.abs().max()


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_shift_scatter_kernel_vs_plain(dev, dtype):
    """B5 on white noise with the wrap (k = -1 -> nbins - 1, k = -nbins
    -> 0) and the drop on both sides (k < -nbins, k >= nbins) and invalid
    cells; with and without the mask and the const; bit-identical
    repeats."""
    na, N, nbins = 300, 20000, 290
    v, k, valid, c = _b5_inputs((na, N), nbins, dtype, dev)
    for vd, cc in ((valid, c), (valid, None), (None, c), (None, None)):
        n0 = shift_scatter.launches
        o1 = shift_scatter(v, k, vd, nbins, cc)
        o2 = shift_scatter(v, k, vd, nbins, cc)
        torch.cuda.synchronize()
        assert shift_scatter.launches - n0 == 2 and torch.equal(o1, o2)
        _b5_close(o1, shift_scatter_plain(v, k, vd, nbins, cc), dtype)
    # the planted cells, one column each: k = -1 and -nbins wrap, k =
    # -nbins - 1 and nbins are dropped
    one = shift_scatter(v[:1, :4].contiguous(), k[:1, :4].contiguous(), None,
                        nbins)
    assert torch.equal(one[nbins - 1, 0], v[0, 0])
    assert torch.equal(one[0, 1], v[0, 1])
    assert not one[:, 2:].abs().any()


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_shift_scatter_batched(dev, dtype):
    """A (3, na, N) batch in one launch: each signal's out bit-identical
    to the one-signal launch, and against the plain version."""
    B, na, N, nbins = 3, 200, 9000, 190
    v, k, valid, c = _b5_inputs((B, na, N), nbins, dtype, dev, seed=1)
    n0 = shift_scatter.launches
    out = shift_scatter(v, k, valid, nbins, c)
    torch.cuda.synchronize()
    assert shift_scatter.launches - n0 == 1 and out.shape == (B, nbins, N)
    for b in range(B):
        assert torch.equal(out[b], shift_scatter(v[b], k[b], valid[b],
                                                 nbins, c))
    _b5_close(out, shift_scatter_plain(v, k, valid, nbins, c), dtype)


def test_shift_scatter_narrow_blocks(dev):
    """nbins = 1000 in float64 leaves the accumulator room for 8 columns
    per block."""
    v, k, valid, c = _b5_inputs((64, 5000), 1000, 'float64', dev, seed=2)
    out = shift_scatter(v, k, valid, 1000, c)
    assert out.shape == (1000, 5000)
    _b5_close(out, shift_scatter_plain(v, k, valid, 1000, c), 'float64')


def test_public_sixth_slice_on_card(dev):
    """Every squeezing option on the card: ssq_cwt with get_w and with
    get_dWx + 'lebesgue' (B3 -> phase -> B5), ssq_stft at hop 4 with
    'abs' (B5), ssqueeze from w (B5), 'lebesgue' ssq_stft and 'abs'
    ssq_cwt2 / ssq_stft2 (their kernels' bins -> B2), a callable on
    ssq_cwt; each through its kernels and against the plain path. The
    chirp carries white noise: without it the far scales hold |Wx| near
    gamma, where the kernel's and cuFFT's float32 planes gate different
    cells, and 'lebesgue' weighs every kept cell alike."""
    N = 8000
    t = np.linspace(0, 6, N, endpoint=False)
    x = (np.cos(2 * np.pi * 2 * np.exp(t / 2))
         + .1 * np.random.default_rng(0).standard_normal(N)
         ).astype(np.float32)
    n3, n5, n1 = cwt_fused.launches, shift_scatter.launches, cwt_bins.launches
    Tx, Wx, fr, sc, w = stq.ssq_cwt(x, get_w=True)
    assert cwt_fused.launches > n3 and shift_scatter.launches > n5
    assert cwt_bins.launches == n1
    assert stq.toolkit.mad_rms(x, stq.issq_cwt(Tx)) < 0.1
    Tx_c, Wx_c, _, _, w_c = stq.ssq_cwt(x, get_w=True, device='cpu')
    assert _rel_err(Wx.cpu(), Wx_c) <= 2e-5
    # w is gated where |Wx| < gamma on the card's own planes
    g2 = torch.tensor(10 * float(np.finfo(np.float32).eps)) ** 2
    assert torch.equal(torch.isinf(w),
                       Wx.real * Wx.real + Wx.imag * Wx.imag < g2.to(dev))
    _bins_criterion(Tx.cpu(), Tx_c)
    n5 = shift_scatter.launches
    Tx_s, _ = stq.ssqueeze(Wx, w=w, scales=sc.reshape(-1, 1),
                           ssq_freqs=fr[::-1].copy(), flipud=True)
    assert Tx_s.is_cuda and shift_scatter.launches > n5
    assert torch.equal(Tx_s, Tx)
    calls = (
        (dict(get_dWx=True, squeezing='lebesgue'), stq.ssq_cwt,
         shift_scatter),
        (dict(squeezing=lambda W: W * W.abs()), stq.ssq_cwt, scatter_kv),
        (dict(hop_len=4, squeezing='abs', n_fft=256), stq.ssq_stft,
         shift_scatter),
        (dict(squeezing='lebesgue', n_fft=256), stq.ssq_stft, scatter_kv),
        (dict(squeezing='abs'), stq.ssq_cwt2, scatter_kv),
        (dict(squeezing='abs', n_fft=256), stq.ssq_stft2, scatter_kv))
    for kw, fn, kern in calls:
        n0 = kern.launches
        out = fn(x, **kw)
        assert kern.launches > n0, (fn.__name__, kw)
        out_c = fn(x, device='cpu', **kw)
        assert _rel_err(out[1].cpu(), out_c[1]) <= 2e-5
        if fn in (stq.ssq_cwt2, stq.ssq_stft2):
            _bins2_criterion(out[0].cpu(), out_c[0])
        else:
            _bins_criterion(out[0].cpu(), out_c[0])


# (N, na, nbins, B): N of one column, odd, just over one block; one row,
# a few, the headline's; bins from one to the most the plan takes
RAGGED = [(1, 1, 1, 1), (1, 293, 2, 3), (31, 5, 293, 3), (31, 1, 1, 3),
          (33, 293, 4096, 1), (33, 5, 'max', 3), (7001, 293, 293, 3),
          (7001, 1, 'max', 1), (7001, 5, 4096, 3), (10000, 5, 2, 3),
          (10000, 293, 4096, 1), (10000, 293, 293, 1)]


@pytest.mark.parametrize('N,na,nbins,B', RAGGED)
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_ring_scatters_ragged(dev, dtype, N, na, nbins, B):
    """B2 and B5 in its four instantiations (mask and const, mask only,
    const only, neither) against their plain versions, with k outside
    [0, nbins) planted on both sides (B5: wrapped and dropped); two runs
    bit-identical, one launch each, batch rows bit-identical to one-signal
    launches."""
    if nbins == 'max':
        nbins = 25600 if dtype == 'float32' else 12800
    rng = np.random.default_rng(N + na + nbins + B)
    shape = (B, na, N) if B > 1 else (na, N)
    cdt = torch.complex64 if dtype == 'float32' else torch.complex128
    v = torch.as_tensor(rng.standard_normal(shape)
                        + 1j * rng.standard_normal(shape), dtype=cdt,
                        device=dev)
    k2 = torch.as_tensor(rng.integers(-3, nbins + 3, shape),
                         dtype=torch.int32, device=dev)
    k5 = torch.as_tensor(rng.integers(-2 * nbins - 2, 2 * nbins + 2, shape),
                         dtype=torch.int32, device=dev)
    valid = torch.as_tensor(rng.random(shape) > .2, device=dev)
    c = torch.as_tensor(rng.random(na) + .5, dtype=getattr(torch, dtype),
                        device=dev)
    tol = 1e-5 if dtype == 'float32' else 1e-12
    runs = [('B2', scatter_kv, scatter_kv_plain, (v, k2, c, nbins), None)]
    for vd, cc in ((valid, c), (valid, None), (None, c), (None, None)):
        runs.append(('B5', shift_scatter, shift_scatter_plain,
                     (v, k5, vd, nbins, cc), vd))
    for what, fn, plain, args, vd in runs:
        n0 = fn.launches
        o1, o2 = fn(*args), fn(*args)
        torch.cuda.synchronize()
        assert fn.launches - n0 == 2 and o1.shape == shape[:-2] + (nbins, N)
        assert torch.equal(o1, o2), what
        ref = plain(*args)
        assert (o1 - ref).abs().max() <= tol * ref.abs().max(), what
        for b in range(B if B > 1 else 0):
            one = [a[b] if isinstance(a, torch.Tensor) and a.dim() == 3
                   else a for a in args]
            assert torch.equal(o1[b], fn(*one)), (what, b)
        del o1, o2, ref


@pytest.mark.parametrize('nbins', [1, 31, 293, 300, 4096, 'max'])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_scatter_plan_blocks_per_sm_granted(dev, dtype, nbins):
    """Each plan of B2 and B5 (with and without the mask and const) is the
    card's: its shared bytes are the kernel's and its blocks per SM the
    runtime's for the plan's columns and stages, at every nbins; at the
    headline it is the plan the CPU model gives (16 or 8 columns, three
    stages, five blocks per SM, 16 KB or more in flight)."""
    if nbins == 'max':
        nbins = 25600 if dtype == 'float32' else 12800
    lib = _build.load('scatter_kv')
    itemsize = 8 if dtype == 'float32' else 16
    # kind 0: B2; 1: B5 with mask and const; 4: B5 with neither
    for kind in (0, 1, 4):
        p = scatter_launch_plan(kind, nbins, itemsize, dev)
        got, smem = ctypes.c_int(0), ctypes.c_int(0)
        _build.check(lib.scatter_occupancy(kind, int(itemsize == 16), nbins,
                                           p.columns, p.stages,
                                           ctypes.byref(got),
                                           ctypes.byref(smem)),
                     'scatter_occupancy')
        assert (smem.value, got.value) == (p.smem, p.blocks_per_sm), (
            kind, p)
        assert p.smem <= 232448 and p.blocks_per_sm >= 1
        if nbins == 293 and kind < 4:
            assert (p.columns * itemsize, p.stages, p.blocks_per_sm) == (
                128, 3, 5), (kind, p)
            assert p.inflight >= 16 * 1024


@pytest.mark.parametrize('N,na,nbins,B', RAGGED)
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_ssq_fused_ragged(dev, dtype, N, na, nbins, B):
    """B4 without and with Sfs at the ragged shapes of the scatters (bins
    from one to the most the plan takes, a log grid from 4 bins) against
    its plain version: the bins criterion in float32, 1e-9 of max in
    float64; two runs bit-identical, one launch each, batch rows
    bit-identical to one-signal launches."""
    if nbins == 'max':
        nbins = 25600 if dtype == 'float32' else 12800
    params = (dict(mode='lin', vmin=0., dv=1., omax=0) if nbins == 1
              else ssq_bin_params(_grid('lin', nbins), False) if nbins < 4
              else ssq_bin_params(_grid('log', nbins), True))
    shape = (B, na, N) if B > 1 else (na, N)
    Wx, dWx = _noise_planes(shape, dtype, dev, seed=N + na + nbins + B)
    rdt = getattr(torch, dtype)
    c = torch.as_tensor(np.random.default_rng(N).random(na) + .5,
                        dtype=rdt, device=dev)
    Sfs = torch.linspace(0, .5, na, dtype=rdt, device=dev)
    for sfs in (None, Sfs):
        args = (Wx, dWx, c, params, .1, True, sfs)
        n0 = ssq_fused.launches
        o1, o2 = ssq_fused(*args), ssq_fused(*args)
        torch.cuda.synchronize()
        assert ssq_fused.launches - n0 == 2
        assert o1.shape == shape[:-2] + (nbins, N) and torch.equal(o1, o2)
        _fused_close(o1, ssq_fused_plain(*args), dtype)
        for b in range(B if B > 1 else 0):
            assert torch.equal(o1[b], ssq_fused(Wx[b], dWx[b], *args[2:]))
        del o1, o2


@pytest.mark.parametrize('nbins', [1, 31, 293, 300, 4096, 'max'])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_fused_plan_blocks_per_sm_granted(dev, dtype, nbins):
    """B4's plans (without and with Sfs) are the card's: the shared bytes
    are the kernel's and the blocks per SM the runtime's for the plan's
    columns and stages, at every nbins; at ssq_cwt's 293 bins and
    ssq_stft's 300 the plan the CPU model gives (one 128-byte line of
    values per row, three stages, five blocks per SM)."""
    if nbins == 'max':
        nbins = 25600 if dtype == 'float32' else 12800
    lib = _build.load('scatter_kv')
    itemsize = 8 if dtype == 'float32' else 16
    for kind in (5, 6):
        p = scatter_launch_plan(kind, nbins, itemsize, dev)
        got, smem = ctypes.c_int(0), ctypes.c_int(0)
        _build.check(lib.scatter_occupancy(kind, int(itemsize == 16), nbins,
                                           p.columns, p.stages,
                                           ctypes.byref(got),
                                           ctypes.byref(smem)),
                     'scatter_occupancy')
        assert (smem.value, got.value) == (p.smem, p.blocks_per_sm), (
            kind, p)
        assert p.smem <= 232448 and p.blocks_per_sm >= 1
        if nbins in (293, 300):
            assert (p.columns * itemsize, p.stages, p.blocks_per_sm) == (
                128, 3, 5), (kind, p)
            assert p.inflight >= 16 * 1024
