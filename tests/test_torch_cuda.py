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
(B2) rows bit-identical to one signal run alone. The STFT table kernel
(B6 in its three modes, B7) and B8 over a batch of spectra: against
their plain versions, each row bit-identical to its signal launched
alone, also with row chunks that cross signals; the public batched
routes through the batched counters only. The generic scatter (B5)
within 1e-5 of max|out| in float32 and
1e-12 in float64 (summation order), bit-identical from run to run and
its batch rows bit-identical to one signal run alone. B2 and the four
instantiations of B5 the same at ragged shapes (N of 1, odd, just over a
block; one row; bins from 1 to the most the launch plan takes), and the
launch plan's shared bytes and blocks per SM the kernel's and the
runtime's. The CWT kernel's mixed engine (n_up 7-smooth, not a power of
two; `padtype=None`) the same as its radix-4 one, on its own counters;
at a length with a prime factor above 7 the public calls launch no CWT
kernel: `cwt_general` or `wsst2_general`, then only B4 or B5, against
the same call on the CPU, and the CWT kernel's wrapper raises on it. The
ridge dynamic program (`ridge_forward`, `ridge_trace`) against its plain
versions on planted inputs: pe bit-identical, the indices equal, float32
and float64, one launch each for a batch; F below, at and one past the
cluster size, a batch that runs in cluster waves, T of 1 and 2, the
rule's largest F, NaN cells and exact ties, clusters of 2, 8 and 16. The w2 modes of B8 (`cwt_w2`, both engines) and B7 (`fsst2_w`)
against their plain versions (`wsst2_rows`, `fsst2_rows`): W/V as above,
w2 with the same inf cells (float64; float32 on all but 0.1% of cells)
and its finite cells within 1e-9 of max in float64; W/V bit-identical to
the bins modes' and the bins of w2 equal to their k; batches and row
chunks bit-identical to one signal. The radix-4 engine at its largest
n_up (2^28, 2^26, 2^24 for 1, 2, 5 planes in float32), Wx past 2^31
elements, and the public calls past the rules on their general routes
alike on the card and the CPU, launching no CWT or STFT kernel.
Each kernel's `torch.autograd.Function`: its forward the kernel's one
launch, bit-identical to the launch without grad; its backward launching
nothing and within 1e-5 of max of the gradient through the plain version
on the card. The CWT kernel's stage-1 support pruning: every mode, both
engines, both sources of psih and both dtypes against the same launch
unpruned through the private hook `cwt_cuda._launch(..., klims=...)`,
bit for bit but for the sign of zero cells; pruned batch rows across row
chunks against one-signal launches; malformed limits raising.
"""
import ctypes

import numpy as np
import pytest
import torch

import ssqueezepy_tpu_torch as stq
from ssqueezepy_tpu_torch.configs import configure
from ssqueezepy_tpu_torch.models.cwt import resolve_wavelet
from ssqueezepy_tpu_torch.models.ssq_cwt import _ssq_cwt_plan
from ssqueezepy_tpu_torch.models.ssq_stft import stft_plan
from ssqueezepy_tpu_torch.models.stft import signal_spectrum
from ssqueezepy_tpu_torch.ops import _build, cwt_cuda, ssq_cuda, stft_cuda
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
from ssqueezepy_tpu_torch.ops.ssq_kernels import (compute_bins,
                                                  indexed_sum_onfly,
                                                  ssq_bin_params)
from ssqueezepy_tpu_torch.models.ssq_stft import fsst2_plan
from ssqueezepy_tpu_torch.ops.stft_conv import conv_bank, conv_table
from ssqueezepy_tpu_torch.ops.stft_cuda import (fsst2_conv, fsst2_conv_plain,
                                                stft_conv, stft_conv_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev(monkeypatch, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # the plan memo on disk writes under the case's own directory
    monkeypatch.setenv('SSQ_TPU_TORCH_CACHE', str(tmp_path / 'plans'))
    return torch.device('cuda')


def _chirp(N):
    n = np.arange(N)
    return np.cos(2 * np.pi * (0.02 * n + 0.3 / (2 * N) * n ** 2))


def _inputs(N, dtype, scales, dev, padtype='reflect', seed=0, x=None):
    """Kernel inputs; `padtype=None`: the unpadded spectrum, n_up = N."""
    spec = ('gmw', {'dtype': dtype})
    wav = resolve_wavelet(spec, N=N)
    plan, _ = _ssq_cwt_plan(wav, N, scales, 16, None, 'peak',
                            padtype is not None, 1.)
    scales_np, const, params = plan.scales, plan.const, plan.params
    n_up, n1 = (N, 0) if padtype is None else pad_params(N, padtype)[:2]
    tdt = getattr(torch, dtype)
    if x is None:
        x = np.random.default_rng(seed).standard_normal(N)
    x = torch.as_tensor(x, dtype=tdt, device=dev)
    xh = rfft(x if padtype is None else padsignal(x, padtype))
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
    the same spectra and scales, and so is B8's W (L1 norm; one signal or
    a batch): one DFT engine, the same spectra and butterflies."""
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
    H = conv_table(plan.window, n_fft, xh.shape[-1], modulated, dtype, dev)
    Hd = conv_table(plan.diff_window, n_fft, xh.shape[-1], modulated, dtype,
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
    tables = conv_bank(plan.bank, n_fft, xh.shape[-1], modulated, dtype, dev)
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


# ---- the band plan of B6/B7 (`ops/stft_conv.py::stft_tables`,
# `fsst2_tables`): banded tables against the banded plain versions ---------
def _banded_inputs(shape, n_fft, dev, seed=0):
    from ssqueezepy_tpu_torch.ops.stft_conv import fsst2_tables, stft_tables
    x = torch.as_tensor(np.random.default_rng(seed).standard_normal(shape),
                        dtype=torch.float32, device=dev)
    xh = signal_spectrum(x, n_fft, 'reflect')
    plan = stft_plan(None, None, n_fft, n_fft, 1., 'float32')
    fplan = fsst2_plan(None, None, n_fft, n_fft, 1., 'float32')
    H, Hd = stft_tables(plan.window, plan.diff_window, n_fft, xh.shape[-1],
                        True, 'float32', dev)
    B = fsst2_tables(fplan.bank, n_fft, xh.shape[-1], True, 'float32', dev)
    assert all(isinstance(t, stft_cuda.BandedTable) for t in (H, Hd, B))
    assert H.br <= H.f1 // 2 and B.br <= B.f1 // 2
    bins = dict(Sfs=torch.as_tensor(plan.Sfs, device=dev),
                params=plan.params, flipud=False,
                gamma=10 * float(np.finfo(np.float32).eps))
    c = torch.full((n_fft // 2 + 1,), plan.const, dtype=torch.float32,
                   device=dev)
    return xh, H, Hd, B, bins, c


def _banded_run(mode, xh, H, Hd, B, bins, N, plain=False):
    """One mode of the banded kernel (or its plain version): 0 Sx, 1 Sx
    and dSx, 2 Sx and k, 3 V and k, 4 V and w2."""
    if mode <= 2:
        fn = stft_conv_plain if plain else stft_conv
        return fn(xh, H, None if mode == 0 else Hd, N, 2.,
                  bins if mode == 2 else None)
    if mode == 3:
        fn = fsst2_conv_plain if plain else fsst2_conv
        return fn(xh, B, N, 2., bins)
    if plain:
        return stft_cuda.fsst2_rows(xh, B, N, 2., bins['Sfs'],
                                    bins['gamma'])
    return stft_cuda.fsst2_w(xh, B, N, 2., bins['Sfs'], bins['gamma'])


@pytest.mark.parametrize('mode', [0, 1, 2, 3, 4])
@pytest.mark.parametrize('shape,n_fft', [((10000,), 598), ((3900,), 128),
                                         ((3, 10000), 598), ((2, 3900), 128)])
def test_banded_kernel_vs_plain(dev, mode, shape, n_fft):
    """Every mode of B6/B7 on banded float32 tables against the banded
    plain version (which expands the band into a zero-filled table): Sx/V
    and dSx within 2e-5 of max, k flips <= 1% and Tx by the bins
    criterion, w2 on the same inf cells but 0.1% and its bins' flips
    <= 1%; one launch of the mode's counter; a batch's rows
    bit-identical to their spectra launched alone."""
    N = shape[-1]
    xh, H, Hd, B, bins, c = _banded_inputs(shape, n_fft, dev)
    wrapper = (stft_conv if mode <= 2 else fsst2_conv if mode == 3
               else stft_cuda.fsst2_w)
    counter = 'batched_launches' if len(shape) == 2 else 'launches'
    n0 = getattr(wrapper, counter)
    nb0 = getattr(wrapper, 'banded_' + counter)
    S_k, o_k = _banded_run(mode, xh, H, Hd, B, bins, N)
    torch.cuda.synchronize()
    assert getattr(wrapper, counter) - n0 == 1
    assert getattr(wrapper, 'banded_' + counter) - nb0 == 1
    S_p, o_p = _banded_run(mode, xh, H, Hd, B, bins, N, plain=True)
    assert _rel_err(S_k, S_p) <= 2e-5
    nbins = bins['params']['omax'] + 1
    if mode == 1:
        assert _rel_err(o_k, o_p) <= 2e-5
    elif mode == 4:
        assert (torch.isinf(o_k) != torch.isinf(o_p)).double().mean() \
            <= 1e-3
        o_k, o_p = (torch.where(v, k, -1) for k, v in (
            compute_bins(w, bins['params'], False) for w in (o_k, o_p)))
    if mode in (2, 3, 4):
        assert (o_k != o_p).double().mean() <= 0.01
        _bins_criterion(scatter_kv_plain(S_k, o_k, c, nbins),
                        scatter_kv_plain(S_p, o_p, c, nbins))
    if len(shape) == 2:
        for b in range(shape[0]):
            one = _banded_run(mode, xh[b].contiguous(), H, Hd, B, bins, N)
            assert torch.equal(one[0], S_k[b])
    assert mode != 0 or o_k is None


@pytest.mark.parametrize('mode', [0, 1, 2, 3, 4])
def test_full_band_bit_identical_to_full_table(dev, mode):
    """The band br = f1, r0 = 0 over the full tables reads every address
    the full-table launch reads: its outputs equal the full launch's bit
    for bit, one signal and a batch."""
    N, n_fft = 10000, 598
    for shape in ((N,), (2, N)):
        xh, H, Hd, bins, _ = _stft_inputs(N, n_fft, 'float32', dev)
        if len(shape) == 2:
            xh = torch.stack([xh, xh.flip(0)])
        xhf, tables, _, _ = _fsst2_inputs(N, n_fft, 'float32', dev)
        f1, f2 = stft_cuda.split_fft_len(xh.shape[-1])
        n_rows = H.shape[0]
        r0 = torch.zeros(n_rows, dtype=torch.int32, device=dev)

        def band(t):
            return stft_cuda.BandedTable(
                t.reshape(t.shape[:-1] + (f1, f2)), r0, f1)
        full = _banded_run(mode, xh, H, Hd, tables, bins, N)
        banded = _banded_run(mode, xh, band(H), band(Hd), band(tables),
                             bins, N)
        for a, b in zip(full, banded):
            assert (a is None and b is None) or torch.equal(a, b)


def test_malformed_band_raises_before_launch(dev):
    xh, H, Hd, B, bins, _ = _banded_inputs((3900,), 128, dev)
    f1 = H.f1
    n0 = stft_conv.launches
    for bad in (stft_cuda.BandedTable(H.t, H.r0.long(), f1),
                stft_cuda.BandedTable(H.t, H.r0.cpu(), f1),
                stft_cuda.BandedTable(H.t, H.r0[:-1], f1),
                stft_cuda.BandedTable(H.t, torch.full_like(H.r0, f1), f1),
                stft_cuda.BandedTable(H.t, torch.full_like(H.r0, -8), f1)):
        with pytest.raises(ValueError):
            stft_conv(xh, bad, None, 3900)
    with pytest.raises(ValueError):
        stft_conv(xh, H, stft_cuda.BandedTable(Hd.t, (Hd.r0 + 8) % f1, f1),
                  3900)
    with pytest.raises(ValueError):
        fsst2_conv(xh, stft_cuda.BandedTable(B.t, B.r0.long(), f1), 3900,
                   1., bins)
    assert stft_conv.launches == n0


def test_public_stft_family_banded_on_card(dev):
    """The public float32 hop-1 calls on banded tables: `stft`, `ssq_stft`
    and `ssq_stft2` on the card against the same calls on the CPU (the
    banded plain versions), and against `stft_band=False` (full tables)
    within 2e-5 of max."""
    N = 19531
    t = np.linspace(0, 6, N, endpoint=False)
    x = np.cos(2 * np.pi * 2 * np.exp(t / 2)).astype(np.float32)
    Sx = stq.stft(x, n_fft=512)
    assert _rel_err(Sx.cpu(), stq.stft(x, n_fft=512, device='cpu')) <= 2e-5
    Tx, Sx1, _, _ = stq.ssq_stft(x, n_fft=512)
    assert torch.equal(Sx1, Sx)
    Tx2, V, _, _ = stq.ssq_stft2(x, n_fft=512)
    Tx2_c, V_c, _, _ = stq.ssq_stft2(x, n_fft=512, device='cpu')
    assert _rel_err(V.cpu(), V_c) <= 2e-5
    _bins2_criterion(Tx2.cpu(), Tx2_c)
    configure(stft_band=False)
    try:
        Sx_f = stq.stft(x, n_fft=512)
        Tx_f = stq.ssq_stft(x, n_fft=512)[0]
    finally:
        configure(stft_band=True)
    assert _rel_err(Sx, Sx_f) <= 2e-5
    _bins_criterion(Tx.cpu(), Tx_f.cpu())


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


# ---- batched STFT table kernel (B6, B7) and WSST2 kernel (B8) -------------
@pytest.mark.parametrize('mode', ['sx', 'sx_dsx', 'bins', 'fsst2'])
@pytest.mark.parametrize('shape,n_fft', [((3, 10000), 598), ((2, 4000), 97),
                                         ((4, 20), 30), ((1, 9000), 128)])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_stft_conv_batched_vs_plain_and_one_signal(dev, mode, shape, n_fft,
                                                   dtype, monkeypatch):
    """B6 (modes 0-2) and B7 over a (B, Np2) batch: one C call per row
    chunk on the batched counter (none on the one-signal counter), within
    tolerance of the plain version, each row bit-identical to its signal
    launched alone, and the same bits with row chunks of 7 (which cross
    signals where the tables' rows are not a multiple of 7)."""
    N = shape[-1]
    wrapper = fsst2_conv if mode == 'fsst2' else stft_conv
    if mode == 'fsst2':
        xh, bank, bins7, c = _fsst2_inputs(shape, n_fft, dtype, dev)
        H = bank[0]

        def run(z):
            return fsst2_conv(z, bank, N, 2., bins7)

        def plain(z):
            return fsst2_conv_plain(z, bank, N, 2., bins7)
    else:
        xh, H, Hd, bins, c = _stft_inputs(shape, n_fft, dtype, dev, seed=11)
        Hd_ = None if mode == 'sx' else Hd
        bins_ = bins if mode == 'bins' else None

        def run(z):
            return stft_conv(z, H, Hd_, N, 2., bins_)

        def plain(z):
            return stft_conv_plain(z, H, Hd_, N, 2., bins_)
    B, Np2 = xh.shape
    n0, nb0 = wrapper.launches, wrapper.batched_launches
    out = run(xh)
    torch.cuda.synchronize()
    assert wrapper.launches == n0 and wrapper.batched_launches - nb0 == 1
    n_rows = H.shape[0]
    assert out[0].shape == (B, n_rows, N)
    ref = plain(xh)
    tol = 2e-5 if dtype == 'float32' else 1e-9
    assert _rel_err(out[0], ref[0]) <= tol
    if mode == 'sx_dsx':
        assert _rel_err(out[1], ref[1]) <= tol
    elif mode in ('bins', 'fsst2'):
        assert out[1].dtype == torch.int32 and out[1].shape == (B, n_rows, N)
        assert (out[1] != ref[1]).double().mean() <= 0.01
        if mode == 'bins':
            nb = bins['params']['omax'] + 1
            _bins_criterion(scatter_kv_plain(out[0], out[1], c, nb),
                            scatter_kv_plain(ref[0], ref[1], c, nb))
    for b in range(B):
        one = run(xh[b].contiguous())
        for o, o1 in zip(out, one):
            assert (o is None and o1 is None) or torch.equal(o[b], o1)
    assert wrapper.launches - n0 == B
    from ssqueezepy_tpu_torch.ops import stft_cuda
    planes = 5 if mode == 'fsst2' else 1 if mode == 'sx' else 2
    monkeypatch.setattr(stft_cuda, '_SCRATCH_BUDGET',
                        planes * Np2 * xh.element_size() * 7)
    nb0 = wrapper.batched_launches
    chunked = run(xh)
    assert wrapper.batched_launches - nb0 == -(-B * n_rows // 7)
    for o, oc in zip(out, chunked):
        assert (o is None and oc is None) or torch.equal(o, oc)


@pytest.mark.parametrize('shape,scales', [((3, 10000), 'log-piecewise'),
                                          ((2, 4001), 'log'),
                                          ((1, 3000), 'linear')])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_cwt_bins2_batched_vs_plain_and_one_signal(dev, shape, scales, dtype,
                                                   monkeypatch):
    """B8 over a (B, n_up/2 + 1) batch: the batched counter only, within
    tolerance of the plain version, each row bit-identical to its signal
    launched alone, and the same bits with row chunks of 7."""
    N = shape[-1]
    _, sc, c, wav, n_up, n1, params, gamma = _inputs(N, dtype, scales, dev)
    x = np.random.default_rng(12).standard_normal(shape)
    xh = rfft(padsignal(torch.as_tensor(x, dtype=getattr(torch, dtype),
                                        device=dev), 'reflect')).contiguous()
    args = (sc, wav, n_up, n1, N, 1., params, gamma, True)
    n0, nb0 = cwt_bins2.launches, cwt_bins2.batched_launches
    W, k = cwt_bins2(xh, *args)
    torch.cuda.synchronize()
    assert cwt_bins2.launches == n0 and cwt_bins2.batched_launches > nb0
    assert W.shape == k.shape == (shape[0], len(sc), N)
    W_p, k_p = cwt_bins2_plain(xh, *args)
    assert _rel_err(W, W_p) <= (2e-5 if dtype == 'float32' else 1e-9)
    assert (k != k_p).double().mean() <= 0.01
    nbins = params['omax'] + 1
    _bins_criterion(scatter_kv_plain(W, k, c, nbins),
                    scatter_kv_plain(W_p, k_p, c, nbins))
    for b in range(shape[0]):
        W1, k1 = cwt_bins2(xh[b].contiguous(), *args)
        assert torch.equal(W1, W[b]) and torch.equal(k1, k[b])
    monkeypatch.setattr(cwt_cuda, '_SCRATCH_BUDGET',
                        5 * n_up * xh.element_size() * 7)
    nb0 = cwt_bins2.batched_launches
    Wc, kc = cwt_bins2(xh, *args)
    assert cwt_bins2.batched_launches - nb0 == -(-shape[0] * len(sc) // 7)
    assert torch.equal(Wc, W) and torch.equal(kc, k)


def _counts():
    return (stft_conv.launches, stft_conv.batched_launches,
            fsst2_conv.launches, fsst2_conv.batched_launches,
            cwt_bins2.launches, cwt_bins2.batched_launches)


def test_public_batched_stft_family_on_card(dev):
    """`stft`, `ssq_stft` (hop 1, hop 4, 'abs', get_dWx), `ssq_stft2` and
    `ssq_cwt2` on a (3, N) batch: on the card, through the batched
    counters (never the one-signal ones), each row against the one-signal
    call and the batch against the plain path, on white noise (Tx by the
    bins criterion, as the second-order kernels on noise; the signal's
    FFT is cuFFT's, batched or not, so rows are held by tolerance here;
    the kernel tests above hold them bit for bit on one spectrum);
    `stft` -> `istft` in float64."""
    N = 6000
    xb = np.random.default_rng(14).standard_normal((3, N)).astype(
        np.float32)
    calls = [
        ('stft', lambda x, **d: (stq.stft(x, n_fft=256, **d),), 1),
        ('stft_dsx', lambda x, **d: stq.stft(x, n_fft=256, derivative=True,
                                             **d), 1),
        ('stft_hop4', lambda x, **d: (stq.stft(x, n_fft=256, hop_len=4,
                                               **d),), None),
        ('ssq_stft', lambda x, **d: stq.ssq_stft(x, n_fft=256, **d)[:2], 1),
        ('ssq_stft_dwx', lambda x, **d: stq.ssq_stft(
            x, n_fft=256, get_dWx=True, **d)[:2], 1),
        ('ssq_stft_hop4', lambda x, **d: stq.ssq_stft(
            x, n_fft=256, hop_len=4, **d)[:2], None),
        ('ssq_stft_hop4_abs', lambda x, **d: stq.ssq_stft(
            x, n_fft=256, hop_len=4, squeezing='abs', **d)[:2], None),
        ('ssq_stft2', lambda x, **d: stq.ssq_stft2(x, n_fft=256, **d)[:2],
         3),
        ('ssq_cwt2', lambda x, **d: stq.ssq_cwt2(x, **d)[:2], 5)]
    for name, fn, counter in calls:
        c0 = _counts()
        out = fn(xb)
        torch.cuda.synchronize()
        dc = [a - b for a, b in zip(_counts(), c0)]
        assert not any(dc[0::2]), name            # no one-signal launch
        assert (dc[counter] >= 1) if counter is not None else not any(dc)
        crit = _bins_criterion
        for b in range(3):
            one = fn(xb[b])
            assert out[-1].is_cuda and out[-1].shape[1:] == one[-1].shape
            assert _rel_err(out[-1][b], one[-1]) <= 2e-5, (name, b)
            if name.startswith('ssq'):
                crit(out[0][b], one[0])
        ref = fn(xb, device='cpu')
        assert _rel_err(out[-1].cpu(), ref[-1]) <= 2e-5, name
        if name.startswith('ssq'):
            crit(out[0].cpu(), ref[0])
    x64 = np.random.default_rng(13).standard_normal((3, N))
    for hop in (1, 8):
        S = stq.stft(x64, n_fft=256, hop_len=hop, dtype='float64')
        assert S.is_cuda and S.shape[0] == 3
        xr = stq.istft(S, n_fft=256, hop_len=hop, N=N)
        assert np.abs(xr - x64).mean() < 1e-12


# ---- the CWT kernel's mixed engine (n_up 7-smooth, not a power of two) --

def _mixed_counts():
    return [getattr(w, a) for w in (cwt_bins, cwt_fused, cwt_bins2)
            for a in ('launches', 'mixed_launches')] + [
        getattr(w, a) for w in (cwt_bins, cwt_bins2)
        for a in ('batched_launches', 'mixed_batched_launches')]


@pytest.mark.parametrize('N', [7, 30, 3000, 3072, 4410, 4725, 99225,
                               160000])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_mixed_engine_vs_plain(dev, N, dtype):
    """B1, B3 (one and two planes, L1 and L2) and B8 on the mixed engine
    against their plain versions on the unpadded spectrum (n_up = N: odd
    lengths, a prime length, factors with no power of two), Wx
    bit-identical across the modes and from run to run, each launch on
    the mixed counters only."""
    xh, sc, c, wav, n_up, n1, params, gamma = _inputs(
        N, dtype, 'log-piecewise', dev, padtype=None)
    assert cwt_cuda.bins_plan(n_up, xh.element_size(), 2).engine == \
        cwt_cuda._ENGINE_MIXED
    tol = 2e-5 if dtype == 'float32' else 1e-9
    args = (xh, sc, wav, n_up, 0, N, 1., True, params, gamma, True)
    c0 = _mixed_counts()
    Wx, k = cwt_bins(*args)
    torch.cuda.synchronize()
    dc = [a - b for a, b in zip(_mixed_counts(), c0)]
    assert dc == [0, 1, 0, 0, 0, 0, 0, 0, 0, 0]
    Wx_p, k_p = cwt_bins_plain(*args)
    assert _rel_err(Wx, Wx_p) <= tol
    assert (k != k_p).double().mean() <= 0.01
    nbins = params['omax'] + 1
    _bins_criterion(scatter_kv_plain(Wx, k, c, nbins),
                    scatter_kv_plain(Wx_p, k_p, c, nbins))
    Wr, kr = cwt_bins(*args)
    assert torch.equal(Wr, Wx) and torch.equal(kr, k)
    for derivative in (False, True):
        W3, dW3 = cwt_fused(xh, sc, wav, n_up, 0, N, 1., derivative, True)
        assert torch.equal(W3, Wx)
        if derivative:
            _, dW_p = cwt_fused_plain(xh, sc, wav, n_up, 0, N, 1., True,
                                      True)
            assert _rel_err(dW3, dW_p) <= tol
    W2, _ = cwt_fused(xh, sc, wav, n_up, 0, N, 1., False, False)
    W2_p, _ = cwt_fused_plain(xh, sc, wav, n_up, 0, N, 1., False, False)
    assert _rel_err(W2, W2_p) <= tol
    W8, k8 = cwt_bins2(xh, sc, wav, n_up, 0, N, 1., params, gamma, True)
    assert torch.equal(W8, Wx)
    W8_p, k8_p = cwt_bins2_plain(xh, sc, wav, n_up, 0, N, 1., params, gamma,
                                 True)
    assert (k8 != k8_p).double().mean() <= 0.01
    _bins_criterion(scatter_kv_plain(W8, k8, c, nbins),
                    scatter_kv_plain(W8_p, k8_p, c, nbins))


@pytest.mark.parametrize('N', [4725, 3000])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_mixed_engine_batch_windows_and_chunks(dev, N, dtype, monkeypatch):
    """B3b and batched B8 rows on the mixed engine bit-identical to each
    signal launched alone; a window [n1, n1 + N') inside n_up; rows in
    chunks that cross signals, bit-identical to one chunk."""
    xh, sc, c, wav, n_up, n1, params, gamma = _inputs(
        N, dtype, 'log', dev, padtype=None)
    xb = torch.stack([xh, xh.flip(0), 0.5 * xh]).contiguous()
    one = [cwt_bins(xb[b].contiguous(), sc, wav, n_up, 0, N, 1., True,
                    params, gamma, True) for b in range(3)]
    one2 = [cwt_bins2(xb[b].contiguous(), sc, wav, n_up, 0, N, 1., params,
                      gamma, True) for b in range(3)]
    c0 = _mixed_counts()
    Wb, kb = cwt_bins(xb, sc, wav, n_up, 0, N, 1., True, params, gamma,
                      True)
    W8b, k8b = cwt_bins2(xb, sc, wav, n_up, 0, N, 1., params, gamma, True)
    torch.cuda.synchronize()
    dc = [a - b for a, b in zip(_mixed_counts(), c0)]
    assert dc == [0, 0, 0, 0, 0, 0, 0, 1, 0, 1]
    for b in range(3):
        assert torch.equal(Wb[b], one[b][0]) and torch.equal(kb[b], one[b][1])
        assert torch.equal(W8b[b], one2[b][0])
        assert torch.equal(k8b[b], one2[b][1])
    lo, n = N // 7, N - N // 7 - 5
    Ww, _ = cwt_fused(xh, sc, wav, n_up, lo, n, 1., True, True)
    assert torch.equal(Ww, one[0][0][:, lo:lo + n])
    monkeypatch.setattr(cwt_cuda, '_SCRATCH_BUDGET', 2 * n_up * 16 * 7)
    Wc, kc = cwt_bins(xb, sc, wav, n_up, 0, N, 1., True, params, gamma,
                      True)
    assert torch.equal(Wc, Wb) and torch.equal(kc, kb)


def test_mixed_public_calls_on_card(dev):
    """`ssq_cwt`, `cwt` and `ssq_cwt2` with `padtype=None` (mixed engine),
    `cwt(rpadded=True)` (radix-4, the whole window) and
    `ssq_cwt(difftype='numeric', get_w=True)` on the card against the
    same calls' plain versions on the CPU."""
    N = 4410
    x = np.random.default_rng(21).standard_normal(N).astype(np.float32)
    xb = np.stack([x, x[::-1].copy()])
    for name, fn, n_ssq in (
            ('ssq_cwt', lambda v, **d: stq.ssq_cwt(v, padtype=None, **d), 1),
            ('ssq_cwt_b2', lambda v, **d: stq.ssq_cwt(
                xb if v is x else v, padtype=None, **d), 1),
            ('ssq_cwt_dwx', lambda v, **d: stq.ssq_cwt(
                v, padtype=None, get_dWx=True, **d), 1),
            ('ssq_cwt_numeric', lambda v, **d: stq.ssq_cwt(
                v, difftype='numeric', get_w=True, **d), 1),
            ('ssq_cwt2', lambda v, **d: stq.ssq_cwt2(v, padtype=None, **d),
             1),
            ('cwt', lambda v, **d: stq.cwt(v, padtype=None, **d), 0),
            ('cwt_rpadded', lambda v, **d: stq.cwt(v, rpadded=True, **d),
             0)):
        c0 = _mixed_counts()
        out = fn(x)
        torch.cuda.synchronize()
        dc = [a - b for a, b in zip(_mixed_counts(), c0)]
        mixed, radix4 = sum(dc[1::2]), sum(dc[0::2])
        if name in ('ssq_cwt_numeric', 'cwt_rpadded'):
            assert radix4 >= 1 and not mixed, name
        else:
            assert mixed >= 1 and not radix4, name
        ref = fn(x, device='cpu')
        W, W_ref = out[1 if n_ssq else 0], ref[1 if n_ssq else 0]
        assert W.is_cuda and W.shape == W_ref.shape
        assert _rel_err(W.cpu(), W_ref) <= 2e-5, name
        if n_ssq:
            _bins_criterion(out[0].cpu(), ref[0])


def test_mixed_length_rule_launches_nothing(dev):
    """A length with a prime factor above 7 (2002 = 2 7 11 13): the CWT
    kernel's wrapper raises on it before any launch, naming the general
    path, and the public calls take that path, launching no CWT kernel
    (more in `test_general_route_counters`)."""
    x = np.random.default_rng(22).standard_normal(2002).astype(np.float32)
    c0 = _mixed_counts()
    with pytest.raises(NotImplementedError, match='general path'):
        cwt_fused(torch.zeros(1002, dtype=torch.complex64, device=dev),
                  torch.ones(3, device=dev), None, 2002, 0, 2002, 1., False,
                  True)
    for fn in (lambda: stq.ssq_cwt(x, padtype=None),
               lambda: stq.cwt(x, padtype=None),
               lambda: stq.ssq_cwt2(x, padtype=None)):
        out = fn()
        torch.cuda.synchronize()
        assert out[0].is_cuda and out[0].shape[-1] == 2002
    assert _mixed_counts() == c0


# ---- the w2 modes of B8 and B7 (get_w of ssq_cwt2 and ssq_stft2) -------
def _w2_close(w2_k, w2_p, dtype, rel=None):
    """The w2 planes: the same inf cells but on at most 0.1% of cells in
    float32 (|W| near gamma), none in float64; finite cells where both are
    finite within 1e-9 of max (float64), and in float32 energy-weighted
    by the cells the kernel bins, held through the bins criterion by the
    caller."""
    inf_k, inf_p = torch.isinf(w2_k), torch.isinf(w2_p)
    gd = (inf_k != inf_p).double().mean()
    if dtype == 'float64':
        assert gd == 0
        both = ~inf_k & ~inf_p
        assert (w2_k[both] - w2_p[both]).abs().max() <= \
            1e-9 * w2_p[both].abs().max()
    else:
        assert gd <= 1e-3
    assert bool((w2_k >= 0).all())


@pytest.mark.parametrize('N,padtype', [
    (10000, 'reflect'), (2048, 'reflect'), (3, 'reflect'),
    # unpadded: the mixed engine (odd, and no power of two)
    (4725, None), (3000, None), (99225, None)])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_cwt_w2_kernel_vs_plain(dev, N, padtype, dtype):
    """B8's w2 mode (`cwt_w2`) against its plain version `wsst2_rows`:
    W within 2e-5 of max (float32) or 1e-9, w2 as `_w2_close`; W
    bit-identical to the bins mode's (`cwt_bins2`) and the bins of w2
    equal to its k; each launch on its engine's counter."""
    xh, sc, c, wav, n_up, n1, params, gamma = _inputs(
        N, dtype, 'log-piecewise', dev, padtype=padtype)
    mixed = padtype is None and n_up & (n_up - 1) != 0
    counter = 'mixed_launches' if mixed else 'launches'
    n0 = getattr(cwt_cuda.cwt_w2, counter)
    W, w2 = cwt_cuda.cwt_w2(xh, sc, wav, n_up, n1, N, 1., gamma)
    torch.cuda.synchronize()
    assert getattr(cwt_cuda.cwt_w2, counter) == n0 + 1
    assert w2.dtype == sc.dtype and w2.shape == W.shape
    W_p, w2_p = cwt_cuda.wsst2_rows(xh, sc, wav, n_up, n1, N, 1., gamma)
    assert _rel_err(W, W_p) <= (2e-5 if dtype == 'float32' else 1e-9)
    _w2_close(w2, w2_p, dtype)
    W8, k8 = cwt_bins2(xh, sc, wav, n_up, n1, N, 1., params, gamma, True)
    assert torch.equal(W, W8)
    k, valid = compute_bins(w2, params, True)
    assert torch.equal(torch.where(valid, k, torch.full_like(k, -1)), k8)
    W2r, w2r = cwt_cuda.cwt_w2(xh, sc, wav, n_up, n1, N, 1., gamma)
    assert torch.equal(W2r, W) and torch.equal(w2r, w2)
    nbins = params['omax'] + 1
    _bins_criterion(indexed_sum_onfly(W, w2, None, c, params=params,
                                      flipud=True),
                    shift_scatter_plain(W_p, *compute_bins(w2_p, params,
                                                           True), nbins, c))


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_cwt_w2_batch_and_chunks(dev, dtype, monkeypatch):
    """`cwt_w2` over a batch of three spectra, on both engines: each row
    bit-identical to its spectrum launched alone, counted on the batched
    counters; rows in chunks that cross signals bit-identical to one
    chunk."""
    for N, padtype in ((4000, 'reflect'), (4725, None)):
        xh, sc, c, wav, n_up, n1, params, gamma = _inputs(
            N, dtype, 'log', dev, padtype=padtype)
        xb = torch.stack([xh, xh.flip(0), 0.5 * xh]).contiguous()
        counter = ('batched_launches' if padtype
                   else 'mixed_batched_launches')
        n0 = getattr(cwt_cuda.cwt_w2, counter)
        Wb, w2b = cwt_cuda.cwt_w2(xb, sc, wav, n_up, n1, N, 1., gamma)
        torch.cuda.synchronize()
        assert getattr(cwt_cuda.cwt_w2, counter) == n0 + 1
        assert Wb.shape == (3, len(sc), N) == w2b.shape
        for b in range(3):
            W1, w21 = cwt_cuda.cwt_w2(xb[b].contiguous(), sc, wav, n_up, n1,
                                      N, 1., gamma)
            assert torch.equal(Wb[b], W1) and torch.equal(w2b[b], w21)
        with monkeypatch.context() as m:
            m.setattr(cwt_cuda, '_SCRATCH_BUDGET', 5 * n_up * 16 * 7)
            Wc, w2c = cwt_cuda.cwt_w2(xb, sc, wav, n_up, n1, N, 1., gamma)
        assert torch.equal(Wc, Wb) and torch.equal(w2c, w2b)


@pytest.mark.parametrize('N,n_fft', [(10000, 598), (4000, 97), (9000, 128),
                                     (7000, 256), (20, 30)])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_fsst2_w_kernel_vs_plain(dev, N, n_fft, dtype):
    """B7's w2 mode (`fsst2_w`) against its plain version `fsst2_rows`: V
    within 2e-5 of max (float32) or 1e-9, w2 as `_w2_close`; V
    bit-identical to the bins mode's (`fsst2_conv`) and the bins of w2
    equal to its k; repeats bit for bit."""
    xh, tables, bins, c = _fsst2_inputs(N, n_fft, dtype, dev)
    from ssqueezepy_tpu_torch.ops import stft_cuda
    n0 = stft_cuda.fsst2_w.launches
    V, w2 = stft_cuda.fsst2_w(xh, tables, N, 2., bins['Sfs'], bins['gamma'])
    torch.cuda.synchronize()
    assert stft_cuda.fsst2_w.launches == n0 + 1
    assert w2.dtype == bins['Sfs'].dtype and w2.shape == V.shape
    V_p, w2_p = stft_cuda.fsst2_rows(xh, tables, N, 2., bins['Sfs'],
                                     bins['gamma'])
    assert _rel_err(V, V_p) <= (2e-5 if dtype == 'float32' else 1e-9)
    _w2_close(w2, w2_p, dtype)
    V7, k7 = fsst2_conv(xh, tables, N, 2., bins)
    assert torch.equal(V, V7)
    k, valid = compute_bins(w2, bins['params'], False)
    assert torch.equal(torch.where(valid, k, torch.full_like(k, -1)), k7)
    Vr, w2r = stft_cuda.fsst2_w(xh, tables, N, 2., bins['Sfs'],
                                bins['gamma'])
    assert torch.equal(Vr, V) and torch.equal(w2r, w2)


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_fsst2_w_batch_and_chunks(dev, dtype, monkeypatch):
    """`fsst2_w` over a batch of three spectra: each row bit-identical to
    its spectrum launched alone, on the batched counter; row chunks that
    cross signals bit-identical to one chunk."""
    from ssqueezepy_tpu_torch.ops import stft_cuda
    N, n_fft = 4000, 128
    x = np.random.default_rng(31).standard_normal((3, N))
    xb, tables, bins, _ = _fsst2_inputs(N, n_fft, dtype, dev, x=x)
    n0 = stft_cuda.fsst2_w.batched_launches
    Vb, w2b = stft_cuda.fsst2_w(xb, tables, N, 1., bins['Sfs'],
                                bins['gamma'])
    torch.cuda.synchronize()
    assert stft_cuda.fsst2_w.batched_launches == n0 + 1
    for b in range(3):
        V1, w21 = stft_cuda.fsst2_w(xb[b].contiguous(), tables, N, 1.,
                                    bins['Sfs'], bins['gamma'])
        assert torch.equal(Vb[b], V1) and torch.equal(w2b[b], w21)
    monkeypatch.setattr(stft_cuda, '_SCRATCH_BUDGET',
                        5 * xb.shape[-1] * 16 * 7)
    Vc, w2c = stft_cuda.fsst2_w(xb, tables, N, 1., bins['Sfs'],
                                bins['gamma'])
    assert torch.equal(Vc, Vb) and torch.equal(w2c, w2b)


def test_public_get_w_order2_on_card(dev):
    """`ssq_cwt2(get_w=True)` and `ssq_stft2(get_w=True)` (one signal,
    and a (2, N) batch for the STFT) on the card: the w2 modes and B5
    launch, no bins mode, B2 or plain version; against the same calls on
    the CPU, and Tx by the bins criterion against the calls without
    `get_w`."""
    from ssqueezepy_tpu_torch.ops import stft_cuda
    N = 6000
    x = np.random.default_rng(32).standard_normal(N).astype(np.float32)
    xb = np.stack([x, x[::-1].copy()])
    watch = [(cwt_cuda.cwt_w2, 'launches'),
             (cwt_cuda.cwt_w2, 'batched_launches'),
             (stft_cuda.fsst2_w, 'launches'),
             (stft_cuda.fsst2_w, 'batched_launches'),
             (shift_scatter, 'launches'), (cwt_bins2, 'launches'),
             (fsst2_conv, 'launches'), (fsst2_conv, 'batched_launches'),
             (scatter_kv, 'launches')]
    for name, fn, ref_fn, need in (
            ('ssq_cwt2', lambda **d: stq.ssq_cwt2(x, get_w=True, **d),
             lambda: stq.ssq_cwt2(x), (0, 4)),
            ('ssq_stft2', lambda **d: stq.ssq_stft2(x, n_fft=256,
                                                    get_w=True, **d),
             lambda: stq.ssq_stft2(x, n_fft=256), (2, 4)),
            ('ssq_stft2_b2', lambda **d: stq.ssq_stft2(xb, n_fft=256,
                                                       get_w=True, **d),
             lambda: stq.ssq_stft2(xb, n_fft=256), (3, 4))):
        c0 = [getattr(w, a) for w, a in watch]
        out = fn()
        torch.cuda.synchronize()
        dc = [getattr(w, a) - v for (w, a), v in zip(watch, c0)]
        assert all(dc[i] == 1 for i in need), (name, dc)
        assert sum(dc) == len(need), (name, dc)
        assert len(out) == 5 and out[4].is_cuda
        ref = fn(device='cpu')
        assert _rel_err(out[1].cpu(), ref[1]) <= 2e-5, name
        assert (torch.isinf(out[4].cpu()) != torch.isinf(ref[4])
                ).double().mean() <= 1e-3
        _bins2_criterion(out[0].cpu(), ref[0])
        _bins_criterion(out[0], ref_fn()[0])


# ---- the lifted radix-4 ceiling and 64-bit offsets ----------------------
@pytest.mark.parametrize('lg,planes', [(28, 1), (26, 2), (24, 5)])
def test_radix4_ceiling_vs_plain(dev, lg, planes):
    """The radix-4 engine at its largest n_up in float32 (one column per
    block, up to 220 KB of shared memory): 2^28 with one plane (Wx), 2^26
    with two (Wx, dWx), 2^24 with five (order 2, W and w2), two scales,
    the unpadded spectrum of white noise, against the plain versions;
    one past it raises naming C1b and launches nothing."""
    n_up = 1 << lg
    plan = cwt_cuda.cwt_length_rule(n_up, 8, planes)
    assert plan.P1 == 1 and plan.smem1 > cwt_cuda._SMEM_BUDGET
    wav = resolve_wavelet(('gmw', {'dtype': 'float32'}), N=n_up)
    x = torch.randn(n_up, generator=torch.Generator(device=dev).manual_seed(
        lg), device=dev)
    xh = rfft(x)
    del x
    sc = torch.tensor([4., 64.], device=dev)
    if planes == 5:
        W, w2 = cwt_cuda.cwt_w2(xh, sc, wav, n_up, 0, n_up, 1., 1e-6)
        torch.cuda.synchronize()
        W_p, w2_p = cwt_cuda.wsst2_rows(xh, sc, wav, n_up, 0, n_up, 1., 1e-6)
        assert _rel_err(W, W_p) <= 2e-5
        _w2_close(w2, w2_p, 'float32')
        del W, w2, W_p, w2_p
    else:
        deriv = planes == 2
        W, dW = cwt_fused(xh, sc, wav, n_up, 0, n_up, 1., deriv, True)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(torch.view_as_real(W)).all())
        W_p, dW_p = cwt_fused_plain(xh, sc, wav, n_up, 0, n_up, 1., deriv,
                                    True)
        assert _rel_err(W, W_p) <= 2e-5
        if deriv:
            assert _rel_err(dW, dW_p) <= 2e-5
        del W, dW, W_p, dW_p
    torch.cuda.empty_cache()
    c0 = _mixed_counts() + [cwt_cuda.cwt_w2.launches]
    with pytest.raises(NotImplementedError, match='queue C, C1b'):
        cwt_cuda.cwt_length_rule(2 * n_up, 8, planes)
    xh2 = torch.zeros(n_up + 1, dtype=torch.complex64, device=dev)
    with pytest.raises(NotImplementedError, match='queue C, C1b'):
        if planes == 5:
            cwt_cuda.cwt_w2(xh2, sc, wav, 2 * n_up, 0, 8, 1., 1e-6)
        else:
            cwt_fused(xh2, sc, wav, 2 * n_up, 0, 8, 1., planes == 2, True)
    assert _mixed_counts() + [cwt_cuda.cwt_w2.launches] == c0


def test_cwt_offsets_past_2_31(dev):
    """Wx of 640 rows x 2^22 columns (2.7e9 elements, past 2^31): the
    first and last rows against the plain version on their scales alone
    (a row's arithmetic does not depend on its index), and the rows of
    the last chunk bit-identical to a launch of those scales alone."""
    n_up = 1 << 22
    wav = resolve_wavelet(('gmw', {'dtype': 'float32'}), N=n_up)
    x = torch.randn(n_up, generator=torch.Generator(device=dev).manual_seed(
        7), device=dev)
    xh = rfft(x)
    sc = torch.as_tensor(np.geomspace(2., 2000., 640), dtype=torch.float32,
                         device=dev)
    assert len(sc) * n_up > 2 ** 31
    W, _ = cwt_fused(xh, sc, wav, n_up, 0, n_up, 1., False, True)
    torch.cuda.synchronize()
    for rows in (slice(0, 2), slice(638, 640)):
        W_p, _ = cwt_fused_plain(xh, sc[rows].contiguous(), wav, n_up, 0,
                                 n_up, 1., False, True)
        assert _rel_err(W[rows], W_p) <= 2e-5
        W1, _ = cwt_fused(xh, sc[rows].contiguous(), wav, n_up, 0, n_up, 1.,
                          False, True)
        assert torch.equal(W[rows], W1)
        del W_p, W1
    del W
    torch.cuda.empty_cache()


def _transform_launches():
    """Every launch counter of the CWT and STFT kernels' wrappers."""
    return {'%s.%s' % (w.__name__, a): getattr(w, a)
            for w in (cwt_bins, cwt_fused, cwt_bins2, cwt_cuda.cwt_w2,
                      stft_conv, fsst2_conv, stft_cuda.fsst2_w)
            for a in vars(w) if a.endswith('launches')}


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_rules_raise_alike_on_both_devices(dev, dtype, monkeypatch):
    """Past the kernels' rules the public calls take their general routes
    alike on the card and the CPU (they raised naming C1b before those
    routes came): `ssq_stft` with more bins than the scatters take
    (n_fft = 51200 in float32, 25600 in float64; hann, N = 4096) on
    `stft_general` and `scatter_general`, finite; then, with the three
    predicates answering False (chip_smoke.py 12i (b) at the CPU tests'
    shapes, N = 2048), `ssq_cwt`, `cwt`, `ssq_cwt2`, `stft`, `ssq_stft`
    and `ssq_stft2`: no launch of a CWT or STFT kernel, the planes within
    2e-5 (float32) or 1e-9 (float64) of max of the same call on the CPU,
    Tx by the bins criterion."""
    from ssqueezepy_tpu_torch.ops.ssq_kernels import scatter_general
    itemsize = 8 if dtype == 'float32' else 16
    tol = 2e-5 if dtype == 'float32' else 1e-9
    x4k = np.random.default_rng(4).standard_normal(4096).astype(dtype)
    c0, g0 = _transform_launches(), scatter_general.calls
    Tx, Sx = stq.ssq_stft(x4k, n_fft=2 * (200 * 1024 // itemsize),
                          window='hann', dtype=dtype)[:2]
    torch.cuda.synchronize()
    assert _transform_launches() == c0
    assert scatter_general.calls == g0 + 1
    assert Tx.shape == (200 * 1024 // itemsize + 1, 4096)
    assert bool(torch.isfinite(torch.view_as_real(Tx)).all())
    del Tx, Sx
    for mod, name in ((cwt_cuda, 'cwt_kernel_fits'),
                      (stft_cuda, 'stft_kernel_fits'),
                      (ssq_cuda, 'scatter_fits')):
        monkeypatch.setattr(mod, name, lambda *a: False)
    x = np.random.default_rng(5).standard_normal(2048).astype(dtype)
    wav = ('gmw', {'dtype': dtype})
    sc = 2. ** (1.5 + np.arange(12) / 2)
    calls = {
        'ssq_cwt': lambda d: stq.ssq_cwt(x, wav, scales=sc, device=d)[:2],
        'cwt': lambda d: stq.cwt(x, wav, scales=sc, nv=None,
                                 device=d)[:1],
        'ssq_cwt2': lambda d: stq.ssq_cwt2(x, wav, scales=sc,
                                           device=d)[:2],
        'stft': lambda d: (stq.stft(x, n_fft=96, dtype=dtype, device=d),),
        'ssq_stft': lambda d: stq.ssq_stft(x, n_fft=96, dtype=dtype,
                                           device=d)[:2],
        'ssq_stft2': lambda d: stq.ssq_stft2(x, n_fft=96, dtype=dtype,
                                             device=d)[:2]}
    for name, fn in calls.items():
        c0 = _transform_launches()
        out = fn('cuda')
        torch.cuda.synchronize()
        assert _transform_launches() == c0, name
        ref = fn('cpu')
        assert _rel_err(out[-1].cpu(), ref[-1]) <= tol, name
        if len(out) == 2:
            _bins_criterion(out[0].cpu(), ref[0])


# ---- the wavelet table: every other wavelet through every mode -----------
def _gauss_bump(w):
    """A user's wavelet: a real Gaussian bump at w = 4."""
    return torch.exp(-(w - 4.) ** 2) * (w > 0)


def _table_inputs(N, dtype, spec, dev, padtype='reflect', seed=0, B=None):
    """Kernel inputs for wavelet `spec` at its own log-piecewise plan;
    `B` makes a (B, n_up//2 + 1) batch of spectra."""
    if callable(spec):
        wav = resolve_wavelet(stq.Wavelet(spec, dtype=dtype), N=N)
    else:
        wav = resolve_wavelet((spec[0], dict(spec[1], dtype=dtype)), N=N)
    # the bump's piecewise ssq grid has no knee at N = 3000 unpadded (in
    # the JAX package too): its plan takes 'log' scales
    plan, _ = _ssq_cwt_plan(wav, N, 'log' if wav.name == 'Bump' else
                            'log-piecewise', 16, None, 'peak',
                            padtype is not None, 1.)
    n_up, n1 = (N, 0) if padtype is None else pad_params(N, padtype)[:2]
    tdt = getattr(torch, dtype)
    x = np.random.default_rng(seed).standard_normal(
        N if B is None else (B, N))
    x = torch.as_tensor(x, dtype=tdt, device=dev)
    xh = rfft(x if padtype is None else padsignal(x, padtype)).contiguous()
    sc = torch.as_tensor(plan.scales.ravel(), dtype=tdt, device=dev)
    c = torch.as_tensor(np.broadcast_to(np.ravel(plan.const),
                                        (len(sc),)).copy(),
                        dtype=tdt, device=dev)
    gamma = 10 * float(np.finfo(dtype).eps)
    return xh, sc, c, wav, n_up, n1, plan.params, gamma


# each mode with a wavelet of its own: B1 cmhat, B3 hhhat and an order-1
# GMW (L2, two planes), B8 morlet (bins) and the order-2 GMW (w2), B3b a
# bump and the user's Gaussian
_TABLE_MODES = {'bins': ('cmhat', {}), 'wx': ('hhhat', {}),
                'wx_dwx': ('gmw', {'order': 1, 'norm': 'energy'}),
                'order2': ('morlet', {}), 'w2': ('gmw', {'order': 2}),
                'batched': ('bump', {}), 'custom': _gauss_bump}
_TABLE_SHAPES = [(10000, 'reflect'), (2048, 'reflect'), (4725, None),
                 (3000, None)]


def _table_run(mode, xh, sc, c, wav, n_up, n1, N, params, gamma,
               plain=False):
    """The kernel's outputs in `mode` (its plain version's with
    `plain`)."""
    if mode in ('bins', 'batched', 'custom'):
        a = (xh, sc, wav, n_up, n1, N, 1., True, params, gamma, True)
        return (cwt_bins_plain if plain else cwt_bins)(*a)
    if mode in ('wx', 'wx_dwx'):
        a = (xh, sc, wav, n_up, n1, N, 1., mode == 'wx_dwx',
             mode != 'wx_dwx')
        return (cwt_fused_plain if plain else cwt_fused)(*a)
    if mode == 'order2':
        a = (xh, sc, wav, n_up, n1, N, 1., params, gamma, True)
        return (cwt_bins2_plain if plain else cwt_bins2)(*a)
    a = (xh, sc, wav, n_up, n1, N, 1., gamma)
    return (cwt_cuda.wsst2_rows if plain else cwt_cuda.cwt_w2)(*a)


def _table_wrapper(mode):
    return {'wx': cwt_fused, 'wx_dwx': cwt_fused, 'order2': cwt_bins2,
            'w2': cwt_cuda.cwt_w2}.get(mode, cwt_bins)


@pytest.mark.parametrize('N,padtype', _TABLE_SHAPES)
@pytest.mark.parametrize('mode', list(_TABLE_MODES))
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_table_modes_vs_plain(dev, N, padtype, mode, dtype):
    """Every mode of the CWT kernel with a wavelet read from its table
    (B1, B3 with one and two planes, B8 bins and w2, B3b) against its plain
    version on both engines: Wx (and dWx) within 2e-5 of max (float32) or
    1e-9, bins on at most 1% of cells, w2 as `_w2_close`; each launch on
    its engine's table counter, none on the closed form's; two runs
    bit-identical."""
    B = 2 if mode == 'batched' else None
    xh, sc, c, wav, n_up, n1, params, gamma = _table_inputs(
        N, dtype, _TABLE_MODES[mode], dev, padtype, B=B)
    mixed = n_up & (n_up - 1) != 0
    counter = ('table_' + ('mixed_' if mixed else '')
               + ('batched_launches' if B else 'launches'))
    wrapper = _table_wrapper(mode)
    before = {a: getattr(wrapper, a) for a in dir(wrapper)
              if a.endswith('launches')}
    args = (mode, xh, sc, c, wav, n_up, n1, N, params, gamma)
    out = _table_run(*args)
    torch.cuda.synchronize()
    plain = _table_run(*args, plain=True)
    moved = {a: getattr(wrapper, a) - v for a, v in before.items()
             if getattr(wrapper, a) != v}
    assert moved == {counter: 1}, moved
    tol = 2e-5 if dtype == 'float32' else 1e-9
    assert _rel_err(out[0], plain[0]) <= tol
    if mode == 'wx_dwx':
        assert _rel_err(out[1], plain[1]) <= tol
    elif mode == 'w2':
        _w2_close(out[1], plain[1], dtype)
    elif mode != 'wx':
        assert (out[1] != plain[1]).double().mean() <= 0.01
        nbins = params['omax'] + 1
        Tx_k = scatter_kv_plain(out[0], out[1], c, nbins)
        Tx_p = scatter_kv_plain(plain[0], plain[1], c, nbins)
        (_bins2_criterion if mode == 'order2' else _bins_criterion)(
            Tx_k, Tx_p)
    again = _table_run(*args)
    for a, b in zip(out, again):
        assert a is None or torch.equal(a, b)


@pytest.mark.parametrize('N,padtype', _TABLE_SHAPES)
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_table_batch_rows_equal_one_signal(dev, N, padtype, dtype):
    """B3b and B8 in table mode over a batch of three spectra: each row
    bit-identical to its spectrum launched alone."""
    xh, sc, c, wav, n_up, n1, params, gamma = _table_inputs(
        N, dtype, ('gmw', {'order': 1}), dev, padtype, B=3)
    for fn, a in ((cwt_bins, (sc, wav, n_up, n1, N, 1., True, params,
                              gamma, True)),
                  (cwt_bins2, (sc, wav, n_up, n1, N, 1., params, gamma,
                               True))):
        Wb, kb = fn(xh, *a)
        for b in range(3):
            W1, k1 = fn(xh[b].contiguous(), *a)
            assert torch.equal(W1, Wb[b]) and torch.equal(k1, kb[b])


@pytest.mark.parametrize('N,padtype', [(10000, 'reflect'), (4725, None)])
@pytest.mark.parametrize('mode', ['bins', 'wx_dwx', 'order2', 'w2'])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_gmw_through_table_vs_closed_form(dev, N, padtype, mode, dtype):
    """The order-0 GMW read from a table (its fn wrapped as a user's
    callable: no closed form, derivatives by autograd) against the same
    GMW synthesized in the kernel: within 2e-5 of max (float32) or 1e-9,
    bins on at most 1% of cells."""
    xh, sc, c, wav, n_up, n1, params, gamma = _inputs(
        N, dtype, 'log-piecewise', dev, padtype=padtype)
    gmw_fn = wav.fn
    twin = resolve_wavelet(stq.Wavelet(lambda w: gmw_fn(w), dtype=dtype))
    run = lambda w: _table_run(mode, xh, sc, c, w, n_up, n1, N, params,
                               gamma)
    wrapper = _table_wrapper(mode)
    ref = run(wav)
    t0 = sum(getattr(wrapper, a) for a in dir(wrapper)
             if a.startswith('table_'))
    got = run(twin)
    torch.cuda.synchronize()
    assert sum(getattr(wrapper, a) for a in dir(wrapper)
               if a.startswith('table_')) == t0 + 1
    tol = 2e-5 if dtype == 'float32' else 1e-9
    assert _rel_err(got[0], ref[0]) <= tol
    if mode == 'wx_dwx':
        assert _rel_err(got[1], ref[1]) <= tol
    elif mode == 'w2':
        _w2_close(got[1], ref[1], dtype)
    else:
        assert (got[1] != ref[1]).double().mean() <= 0.01


def test_public_wavelet_routes_on_card(dev, monkeypatch):
    """The public calls with each wavelet route as the JAX package's gates
    say: analytic real wavelets through the table modes, morlet and a
    user's callable in `cwt`/`ssq_cwt` through `cwt_general` (no CWT
    kernel) and B4, order > 0 through B3 (closed form for order 0, table
    for order 1) and B4; no plain version runs; each against the same
    call on the CPU."""
    from ssqueezepy_tpu_torch.models import cwt as cwt_mod
    N = 6000
    x = np.random.default_rng(40).standard_normal(N).astype(np.float32)
    xb = np.stack([x, x[::-1].copy()])
    boom = lambda *a, **k: (_ for _ in ()).throw(AssertionError('plain'))
    watch = {}
    for w in (cwt_bins, cwt_fused, cwt_bins2, cwt_cuda.cwt_w2):
        for a in dir(w):
            if a.endswith('launches'):
                watch['%s.%s' % (w.__name__, a)] = (w, a)
    for w in (scatter_kv, ssq_fused, shift_scatter):
        watch['%s.launches' % w.__name__] = (w, 'launches')
    watch['cwt_general'] = (cwt_mod.cwt_general, 'calls')
    calls = [
        ('ssq_cwt cmhat', lambda **d: stq.ssq_cwt(x, 'cmhat', **d),
         {'cwt_bins.table_launches', 'scatter_kv.launches'}),
        ('ssq_cwt gmw1', lambda **d: stq.ssq_cwt(
            x, ('gmw', {'order': 1}), **d),
         {'cwt_bins.table_launches', 'scatter_kv.launches'}),
        ('ssq_cwt morlet', lambda **d: stq.ssq_cwt(x, 'morlet', **d),
         {'cwt_general', 'ssq_fused.launches'}),
        ('ssq_cwt order (0, 1)', lambda **d: stq.ssq_cwt(
            x, order=(0, 1), **d),
         {'cwt_fused.launches', 'cwt_fused.table_launches',
          'ssq_fused.launches'}),
        ('cwt hhhat', lambda **d: stq.cwt(x, 'hhhat', **d),
         {'cwt_fused.table_launches'}),
        ('ssq_cwt bump batch', lambda **d: stq.ssq_cwt(xb, 'bump', **d),
         {'cwt_bins.table_batched_launches', 'scatter_kv.launches'}),
        ('ssq_cwt2 morlet', lambda **d: stq.ssq_cwt2(x, 'morlet', **d),
         {'cwt_bins2.table_launches', 'scatter_kv.launches'}),
        ('ssq_cwt2 cmhat get_w', lambda **d: stq.ssq_cwt2(
            x, 'cmhat', get_w=True, **d),
         {'cwt_w2.table_launches', 'shift_scatter.launches'}),
        ('cwt custom', lambda **d: stq.cwt(x, _gauss_bump, **d),
         {'cwt_general'})]
    for name, fn, need in calls:
        fn()
        with monkeypatch.context() as m:
            for p in ('cwt_bins_plain', 'cwt_fused_plain', 'cwt_bins2_plain',
                      'wsst2_rows'):
                m.setattr(cwt_cuda, p, boom)
            m.setattr(cwt_mod, 'cwt_core', boom)
            c0 = {k: getattr(w, a) for k, (w, a) in watch.items()}
            out = fn()
            torch.cuda.synchronize()
        moved = {k for k, (w, a) in watch.items() if getattr(w, a) != c0[k]}
        assert moved == need, (name, moved)
        ref = fn(device='cpu')
        assert _rel_err(out[0].cpu() if name.startswith('cwt') else
                        out[1].cpu(), ref[0] if name.startswith('cwt') else
                        ref[1]) <= 2e-5, name
        if not name.startswith('cwt'):
            (_bins2_criterion if 'cwt2' in name else _bins_criterion)(
                out[0].cpu(), ref[0])


# ---- autograd: each kernel's torch.autograd.Function on the card -----------
def _grad_cases(dev):
    """name -> (Function, (wrapper, counter), run(*floats), plain(*floats),
    floats): a kernel wrapper and its plain version as functions of their
    differentiable inputs, float32 on the card (N = 4000)."""
    N = 4000
    xh, sc, c, wav, n_up, n1, params, gamma = _inputs(N, 'float32', 'log',
                                                      dev)
    cw = (wav, n_up, n1, N, 1.)
    sxh, H, Hd, bins, c6 = _stft_inputs(N, 97, 'float32', dev)
    bank = conv_bank(fsst2_plan(None, None, 97, 97, 1., 'float32').bank, 97,
                     sxh.shape[0], True, 'float32', dev)
    rng = np.random.default_rng(41)
    na = len(sc)
    Wx, dWx = (torch.as_tensor(rng.standard_normal((na, N))
                               + 1j * rng.standard_normal((na, N)),
                               dtype=torch.complex64, device=dev)
               for _ in range(2))
    k = torch.as_tensor(rng.integers(-na, 2 * na, (na, N)).astype(np.int32),
                        device=dev)
    valid = torch.as_tensor(rng.random((na, N)) > .2, device=dev)
    Sfs = bins['Sfs']
    return {
        'cwt_bins': (cwt_cuda.CwtBinsGrad, (cwt_bins, 'launches'),
                     lambda xh, sc: cwt_bins(xh, sc, *cw, True, params,
                                             gamma, True),
                     lambda xh, sc: cwt_bins_plain(xh, sc, *cw, True, params,
                                                   gamma, True), (xh, sc)),
        'cwt_fused': (cwt_cuda.CwtFusedGrad, (cwt_fused, 'launches'),
                      lambda xh, sc: cwt_fused(xh, sc, *cw, True, True),
                      lambda xh, sc: cwt_fused_plain(xh, sc, *cw, True,
                                                     True), (xh, sc)),
        'cwt_bins2': (cwt_cuda.CwtBins2Grad, (cwt_bins2, 'launches'),
                      lambda xh, sc: cwt_bins2(xh, sc, *cw, params, gamma,
                                               True),
                      lambda xh, sc: cwt_bins2_plain(xh, sc, *cw, params,
                                                     gamma, True), (xh, sc)),
        'cwt_w2': (cwt_cuda.CwtW2Grad, (cwt_cuda.cwt_w2, 'launches'),
                   lambda xh: cwt_cuda.cwt_w2(xh, sc, *cw, gamma),
                   lambda xh: cwt_cuda.wsst2_rows(xh, sc, *cw, gamma),
                   (xh,)),
        'scatter_kv': (ssq_cuda.ScatterKvGrad, (scatter_kv, 'launches'),
                       lambda W, c: (scatter_kv(W, k, c, na),),
                       lambda W, c: (scatter_kv_plain(W, k, c, na),),
                       (Wx, c)),
        'ssq_fused': (ssq_cuda.SsqFusedGrad, (ssq_fused, 'launches'),
                      lambda W, dW, c: (ssq_fused(W, dW, c, params, gamma,
                                                  True),),
                      lambda W, dW, c: (ssq_fused_plain(W, dW, c, params,
                                                        gamma, True),),
                      (Wx, dWx, c)),
        'shift_scatter': (ssq_cuda.ShiftScatterGrad,
                          (shift_scatter, 'launches'),
                          lambda v, c: (shift_scatter(v, k, valid, na, c),),
                          lambda v, c: (shift_scatter_plain(v, k, valid, na,
                                                            c),), (Wx, c)),
        'stft_conv': (stft_cuda.StftConvGrad, (stft_conv, 'launches'),
                      lambda xh: stft_conv(xh, H, Hd, N, 1., bins),
                      lambda xh: stft_conv_plain(xh, H, Hd, N, 1., bins),
                      (sxh,)),
        'fsst2_conv': (stft_cuda.Fsst2ConvGrad, (fsst2_conv, 'launches'),
                       lambda xh: fsst2_conv(xh, bank, N, 1., bins),
                       lambda xh: fsst2_conv_plain(xh, bank, N, 1., bins),
                       (sxh,)),
        'fsst2_w': (stft_cuda.Fsst2WGrad, (stft_cuda.fsst2_w, 'launches'),
                    lambda xh: stft_cuda.fsst2_w(xh, bank, N, 1., Sfs,
                                                 gamma),
                    lambda xh: stft_cuda.fsst2_rows(xh, bank, N, 1., Sfs,
                                                    gamma), (sxh,)),
    }


GRAD_CASES = ['cwt_bins', 'cwt_fused', 'cwt_bins2', 'cwt_w2', 'scatter_kv',
              'ssq_fused', 'shift_scatter', 'stft_conv', 'fsst2_conv',
              'fsst2_w']


@pytest.mark.parametrize('name', GRAD_CASES)
def test_function_grad_on_card(dev, name):
    """Each Function on the card: its forward is the kernel's launch
    (counted once, outputs bit-identical to the launch without grad), its
    backward launches nothing and equals the gradient through the plain
    version (autograd through torch ops on the card) of a random linear
    functional of the floating outputs (zero on w2's inf cells), within
    1e-5 of max."""
    Fn, (wrapper, counter), run, plain, floats = _grad_cases(dev)[name]
    ref = run(*floats)
    assert all(o is None or o.grad_fn is None for o in ref)
    ins = [t.clone().requires_grad_() for t in floats]
    setattr(wrapper, counter, 0)
    outs = run(*ins)
    torch.cuda.synchronize()
    assert getattr(wrapper, counter) == 1
    assert isinstance(outs[0].grad_fn, Fn._backward_cls)
    for o, r in zip(outs, ref):
        assert (o is None and r is None) or torch.equal(o.detach(), r)
    gen = torch.Generator(device=dev).manual_seed(0)
    floating = [o for o in outs if o is not None
                and (o.is_complex() or o.is_floating_point())]
    vs = [torch.where(torch.isfinite(o), torch.randn(
        o.shape, dtype=o.dtype, device=dev, generator=gen), 0).detach()
        for o in floating]
    g_k = torch.autograd.grad(floating, ins, vs, allow_unused=True)
    torch.cuda.synchronize()
    assert getattr(wrapper, counter) == 1
    ins_p = [t.clone().requires_grad_() for t in floats]
    outs_p = [o for o in plain(*ins_p) if o is not None
              and (o.is_complex() or o.is_floating_point())]
    g_p = torch.autograd.grad(outs_p, ins_p, vs, allow_unused=True)
    for a, b in zip(g_k, g_p):
        if b is None or not b.abs().max():
            assert a is None or not a.abs().max()
        else:
            assert _rel_err(a, b) <= 1e-5, _rel_err(a, b)


# ---- the general routes at a length with a prime factor above 7 --------
def _route_counts():
    from ssqueezepy_tpu_torch.models.cwt import cwt_general
    from ssqueezepy_tpu_torch.models.ssq_cwt2 import wsst2_general
    return dict(general=cwt_general.calls, wsst2=wsst2_general.calls,
                b4=ssq_fused.launches, b5=shift_scatter.launches,
                b2=scatter_kv.launches, cwt=sum(_mixed_counts()),
                w2=cwt_cuda.cwt_w2.launches
                + cwt_cuda.cwt_w2.mixed_launches)


@pytest.mark.parametrize('name,fn,want', [
    ('ssq_cwt', lambda x, **d: stq.ssq_cwt(x, padtype=None, **d),
     dict(general=1, b4=1)),
    ('ssq_cwt get_w', lambda x, **d: stq.ssq_cwt(x, padtype=None,
                                                 get_w=True, **d),
     dict(general=1, b5=1)),
    ('ssq_cwt get_dWx', lambda x, **d: stq.ssq_cwt(x, padtype=None,
                                                   get_dWx=True, **d),
     dict(general=1, b4=1)),
    ('ssq_cwt batch', lambda x, **d: stq.ssq_cwt(np.stack([x, x[::-1]]),
                                                 padtype=None, **d),
     dict(general=1, b4=1)),
    ('cwt', lambda x, **d: stq.cwt(x, padtype=None, **d), dict(general=1)),
    ('ssq_cwt2', lambda x, **d: stq.ssq_cwt2(x, padtype=None, **d),
     dict(wsst2=1, b5=1)),
    ('ssq_cwt2 get_w', lambda x, **d: stq.ssq_cwt2(x, padtype=None,
                                                   get_w=True, **d),
     dict(wsst2=1, b5=1))])
def test_general_route_counters(dev, name, fn, want):
    """At N = 2002 = 2 7 11 13 unpadded, each public call runs its general
    route (`cwt_general`, or `wsst2_general` for order 2) and then exactly
    B4 or B5: no CWT kernel, no B2; Wx within 1e-5 of max of the same call
    on the CPU and Tx by the bins criterion."""
    x = np.random.default_rng(2002).standard_normal(2002).astype(
        np.float32)
    c0 = _route_counts()
    out = fn(x)
    torch.cuda.synchronize()
    dc = {k: v - c0[k] for k, v in _route_counts().items()}
    assert dc == dict(dict.fromkeys(c0, 0), **want), dc
    cpu = fn(x, device='cpu')
    if name == 'cwt':
        assert _rel_err(out[0].cpu(), cpu[0]) <= 1e-5
        return
    assert _rel_err(out[1].cpu(), cpu[1]) <= 1e-5
    _bins_criterion(out[0].cpu(), cpu[0])


# ---- the ridge dynamic program -----------------------------------------
def _ridge_inputs(B, T, F, dtype, seed, dev):
    """-log-normalized energy of noise with two planted wandering ridges,
    time-major (B, T, F), and log-scale row coordinates."""
    rng = np.random.default_rng(seed)
    E = rng.random((B, F, T)) * 0.05
    t = np.arange(T)
    for b in range(B):
        for amp, c, w, p in ((1., .3, .2, 300.), (.6, .7, .1, 500.)):
            r = (F * (c + w * np.sin(2 * np.pi * t / p + b))).astype(int)
            E[b, np.clip(r, 0, F - 1), t] += amp
    e = -np.log(E / E.max(axis=1, keepdims=True) + np.finfo(dtype).eps)
    e = torch.as_tensor(np.ascontiguousarray(
        e.astype(dtype).transpose(0, 2, 1)), device=dev)
    v = torch.as_tensor(np.log(np.geomspace(1., 300., F)).astype(dtype),
                        device=dev)
    return e, v


def _ridge_vs_plain(e, v, eps, plan=None, pen=2.):
    """Both ridge kernels, one launch each (on the counters of the plan's
    mode, and the tiled trace's prologue on its own), against their plain
    versions: pe bit-identical (NaN cells NaN on both sides), the indices
    equal."""
    from ssqueezepy_tpu_torch.ops.ridge_cuda import (
        ridge_forward, ridge_forward_plain, ridge_plan, ridge_trace,
        ridge_trace_plain)
    B, _, F = e.shape
    mode = (plan or ridge_plan(F, e.element_size(), batch=B)).tiled
    attr = 'tiled_launches' if mode else 'launches'
    f0, t0 = getattr(ridge_forward, attr), getattr(ridge_trace, attr)
    p0 = ridge_trace.prologue_launches
    pe = ridge_forward(e, v, pen, plan=plan)
    r = ridge_trace(pe, e, v, pen, eps, plan=plan)
    torch.cuda.synchronize()
    assert (getattr(ridge_forward, attr) - f0,
            getattr(ridge_trace, attr) - t0,
            ridge_trace.prologue_launches - p0) == (1, 1, int(mode))
    pe_p = ridge_forward_plain(e, v, pen)
    nan = pe_p.isnan()
    assert torch.equal(pe.isnan(), nan)
    assert torch.equal(pe[~nan], pe_p[~nan])
    assert torch.equal(r, ridge_trace_plain(pe_p, e, v, pen, eps))
    assert r.dtype == torch.int64 and r.shape == e.shape[:2]
    return pe, r


@pytest.mark.parametrize('B,T,F', [(1, 2000, 293), (3, 700, 40),
                                   (2, 64, 1100), (1, 1, 5), (2, 300, 9),
                                   (20, 150, 40), (3, 1, 40), (2, 2, 293),
                                   (1, 24, 5632), (1, 24, 11264)])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_ridge_kernels_vs_plain(dev, B, T, F, dtype):
    """`ridge_forward` and `ridge_trace` against their plain versions on
    the card: pe bit-identical, the indices equal; one launch each for the
    batch. F = 5 runs fewer rows than the cluster's 8 CTAs, F = 9 one more
    (spare CTAs); B = 20 runs 160 CTAs, more than fit at once (cluster
    waves); T = 1 and 2; F = 1100 recomputes P (F = 5632 in float64 and
    11264 in float32, the resident plan's edge, also with one slot of e in
    the trace); F = 11264 in float64 is past the resident plan and runs
    the row-tiled mode."""
    from ssqueezepy_tpu_torch.ops.ridge_cuda import ridge_plan
    e, v = _ridge_inputs(B, T, F, dtype, B + T, dev)
    plan = ridge_plan(F, e.element_size(), batch=B)
    assert plan.tiled == (F * e.element_size() > 11264 * 4)
    if not plan.tiled:
        assert plan.clusters == min(8, F)
        assert plan.resident == (F <= 293)
    _ridge_vs_plain(e, v, float(np.finfo(dtype).eps))


@pytest.mark.parametrize('B,T,F,dtype', [
    (1, 24, 11265, 'float32'), (1, 24, 16385, 'float32'),
    (2, 12, 16385, 'float32'), (1, 24, 5633, 'float64'),
    (1, 24, 8193, 'float64'), (3, 40, 1100, 'float64'),
    (2, 1, 5633, 'float64'), (1, 2, 11265, 'float32'), (2, 30, 7, 'float32')])
def test_ridge_tiled_vs_plain(dev, B, T, F, dtype):
    """The row-tiled mode past the resident plan (F = 11265 and 16385 in
    float32, 5633 and 8193 in float64; F = 1100 and 7 forced tiled over a
    batch; T = 1 and 2) against the plain versions: pe bit-identical, the
    indices equal, one launch each on the tiled counters."""
    from ssqueezepy_tpu_torch.ops.ridge_cuda import ridge_plan
    e, v = _ridge_inputs(B, T, F, dtype, B + T + F, dev)
    plan = ridge_plan(F, e.element_size(), tiled=True, batch=B)
    assert plan.tiled and plan.tiles * 64 >= F
    _ridge_vs_plain(e, v, float(np.finfo(dtype).eps), plan=plan)


@pytest.mark.parametrize('case', ['pen0', 'pen-inf', 'pen-neg', 'nan-v',
                                  'inf-e', 'zero-ties', 'dup-v',
                                  'subnormal-v', 'const-pen0', 'eps0'])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_ridge_tiled_edges(dev, case, dtype):
    """The tiled kernels' skips at their edges against the plain
    versions (pe bit-identical, indices equal) at F = 2100: pen 0, inf
    and negative, NaN in v, +-inf in e, +-0 ties, duplicate and unsorted
    v, a subnormal v spacing, a constant e with pen 0, eps 0."""
    from ssqueezepy_tpu_torch.ops.ridge_cuda import ridge_plan
    B, T, F = 2, 40, 2100
    e, v = _ridge_inputs(B, T, F, dtype, 9, dev)
    pen = {'pen0': 0., 'pen-inf': float('inf'), 'pen-neg': -1.,
           'const-pen0': 0.}.get(case, 2.)
    eps = 0. if case == 'eps0' else float(np.finfo(dtype).eps)
    if case == 'nan-v':
        v[700] = float('nan')
    if case == 'inf-e':
        e[0, 3, 40:90] = float('inf')
        e[1, 5, 200] = -float('inf')
        e[0, 9:, 250] = float('inf')
    if case == 'zero-ties':
        e[:, ::3] = 0.
        e[:, 1::6, ::2] = -0.
    if case == 'dup-v':
        g = torch.Generator(device=dev).manual_seed(3)
        v = (v * 10).round()[torch.randperm(F, generator=g, device=dev)] / 10
    if case == 'subnormal-v':
        v = torch.arange(F, dtype=e.dtype, device=dev) * \
            float(np.finfo(dtype).smallest_subnormal) * 3
    if case == 'const-pen0':
        e[:] = 1.5
    plan = ridge_plan(F, e.element_size(), tiled=True, batch=B)
    _ridge_vs_plain(e, v.contiguous(), eps, plan=plan, pen=pen)


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_ridge_trace_records_vs_plain(dev, dtype):
    """The tiled trace's prologue against its plain version: each step's
    tile minima, pe - e and v at the first argmin and its index, with NaN
    cells (the first NaN is the argmin), and the tiles' v ranges."""
    from ssqueezepy_tpu_torch.ops.ridge_cuda import (
        _trace_records, _trace_records_plain, ridge_forward_plain,
        ridge_plan, ridge_trace)
    e, v = _ridge_inputs(2, 50, 3000, dtype, 4, dev)
    e[1, 20:23, 7] = float('nan')
    pe = ridge_forward_plain(e, v, 2.)
    plan = ridge_plan(3000, e.element_size(), tiled=True, batch=2)
    p0 = ridge_trace.prologue_launches
    rec, vr = _trace_records(pe, e, v, plan)
    rec_p, vr_p = _trace_records_plain(pe, e, v, plan)
    torch.cuda.synchronize()
    assert ridge_trace.prologue_launches - p0 == 1
    n = plan.trace_tiles + 3
    a, b = rec[..., :n], rec_p[..., :n]
    nan = b.isnan()
    assert torch.equal(a.isnan(), nan) and torch.equal(a[~nan], b[~nan])
    assert torch.equal(vr, vr_p)


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_ridge_tiled_vs_resident(dev, dtype):
    """At F = 293 the tiled mode forced against the resident mode: pe
    bit-identical, the indices equal, with NaN cells and exact ties (a
    NaN of e spreads through every later column of pe; constant columns
    tie every f)."""
    from ssqueezepy_tpu_torch.ops.ridge_cuda import (ridge_forward,
                                                     ridge_plan, ridge_trace)
    e, v = _ridge_inputs(3, 400, 293, dtype, 11, dev)
    e[:, ::9] = 1.
    e[1, 350, 17] = float('nan')
    e[2, 399, ::5] = float('nan')
    eps = float(np.finfo(dtype).eps)
    pe, r = _ridge_vs_plain(e, v, eps, plan=ridge_plan(
        293, e.element_size(), tiled=True, batch=3))
    pe_r = ridge_forward(e, v, 2.)
    nan = pe_r.isnan()
    assert torch.equal(pe.isnan(), nan) and pe[1, 351:].isnan().all()
    assert torch.equal(pe[~nan], pe_r[~nan])
    assert torch.equal(r, ridge_trace(pe_r, e, v, 2., eps))


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
@pytest.mark.parametrize('clusters', [2, 16])
def test_ridge_kernels_nan_ties(dev, dtype, clusters):
    """NaN cells and exact ties on the card: a NaN of e spreads through
    every later column of pe (torch's NaN rule), the trace's argmin takes
    the first NaN and, where nothing qualifies, the first least pe;
    constant columns tie every f. At the default cluster and at 2 and 16
    CTAs (the non-portable size)."""
    from ssqueezepy_tpu_torch.ops.ridge_cuda import ridge_plan
    e, v = _ridge_inputs(3, 400, 293, dtype, 7, dev)
    e[:, ::9] = 1.                       # constant columns: exact ties
    e[1, 350, 17] = float('nan')         # NaN from column 350 of row 1
    e[2, 399, ::5] = float('nan')        # NaN in the last column only
    eps = float(np.finfo(dtype).eps)
    pe, r = _ridge_vs_plain(e, v, eps)
    assert pe[1, 351:].isnan().all() and not pe[0].isnan().any()
    _ridge_vs_plain(e, v, eps, plan=ridge_plan(293, e.element_size(),
                                               clusters=clusters))


def _ridge_states(Tf, ridges, bw, device):
    """The DP's input (B, T, F) before each ridge, on `device`, its kill
    of +-bw rows replayed from `ridges` (B, T, n); returned on the CPU."""
    from ssqueezepy_tpu_torch.models.ridge_extraction import _normalized
    a = torch.as_tensor(Tf, device=device).abs()
    E = a * a
    rows = torch.arange(E.shape[1], device=device)[:, None]
    out = []
    for i in range(ridges.shape[-1]):
        out.append(_normalized(E, float(np.finfo(np.float32).eps),
                               torch.float32).cpu())
        r = torch.as_tensor(ridges[..., i], device=device)
        E = E.masked_fill((rows >= r[:, None, :] - bw) &
                          (rows < r[:, None, :] + bw), 0)
    return out


def _hold_ridges_across(Tf, scales, r_card, r_cpu, dev, bw=15):
    """Each ridge that differs between the card and the CPU: after the
    same earlier ridges its inputs differ by rounding only (16 eps), and
    the DP's total penalized energy (min_f pe[T-1, f], plain version)
    on each side's input agrees within 1e-6 relative."""
    from ssqueezepy_tpu_torch.ops.ridge_cuda import ridge_forward_plain
    eps = float(np.finfo(np.float32).eps)
    s_card = _ridge_states(Tf, r_card, bw, dev)
    s_cpu = _ridge_states(Tf, r_cpu, bw, 'cpu')
    v = torch.as_tensor(np.log(scales.astype(np.float32)))
    for i in range(r_card.shape[-1]):
        for b in range(r_card.shape[0]):
            if np.array_equal(r_card[b, :, i], r_cpu[b, :, i]):
                continue
            if np.array_equal(r_card[b, :, :i], r_cpu[b, :, :i]):
                d = (s_card[i][b].double() - s_cpu[i][b].double()).abs()
                assert 0 < float(d.max()) <= 16 * eps
            pa, pc = (float(ridge_forward_plain(s[i][b:b + 1], v, 2.)
                            [0, -1].min()) for s in (s_card, s_cpu))
            assert abs(pa - pc) <= 1e-6 * abs(pc)


def test_extract_ridges_on_card(dev, monkeypatch):
    """`extract_ridges` on the card: 2 forward + 2 trace launches for two
    ridges of a (2, na, T) batch, the same indices, ridge_f and ridge_e as
    the same call with the plain versions in the kernels' place (the same
    torch energy on the card); against the same call on the CPU by the
    rule of the CPU tests against the JAX package
    (`tests/test_torch_analysis.py::_hold_ridges`): where a ridge differs
    after the same earlier ridges, the two -log-normalized inputs differ
    by rounding only (within 16 eps), and the DP's total penalized energy
    on each side's input agrees within 1e-6 relative. The count of cells
    that differ is printed."""
    from ssqueezepy_tpu_torch.models import ridge_extraction
    from ssqueezepy_tpu_torch.ops.ridge_cuda import (
        ridge_forward, ridge_forward_plain, ridge_trace, ridge_trace_plain)
    rng = np.random.default_rng(5)
    na, T = 60, 900
    Tf = (rng.standard_normal((2, na, T))
          + 1j * rng.standard_normal((2, na, T))) * .1
    t = np.arange(T)
    Tf[:, (20 + 10 * np.sin(t / 50)).astype(int), t] += 3
    Tf[:, (45 + 5 * np.cos(t / 70)).astype(int), t] += 2
    Tf = Tf.astype(np.complex64)
    scales = np.geomspace(1, 64, na)
    f0, t0 = ridge_forward.launches, ridge_trace.launches
    out = stq.extract_ridges(Tf, scales, n_ridges=2, get_params=True)
    assert (ridge_forward.launches - f0, ridge_trace.launches - t0) == (2, 2)
    cpu = stq.extract_ridges(Tf, scales, n_ridges=2, device='cpu')
    print("extract_ridges card vs CPU: %d of %d cells differ"
          % (int((out[0] != cpu).sum()), cpu.size))
    if not np.array_equal(out[0], cpu):
        _hold_ridges_across(Tf, scales, out[0], cpu, dev)
    monkeypatch.setattr(ridge_extraction, 'ridge_forward',
                        ridge_forward_plain)
    monkeypatch.setattr(ridge_extraction, 'ridge_trace', ridge_trace_plain)
    ref = stq.extract_ridges(Tf, scales, n_ridges=2, get_params=True)
    assert (ridge_forward.launches - f0, ridge_trace.launches - t0) == (2, 2)
    for a, b in zip(out, ref):
        assert np.array_equal(a, b)


# ---- stage-1 support pruning of the CWT kernel ----------------------------

_PRUNE_MODES = ('bins', 'wx', 'wx_dwx_l2', 'order2', 'w2')


def _prune_run(mode, xh, sc, wav, n_up, n1, N, params, gamma, klims=None):
    """The CWT kernel in `mode` through `cwt_cuda._launch`: stage 1 pruned
    by the support plan, or by `klims` (the private hook; `stage1_rows`
    in every row runs it unpruned)."""
    c = cwt_cuda
    if mode == 'bins':
        return c._launch(c.cwt_bins, c._OUT_BINS, xh, sc, wav, n_up, n1, N,
                         1., True, params, gamma, True, klims=klims)
    if mode == 'wx':
        return c._launch(c.cwt_fused, c._OUT_W, xh, sc, wav, n_up, n1, N,
                         1., True, klims=klims)
    if mode == 'wx_dwx_l2':
        return c._launch(c.cwt_fused, c._OUT_W_DW, xh, sc, wav, n_up, n1, N,
                         1., False, klims=klims)
    if mode == 'order2':
        return c._launch(c.cwt_bins2, c._OUT_BINS2, xh, sc, wav, n_up, n1, N,
                         1., True, params, gamma, True, klims=klims)
    return c._launch(c.cwt_w2, c._OUT_W2, xh, sc, wav, n_up, n1, N, 1., True,
                     gamma=gamma, klims=klims)


def _full_klims(sc, n_up):
    return torch.full(sc.shape, cwt_cuda.stage1_rows(n_up),
                      dtype=torch.int32, device=sc.device)


def _same_but_zero_signs(a, b):
    """`a` and `b` equal bit for bit but for the sign of zero cells (or
    both NaN); returns the count of cells whose zero signs differ."""
    if a is None:
        assert b is None
        return 0
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    if not a.is_floating_point():
        assert torch.equal(a, b)
        return 0
    ib = torch.int32 if a.element_size() == 4 else torch.int64
    differ = a.view(ib) != b.view(ib)
    assert bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    assert bool((a[differ] == 0).all())
    return int(differ.sum())


@pytest.mark.parametrize('mode', _PRUNE_MODES)
@pytest.mark.parametrize('engine', ['radix-4', 'mixed'])
@pytest.mark.parametrize('source', ['gmw', 'table'])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_pruned_stage1_equals_unpruned(dev, mode, engine, source, dtype):
    """Every mode of the CWT kernel with stage 1 pruned by the support plan
    equals the same launch unpruned through the private hook (`klims` of
    rows0 in every row), bit for bit but for signed zeros (counted and
    printed), on both engines (n_up = 16384, and 4725 unpadded), from the
    closed-form GMW and from a table (an order-1 GMW), one C call each
    on the mode's counter; the public wrapper's launch is the pruned one;
    the plan prunes some rows and keeps others whole."""
    N, padtype = (10000, 'reflect') if engine == 'radix-4' else (4725, None)
    xh, sc, c, wav, n_up, n1, params, gamma = _inputs(
        N, dtype, 'log-piecewise', dev, padtype=padtype)
    if source == 'table':
        wav = resolve_wavelet(('gmw', {'order': 1, 'dtype': dtype}), N=N)
    planes = {'bins': 2, 'wx': 1, 'wx_dwx_l2': 2}.get(mode, 5)
    table = (cwt_cuda.wavelet_table(wav, sc, n_up, order2=planes == 5,
                                    memo=True) if source == 'table' else None)
    klims = cwt_cuda._stage1_klims(wav, sc, n_up, planes == 5, table)
    rows0 = cwt_cuda.stage1_rows(n_up)
    assert int(klims.min()) < rows0 and int(klims.max()) == rows0
    wrapper = {'bins': cwt_bins, 'wx': cwt_fused, 'wx_dwx_l2': cwt_fused,
               'order2': cwt_bins2, 'w2': cwt_cuda.cwt_w2}[mode]
    name = (('table_' if source == 'table' else '')
            + ('mixed_' if engine == 'mixed' else '') + 'launches')
    before = getattr(wrapper, name)
    pruned = _prune_run(mode, xh, sc, wav, n_up, n1, N, params, gamma)
    full = _prune_run(mode, xh, sc, wav, n_up, n1, N, params, gamma,
                      _full_klims(sc, n_up))
    torch.cuda.synchronize()
    assert getattr(wrapper, name) - before == 2
    signs = sum(_same_but_zero_signs(a, b) for a, b in zip(pruned, full))
    print("pruned %s %s %s %s: %d cells differ in the sign of a zero"
          % (mode, engine, source, dtype, signs))
    public = {
        'bins': lambda: cwt_bins(xh, sc, wav, n_up, n1, N, 1., True, params,
                                 gamma, True),
        'wx': lambda: cwt_fused(xh, sc, wav, n_up, n1, N, 1., False, True),
        'wx_dwx_l2': lambda: cwt_fused(xh, sc, wav, n_up, n1, N, 1., True,
                                       False),
        'order2': lambda: cwt_bins2(xh, sc, wav, n_up, n1, N, 1., params,
                                    gamma, True),
        'w2': lambda: cwt_cuda.cwt_w2(xh, sc, wav, n_up, n1, N, 1., gamma)
    }[mode]()
    for a, b in zip(public, pruned):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize('mode', _PRUNE_MODES)
@pytest.mark.parametrize('engine', ['radix-4', 'mixed'])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_pruned_batch_rows_equal_one_signal(dev, mode, engine, dtype,
                                            monkeypatch):
    """Over a batch of three spectra (B3b, B3, B8 and its w2 mode), in
    row chunks that cross signals, each pruned row equals its signal
    launched alone and the batch launched unpruned: every row g takes
    its scale's limit g % na."""
    N, padtype = (4000, 'reflect') if engine == 'radix-4' else (3000, None)
    xh, sc, c, wav, n_up, n1, params, gamma = _inputs(
        N, dtype, 'log-piecewise', dev, padtype=padtype)
    xb = torch.stack([xh] + [_inputs(N, dtype, 'log-piecewise', dev,
                                     padtype=padtype, seed=s)[0]
                             for s in (1, 2)])
    planes = {'bins': 2, 'wx': 1, 'wx_dwx_l2': 2}.get(mode, 5)
    # chunks of na + 3 rows: every chunk but the first starts mid-signal
    monkeypatch.setattr(cwt_cuda, '_SCRATCH_BUDGET',
                        (len(sc) + 3) * planes * n_up * xh.element_size())
    out = _prune_run(mode, xb, sc, wav, n_up, n1, N, params, gamma)
    full = _prune_run(mode, xb, sc, wav, n_up, n1, N, params, gamma,
                      _full_klims(sc, n_up))
    for a, b in zip(out, full):
        _same_but_zero_signs(a, b)
    for i in range(3):
        one = _prune_run(mode, xb[i].contiguous(), sc, wav, n_up, n1, N,
                         params, gamma)
        for a, b in zip(out, one):
            assert (a is None and b is None) or torch.equal(a[i], b)


def test_malformed_klims_raise_before_launch(dev):
    """The private hook takes only an (na,) int32 tensor on the card."""
    xh, sc, c, wav, n_up, n1, params, gamma = _inputs(
        2000, 'float32', 'log-piecewise', dev)
    n0 = cwt_fused.launches
    for bad in (_full_klims(sc, n_up)[1:], _full_klims(sc, n_up).long(),
                _full_klims(sc, n_up).cpu()):
        with pytest.raises(ValueError, match='klims'):
            _prune_run('wx', xh, sc, wav, n_up, n1, 2000, params, gamma, bad)
    assert cwt_fused.launches == n0
