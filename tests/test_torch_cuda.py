# -*- coding: utf-8 -*-
"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device: it is marked `cuda` and skips
(from inside its fixture) where there is none. This file imports no JAX,
so it runs on a machine with only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Tolerances: Wx within 2e-5 of max|Wx| in float32 (radix-2 DFT in the
kernel vs cuFFT in the plain version) and 1e-9 relative in float64; bins
may differ on at most 1% of cells in float32 (w rounding at bin
boundaries), Tx then by the bins criterion; the scatter within 1e-5 of
max|Tx| (summation order) and bit-identical from run to run.
"""
import numpy as np
import pytest
import torch

import ssqueezepy_tpu_torch as stq
from ssqueezepy_tpu_torch.models.cwt import resolve_wavelet
from ssqueezepy_tpu_torch.models.ssq_cwt import _ssq_cwt_plan
from ssqueezepy_tpu_torch.ops import cwt_cuda
from ssqueezepy_tpu_torch.ops.cwt_cuda import cwt_bins, cwt_bins_plain
from ssqueezepy_tpu_torch.ops.fft import rfft
from ssqueezepy_tpu_torch.ops.pad import pad_params, padsignal
from ssqueezepy_tpu_torch.ops.ssq_cuda import scatter_kv, scatter_kv_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device('cuda')


def _inputs(N, dtype, scales, dev, padtype='reflect', seed=0):
    spec = ('gmw', {'dtype': dtype})
    wav = resolve_wavelet(spec, N=N)
    plan, _ = _ssq_cwt_plan(wav, N, scales, 16, None, 'peak', True, 1.)
    scales_np, const, params = plan.scales, plan.const, plan.params
    n_up, n1, _ = pad_params(N, padtype)
    tdt = getattr(torch, dtype)
    x = torch.as_tensor(np.random.default_rng(seed).standard_normal(N),
                        dtype=tdt, device=dev)
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
