# -*- coding: utf-8 -*-
"""The plain PyTorch versions of the port's two CUDA kernels against the
JAX package's Pallas kernels, run in interpret mode on the CPU:

  * B1 `cwt_bins_plain` vs `cwt_fused_bins_direct` (fused CWT + phase +
    bin map), sliced [:na, off:off+N] from the TPU's padded layout;
  * B2 `scatter_kv_plain` vs `scatter_kv_direct` on the same planes.

The wrappers `cwt_bins`/`scatter_kv` take the plain path because the
tensors lie on the CPU; the kernels themselves are held against these
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ssqueezepy_tpu.ops.complexlib import Complex
from ssqueezepy_tpu.ops.fft import fft as jfft
from ssqueezepy_tpu.ops.pad import padsignal as jpadsignal
from ssqueezepy_tpu.ops.cwt_pallas import cwt_fused_bins_direct
from ssqueezepy_tpu.ops.ssq_pallas import scatter_kv_direct
from ssqueezepy_tpu.models.wavelets import Wavelet as JWavelet

from ssqueezepy_tpu_torch.convert import plan_from_numpy
from ssqueezepy_tpu_torch.models.cwt import resolve_wavelet
from ssqueezepy_tpu_torch.ops.cwt_cuda import cwt_bins, four_step
from ssqueezepy_tpu_torch.ops.pad import pad_params
from ssqueezepy_tpu_torch.ops.ssq_cuda import scatter_kv
from ssqueezepy_tpu_torch.utils.cwt_utils import process_scales

N = 512
SPEC = ('gmw', {'dtype': 'float32'})


def _jax_b1(seed=0):
    """Shared plan + the JAX B1 outputs on white noise (float32)."""
    wj = JWavelet(SPEC, N=N)
    scales = process_scales('log-piecewise', N, resolve_wavelet(SPEC, N=N),
                            nv=8)
    plan = plan_from_numpy(scales, None, SPEC, N)
    n_up, n1, _ = pad_params(N, 'reflect')
    x = np.random.default_rng(seed).standard_normal(N).astype(np.float32)
    xp = jpadsignal(jnp.asarray(x), 'reflect')
    half = n_up // 2 + 1
    xh = jfft(Complex(xp, jnp.zeros_like(xp)), axis=-1,
              out_range=(0, half), imag_zero=True, engine='xla')
    gamma = float(10 * np.finfo(np.float32).eps)
    WxF, kF, off = cwt_fused_bins_direct(
        xh, jnp.asarray(plan['scales'], jnp.float32), wj, n_up, n1, N, 1.0,
        True, plan['params'], gamma, True, interpret=True,
        deriv_lowprec=False, klims=None, T=256)
    return plan, xh.to_numpy(), gamma, n_up, n1, WxF, kF, off


@pytest.fixture(scope='module')
def jax_b1():
    return _jax_b1()


def test_b1_plain_vs_jax_pallas(jax_b1):
    plan, xh, gamma, n_up, n1, WxF, kF, off = jax_b1
    na = len(plan['scales'])
    Wx_j = (np.asarray(WxF.re[:na, off:off + N])
            + 1j * np.asarray(WxF.im[:na, off:off + N]))
    k_j = np.asarray(kF[:na, off:off + N], np.int32)
    Wx_t, k_t = cwt_bins(torch.from_numpy(xh.astype(np.complex64)),
                         torch.tensor(plan['scales'].ravel(),
                                      dtype=torch.float32),
                         resolve_wavelet(SPEC, N=N), n_up, n1, N, 1.0, True,
                         plan['params'], gamma, True)
    assert Wx_t.shape == (na, N) and k_t.dtype == torch.int32
    Wx_t, k_t = Wx_t.numpy(), k_t.numpy()
    assert np.abs(Wx_t - Wx_j).max() <= 1e-5 * np.abs(Wx_j).max()
    # bins: identical on >= 99% of valid cells, the rest within +-1 bin
    # (float32 rounding of w at bin boundaries); gating agrees exactly
    assert np.array_equal(k_t == -1, k_j == -1)
    valid = k_j >= 0
    assert (k_t[valid] == k_j[valid]).mean() >= 0.99
    assert np.abs(k_t[valid] - k_j[valid]).max() <= 1


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_b2_plain_vs_jax_pallas(jax_b1, dtype):
    """Same (padded) planes into both scatters: JAX's (Wx, int16 k) from
    B1 and a per-row const with zeros on the dummy rows."""
    plan, _, _, _, _, WxF, kF, _ = jax_b1
    na = len(plan['scales'])
    na_pad = WxF.re.shape[0]
    nbins = plan['params']['omax'] + 1
    const = np.zeros(na_pad, dtype)
    const[:na] = np.ravel(plan['const'])
    wre = np.asarray(WxF.re, dtype)
    wim = np.asarray(WxF.im, dtype)
    k = np.asarray(kF, np.int32)
    # a few out-of-range bins must be dropped by both
    k[0, :5] = nbins + 3
    TxF = scatter_kv_direct(Complex(jnp.asarray(wre), jnp.asarray(wim)),
                            jnp.asarray(k), jnp.asarray(const), nbins,
                            interpret=True, T=256)
    Tx_j = (np.asarray(TxF.re[:nbins]) + 1j * np.asarray(TxF.im[:nbins]))
    Tx_t = scatter_kv(torch.from_numpy(wre + 1j * wim),
                      torch.from_numpy(k), torch.from_numpy(const),
                      nbins).numpy()
    assert Tx_t.shape == Tx_j.shape
    tol = 1e-6 if dtype == 'float32' else 1e-12
    assert np.abs(Tx_t - Tx_j).max() <= tol * np.abs(Tx_j).max()


def test_four_step_factors():
    for n_up in (4, 8, 1024, 2048, 262144):
        f1, f2 = four_step(n_up)
        assert f1 * f2 == n_up and f1 >= f2 and f1 & (f1 - 1) == 0
    with pytest.raises(NotImplementedError):
        four_step(3 * 1024)


def test_wrappers_check_inputs():
    Wx = torch.zeros((3, 8), dtype=torch.complex64)
    k = torch.zeros((3, 8), dtype=torch.int32)
    c = torch.ones(3)
    with pytest.raises(TypeError):
        scatter_kv(Wx, k.to(torch.int64), c, 4)
    with pytest.raises(ValueError):
        scatter_kv(Wx, k[:2], c, 4)
    with pytest.raises(ValueError):
        scatter_kv(Wx[:, ::2], k[:, ::2], c, 4)
    with pytest.raises(TypeError):
        scatter_kv(Wx, k, c.double(), 4)
    xh = torch.zeros(513, dtype=torch.complex64)
    with pytest.raises(ValueError):
        cwt_bins(xh, torch.ones(3), None, 2048, 0, 8, 1., True, {}, 1e-6,
                 True)
    with pytest.raises(TypeError):
        cwt_bins(xh, torch.ones(3, dtype=torch.float64), None, 1024, 0, 8,
                 1., True, {}, 1e-6, True)
