# -*- coding: utf-8 -*-
"""The port's public `cwt`/`icwt` (device='cpu', i.e. the plain PyTorch
version of the fused CWT kernel B3) against the JAX package on the CPU,
and that plain version against the JAX Pallas kernel in its
plain/derivative mode (`cwt_fused_pallas`) run in interpret mode.

Tolerances: Wx and dWx within 1e-5 of their max in float32 (the JAX
kernel's bf16x3 products: 2e-5) and 1e-9 in float64; `icwt` within 1e-5
relative of the JAX inverse (float32 sums in another order) and the
round trip `mad_rms < 0.1`.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import ssqueezepy_tpu as jstq
from ssqueezepy_tpu.ops.complexlib import Complex
from ssqueezepy_tpu.ops.cwt_pallas import cwt_fused_pallas
from ssqueezepy_tpu.ops.fft import fft as jfft
from ssqueezepy_tpu.ops.pad import padsignal as jpadsignal
from ssqueezepy_tpu.models.wavelets import Wavelet as JWavelet

import ssqueezepy_tpu_torch as tstq
from ssqueezepy_tpu_torch.models.cwt import resolve_wavelet
from ssqueezepy_tpu_torch.ops.cwt_cuda import cwt_fused
from ssqueezepy_tpu_torch.ops.pad import pad_params
from torch_jax_reference import xla_reference  # noqa: F401

N = 1000


def _np(c):
    if isinstance(c, torch.Tensor):
        return c.numpy()
    if isinstance(c, Complex):
        return np.asarray(c.re) + 1j * np.asarray(c.im)
    return np.asarray(c)


def _rel(a, b):
    return np.abs(_np(a) - _np(b)).max() / np.abs(_np(b)).max()


def _chirp(n=N, dtype='float32'):
    t = np.linspace(0, 6, n, endpoint=False)
    return np.cos(2 * np.pi * 2 * np.exp(t / 2)).astype(dtype)


@pytest.mark.parametrize('case', [
    dict(), dict(derivative=True), dict(l1_norm=False),
    dict(vectorized=False, derivative=True), dict(x2d=True),
    dict(scales='log', fs=4.), dict(dtype='float64', derivative=True),
    dict(dtype='float64', x2d=True, l1_norm=False)],
    ids=lambda c: '-'.join('%s=%s' % kv for kv in c.items()) or 'default')
def test_cwt_vs_jax(case):
    case = dict(case)
    dtype = case.pop('dtype', 'float32')
    x = np.random.default_rng(0).standard_normal(
        (3, N) if case.pop('x2d', False) else N).astype(dtype)
    norm = 'bandpass' if case.get('l1_norm', True) else 'energy'
    kw = dict(wavelet=('gmw', {'dtype': dtype, 'norm': norm}), nv=16,
              astensor=False, **case)
    out_j = jstq.cwt(x, **kw)
    out_t = tstq.cwt(x, device='cpu', **kw)
    assert len(out_t) == len(out_j)
    assert out_t[0].shape == out_j[0].shape == x.shape[:-1] + (
        len(out_j[1]), N)
    assert out_t[0].dtype == out_j[0].dtype
    assert np.array_equal(out_t[1], out_j[1])
    tol = 1e-5 if dtype == 'float32' else 1e-9
    assert _rel(out_t[0], out_j[0]) <= tol
    if case.get('derivative'):
        assert _rel(out_t[2], out_j[2]) <= tol


@pytest.mark.parametrize('derivative,l1_norm', [(True, True),
                                                (False, False)])
def test_b3_plain_vs_jax_pallas(derivative, l1_norm):
    n, dtype = 512, 'float32'
    spec = ('gmw', {'dtype': dtype,
                    'norm': 'bandpass' if l1_norm else 'energy'})
    wav_t = resolve_wavelet(spec, l1_norm=l1_norm, N=n)
    scales = tstq.process_scales('log', n, wav_t, nv=8)
    n_up, n1, _ = pad_params(n, 'reflect')
    x = np.random.default_rng(1).standard_normal(n).astype(dtype)
    xp = jpadsignal(jnp.asarray(x), 'reflect')
    xh = jfft(Complex(xp, jnp.zeros_like(xp)), axis=-1,
              out_range=(0, n_up // 2 + 1), imag_zero=True, engine='xla')
    Wx_j, dWx_j = cwt_fused_pallas(xh, jnp.asarray(scales, jnp.float32),
                                   JWavelet(spec, N=n), n_up, n1, n, 1.0,
                                   derivative, l1_norm, interpret=True)
    Wx_t, dWx_t = cwt_fused(torch.from_numpy(_np(xh).astype(np.complex64)),
                            torch.tensor(scales.ravel(), dtype=torch.float32),
                            wav_t, n_up, n1, n, 1.0, derivative, l1_norm)
    assert Wx_t.shape == (len(scales), n)
    assert _rel(Wx_t, Wx_j) <= 2e-5
    assert (dWx_t is None) == (dWx_j is None)
    if derivative:
        assert _rel(dWx_t, dWx_j) <= 2e-5


def test_cwt_fused_batched_rows_equal_single():
    """Each spectrum of a batch gives the same rows as alone."""
    wav = resolve_wavelet(('gmw', {'dtype': 'float64'}), N=256)
    sc = torch.tensor(tstq.process_scales('log', 256, wav, nv=8).ravel())
    xh = torch.randn(2, 257, dtype=torch.complex128,
                     generator=torch.Generator().manual_seed(0))
    Wb, dWb = cwt_fused(xh, sc, wav, 512, 128, 256, 1., True, True)
    for b in range(2):
        W1, dW1 = cwt_fused(xh[b].contiguous(), sc, wav, 512, 128, 256, 1.,
                            True, True)
        assert torch.allclose(Wb[b], W1) and torch.allclose(dWb[b], dW1)


@pytest.mark.parametrize('scales,one_int', [('log', True), ('log', False),
                                            ('log-piecewise', True),
                                            ('linear', True)])
def test_icwt_vs_jax(scales, one_int):
    x = _chirp()
    wav = ('gmw', {'dtype': 'float32'})
    Wx, _ = tstq.cwt(x, wavelet=wav, scales=scales, device='cpu')
    kw = dict(scales=scales, one_int=one_int)
    x_j = jstq.icwt(Wx.numpy(), **kw)
    x_t = tstq.icwt(Wx, **kw)
    assert x_t.shape == x_j.shape == (N,)
    assert np.allclose(x_t, x_j, rtol=1e-5, atol=1e-5 * np.abs(x_j).max())
    assert np.allclose(tstq.icwt(Wx.numpy(), **kw), x_j, rtol=1e-5,
                       atol=1e-5 * np.abs(x_j).max())
    if one_int:
        assert tstq.toolkit.mad_rms(x, x_t) < 0.1


def test_icwt_batched_one_integral():
    xb = np.stack([_chirp(), -_chirp()])
    Wx, _ = tstq.cwt(xb, scales='log', device='cpu')
    out = tstq.icwt(Wx, scales='log')
    assert out.shape == (2, N)
    assert np.allclose(out[1], -out[0], atol=1e-5)
    assert np.allclose(out, jstq.icwt(Wx.numpy(), scales='log'), rtol=1e-5,
                       atol=1e-5)


# padtype=None and rpadded=True at a length with a prime factor above 7
# (1001 = 7 11 13), the higher orders and the other wavelets, which raised
# here before they were ported, now agree with the JAX package (the
# unpadded ones through `cwt_general`; more in tests/test_torch_padnone.py,
# tests/test_torch_prime_length.py and tests/test_torch_wavelet_routes.py)
@pytest.mark.parametrize('kw', [
    dict(order=1), dict(rpadded=True, padtype=None), dict(padtype=None),
    dict(wavelet='morlet'), dict(wavelet=('gmw', {'order': 1}))],
    ids=lambda kw: next(iter(kw)) + '=' + str(next(iter(kw.values()))))
def test_cwt_outside_slice_raises(kw):
    x = _chirp(1001) if 'padtype' in kw else _chirp()
    assert _rel(tstq.cwt(x, device='cpu', **kw)[0],
                jstq.cwt(x, **kw)[0]) <= 1e-5


def test_cwt_default_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match='CUDA'):
        tstq.cwt(_chirp())
