# -*- coding: utf-8 -*-
"""Gradients through the port's kernels (device='cpu': each kernel
wrapper's `torch.autograd.Function` around its plain version, the same
Function and backward the card runs around its kernel) against the JAX
package's gradients through its custom VJPs and its XLA path:

  * the counterparts of the JAX package's gradient tests, with their
    seeds, shapes and tolerances: `tests/test_grad.py:24` (B5, the
    adjoint gather), `:47` (B4 on 'lin' and 'log' grids, dWx's gradient
    exactly 0), `:87` (B3, in xh and the scales) and `:120` (the
    end-to-end reconstruction loss, 5e-3); `tests/test_ssq_pallas.py:571`
    (B2, the adjoint gather); `tests/test_direct_pipeline.py:103-116` (B1
    then B2: finite and non-zero);
  * per Function, float64: <J u, v> = <u, J^T v> to 1e-10 relative, J u
    by forward-mode AD of the wrapper's plain version (the function the
    kernel computes), J^T v by the Function's backward; <a, b> is the real
    inner product Re(sum(conj(a) b)) (torch's complex gradient is
    g_re + 1j g_im of a real loss);
  * the CPU output's `grad_fn` is the Function's; without grad (no input
    that requires it, or `torch.no_grad()`) no `grad_fn` and outputs
    `torch.equal` to the plain version;
  * the public routes at N = 1024 (`ssq_cwt` and its `get_dWx` and
    `get_w` routes, `cwt` with `icwt`, `ssq_cwt2` (and `get_w`), `stft`
    at hop 1 and 3 with `istft`, `ssq_stft` at hop 1 and 3, `ssq_stft2`
    (and `get_w`), `ssqueeze` from (Wx, dWx)): the port's x.grad against
    `jax.grad` of the JAX call, for a reconstruction loss through the
    route's inverse (1e-4 of max in float32, 1e-9 in float64) and for
    sum |out|^2 (2e-3 of max in float32, where cells whose bin flips
    between the packages read a neighbour's cotangent; 1e-9 in float64);
  * a (B, N) batch: each row's x.grad equal to the one-signal call's.
"""
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD
import jax
import jax.numpy as jnp

import ssqueezepy_tpu as jstq
from ssqueezepy_tpu.ops.complexlib import Complex
from ssqueezepy_tpu.ops.ssq_kernels import (ssq_bin_params as jbin_params,
                                            compute_bins as jcompute_bins,
                                            _scatter_xla,
                                            ssqueeze_fast as jssqueeze_fast)
from ssqueezepy_tpu.ops.ssq_pallas import (shift_scatter_pallas,
                                           ssq_fused_pallas,
                                           scatter_kv_pallas)
from ssqueezepy_tpu.ops.phase import phase_transform_w as jphase_w
from ssqueezepy_tpu.models import stft as jstft_mod

import ssqueezepy_tpu_torch as tstq
from ssqueezepy_tpu_torch.models.cwt import resolve_wavelet
from ssqueezepy_tpu_torch.models.ssq_cwt import _ssq_cwt_plan
from ssqueezepy_tpu_torch.models.ssq_stft import fsst2_plan, stft_plan
from ssqueezepy_tpu_torch.models.stft import signal_spectrum
from ssqueezepy_tpu_torch.models.windows import get_window
from ssqueezepy_tpu_torch.ops import cwt_cuda, ssq_cuda, stft_cuda
from ssqueezepy_tpu_torch.ops.fft import rfft
from ssqueezepy_tpu_torch.ops.pad import pad_params, padsignal
from ssqueezepy_tpu_torch.ops.ssq_kernels import ssq_bin_params, ssqueeze_fast
from ssqueezepy_tpu_torch.ops.stft_conv import conv_bank, conv_table
from torch_jax_reference import xla_reference  # noqa: F401


def _cplx(re, im):
    return torch.complex(torch.as_tensor(np.asarray(re)),
                         torch.as_tensor(np.asarray(im)))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


# ---- the JAX package's gradient tests, on the port -------------------------
def test_shift_scatter_grad_is_adjoint_gather():
    """`tests/test_grad.py:24` (B5)."""
    rng = np.random.default_rng(0)
    na, nbins, N = 40, 40, 96
    vre = rng.standard_normal((na, N)).astype('float32')
    vim = rng.standard_normal((na, N)).astype('float32')
    k = rng.integers(0, nbins, (na, N)).astype(np.int32)
    valid = rng.random((na, N)) > 0.3

    def loss_pallas(a, b):
        out = shift_scatter_pallas(a, b, jnp.asarray(k), jnp.asarray(valid),
                                   nbins, None, interpret=True, T=128)
        return jnp.sum(out.re ** 2 + 0.5 * out.im ** 2)

    def loss_xla(a, b):
        out = _scatter_xla(a, b, jnp.asarray(k), jnp.asarray(valid), nbins)
        return jnp.sum(out.re ** 2 + 0.5 * out.im ** 2)

    gp = jax.grad(loss_pallas, argnums=(0, 1))(jnp.asarray(vre),
                                                jnp.asarray(vim))
    gx = jax.grad(loss_xla, argnums=(0, 1))(jnp.asarray(vre),
                                             jnp.asarray(vim))
    v = _cplx(vre, vim).requires_grad_()
    out = ssq_cuda.shift_scatter(v, torch.as_tensor(k), torch.as_tensor(valid),
                                 nbins)
    assert isinstance(out.grad_fn, ssq_cuda.ShiftScatterGrad._backward_cls)
    (out.real ** 2 + 0.5 * out.imag ** 2).sum().backward()
    for g in (gp, gx):
        for port, ref in ((v.grad.real, g[0]), (v.grad.imag, g[1])):
            assert np.allclose(port.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def _grid(mode, nbins):
    """The 'lin' and 'log' grids of `tests/test_ssq_pallas.py::_grids`."""
    if mode == 'lin':
        return np.linspace(0.008, 0.5, nbins)
    return 2 ** np.linspace(np.log2(1 / 2048), np.log2(0.5), nbins)


@pytest.mark.parametrize('mode', ['lin', 'log'])
def test_ssq_fused_grad_vs_jax(mode):
    """`tests/test_grad.py:47` (B4): the gradient in Wx and const against
    JAX's custom VJP (interpret mode) and its XLA formulation; dWx's
    gradient is exactly 0 (it enters only through the bins)."""
    rng = np.random.default_rng(0)
    na, N = 48, 100
    freqs = _grid(mode, na)
    params = jbin_params(freqs, logscale=(mode == 'log'))
    gamma = 1e-3
    Wxr, Wxi, dWr, dWi = (rng.standard_normal((na, N)).astype('float32')
                          for _ in range(4))
    const = rng.random(na).astype('float32') + 0.5
    nb = np.arange(na - 1, -1, -1).astype(np.int32)

    def loss_pallas(wr, wi, dr, di, c):
        Tx = ssq_fused_pallas(Complex(wr, wi), Complex(dr, di), c, params,
                              gamma, True, nb, interpret=True, T=256)
        return jnp.sum(Tx.re ** 2 + Tx.im ** 2)

    def loss_xla(wr, wi, dr, di, c):
        w = jphase_w(Complex(wr, wi), Complex(dr, di), gamma)
        k, valid = jcompute_bins(w, params, True)
        Tx = _scatter_xla(wr * c.reshape(-1, 1), wi * c.reshape(-1, 1),
                          k, valid, params['omax'] + 1)
        return jnp.sum(Tx.re ** 2 + Tx.im ** 2)

    args = [jnp.asarray(a) for a in (Wxr, Wxi, dWr, dWi, const)]
    gp = jax.grad(loss_pallas, argnums=(0, 1, 2, 3, 4))(*args)
    gx = jax.grad(loss_xla, argnums=(0, 1, 2, 3, 4))(*args)

    Wx = _cplx(Wxr, Wxi).requires_grad_()
    dWx = _cplx(dWr, dWi).requires_grad_()
    c = torch.as_tensor(const).requires_grad_()
    Tx = ssq_cuda.ssq_fused(Wx, dWx, c, ssq_bin_params(freqs, mode == 'log'),
                            gamma, True)
    assert isinstance(Tx.grad_fn, ssq_cuda.SsqFusedGrad._backward_cls)
    (Tx.abs() ** 2).sum().backward()
    for g in (gp, gx):
        for port, ref in ((Wx.grad.real, g[0]), (Wx.grad.imag, g[1]),
                          (c.grad, g[4])):
            assert np.allclose(port.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)
    assert dWx.grad is None
    assert np.all(np.asarray(gx[2]) == 0) and np.all(np.asarray(gx[3]) == 0)


def test_cwt_fused_grad_vs_jax():
    """`tests/test_grad.py:87` (B3, Wx and dWx): the gradient in the half
    spectrum xh and in the scales against JAX's XLA half-spectrum
    formulation (its custom VJP's backward), relative 5e-3."""
    from ssqueezepy_tpu.models.wavelets import Wavelet as JWavelet
    from ssqueezepy_tpu.ops.cwt_pallas import _cwt_half_xla
    rng = np.random.default_rng(0)
    jwav = JWavelet(('gmw', {'dtype': 'float32'}))
    wav = resolve_wavelet(('gmw', {'dtype': 'float32'}))
    n_up, n1, N = 2048, 512, 1024
    half = n_up // 2 + 1
    scales = (2. ** (np.arange(8, 40) / 8)).astype('float32')
    xhr = rng.standard_normal(half).astype('float32')
    xhi = rng.standard_normal(half).astype('float32')

    def loss_xla(a, b, s):
        o = _cwt_half_xla(a, b, s, jnp.asarray(1.0, 'float32'), jwav, n_up,
                          n1, N, True, True, 'float32')
        return jnp.sum(o[0] ** 2 + o[1] ** 2 + o[2] ** 2)

    gx = jax.grad(loss_xla, argnums=(0, 1, 2))(
        jnp.asarray(xhr), jnp.asarray(xhi), jnp.asarray(scales))
    xh = _cplx(xhr, xhi).requires_grad_()
    sc = torch.as_tensor(scales).requires_grad_()
    Wx, dWx = cwt_cuda.cwt_fused(xh, sc, wav, n_up, n1, N, 1.0, True, True)
    assert isinstance(Wx.grad_fn, cwt_cuda.CwtFusedGrad._backward_cls)
    (Wx.abs() ** 2 + dWx.real ** 2).sum().backward()
    for port, ref in ((xh.grad.real, gx[0]), (xh.grad.imag, gx[1]),
                      (sc.grad, gx[2])):
        ref = np.asarray(ref)
        den = max(1e-3, float(np.abs(ref).max()))
        assert np.abs(port.numpy() - ref).max() / den < 5e-3


def test_reconstruction_grad_end_to_end_vs_jax():
    """`tests/test_grad.py:120`: the gradient of a reconstruction loss
    through padding, B3 (Wx and dWx) and B4 against `jax.grad` of the
    JAX package's XLA path, relative 5e-3."""
    from ssqueezepy_tpu.ops.pad import padsignal as jpadsignal
    from ssqueezepy_tpu.models.cwt import cwt_core as jcwt_core
    from ssqueezepy_tpu.models.cwt import _process_gmw_wavelet
    from ssqueezepy_tpu.models.wavelets import Wavelet as JWavelet
    N = 1024
    x = np.cos(2 * np.pi * 8 * np.linspace(0, 1, N)).astype('float32')
    jwav = JWavelet._init_if_not_isinstance(
        _process_gmw_wavelet(('gmw', {'dtype': 'float32'}), True), N=N)
    wav = resolve_wavelet(('gmw', {'dtype': 'float32'}), N=N)
    n_up, n1, _ = pad_params(N, 'reflect')
    scales = (2. ** (np.arange(8, 40) / 8)).astype('float32')
    na = len(scales)
    freqs = 2 ** np.linspace(np.log2(1 / N), np.log2(0.5), na)
    params = jbin_params(freqs, logscale=True)
    gamma = 1e-3
    nb = np.arange(na).astype(np.int32)

    def loss(xj):
        xp = jpadsignal(xj, 'reflect')
        Wx, dWx = jcwt_core(xp, jwav, jnp.asarray(scales).reshape(-1, 1),
                            1.0, True, True, n1, N)
        Tx = jssqueeze_fast(Wx, dWx, None, 1.0, logscale=True, flipud=True,
                            gamma=gamma, params=params, natural_bins=nb)
        return jnp.mean((Tx.re.sum(axis=-2) - xj) ** 2)

    g_ref = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    xt = torch.as_tensor(x).requires_grad_()
    xh = rfft(padsignal(xt, 'reflect')).contiguous()
    Wx, dWx = cwt_cuda.cwt_fused(xh, torch.as_tensor(scales), wav, n_up, n1,
                                 N, 1.0, True, True)
    Tx = ssqueeze_fast(Wx, dWx, None, 1.0, logscale=True, flipud=True,
                       gamma=gamma, params=ssq_bin_params(freqs, True),
                       device='cpu')
    ((Tx.real.sum(-2) - xt) ** 2).mean().backward()
    g = xt.grad.numpy()
    assert np.isfinite(g).all()
    assert np.abs(g - g_ref).max() / max(1e-6, np.abs(g_ref).max()) < 5e-3


def test_scatter_kv_grad_is_adjoint_gather():
    """`tests/test_ssq_pallas.py:571` (B2): d/dW of sum|Tx|^2 = 2 Tx[k, j]
    (the adjoint gather), and against JAX's custom VJP (interpret
    mode)."""
    rng = np.random.default_rng(4)
    na, N, nbins = 32, 96, 32
    wr = rng.standard_normal((na, N)).astype('float32')
    wi = rng.standard_normal((na, N)).astype('float32')
    k = rng.integers(0, nbins, (na, N)).astype(np.int32)
    const = np.ones(na, np.float32)

    def loss(a, b):
        out = scatter_kv_pallas(Complex(a, b), jnp.asarray(k),
                                jnp.asarray(const), nbins,
                                natural_bins=None, interpret=True, T=96)
        return (out.re ** 2).sum() + (out.im ** 2).sum()

    gj = jax.grad(loss, argnums=(0, 1))(jnp.asarray(wr), jnp.asarray(wi))
    W = _cplx(wr, wi).requires_grad_()
    Tx = ssq_cuda.scatter_kv(W, torch.as_tensor(k), torch.as_tensor(const),
                             nbins)
    assert isinstance(Tx.grad_fn, ssq_cuda.ScatterKvGrad._backward_cls)
    (Tx.abs() ** 2).sum().backward()
    cols = np.arange(N)[None, :].repeat(na, 0)
    expect = 2 * Tx.detach().numpy()[k, cols]
    assert np.allclose(W.grad.numpy(), expect, rtol=1e-4, atol=1e-5)
    assert np.allclose(W.grad.real.numpy(), np.asarray(gj[0]), rtol=1e-4,
                       atol=1e-5)
    assert np.allclose(W.grad.imag.numpy(), np.asarray(gj[1]), rtol=1e-4,
                       atol=1e-5)


def test_cwt_bins_then_scatter_grad_flows():
    """`tests/test_direct_pipeline.py:103-116` (B1 then B2): the gradient
    of sum Re(Tx)^2 + sum Re(Wx)^2 in the padded signal is finite and
    non-zero, and equals the gradient through the plain versions."""
    N = 512
    xp_np = np.random.default_rng(0).standard_normal(
        pad_params(N, 'reflect')[0]).astype('float32')
    wav = resolve_wavelet(('gmw', {'dtype': 'float32'}), N=N)
    plan, _ = _ssq_cwt_plan(wav, N, 'log-piecewise', 8, None, 'peak', True,
                            1.)
    n_up, n1, _ = pad_params(N, 'reflect')
    sc = torch.as_tensor(plan.scales.ravel(), dtype=torch.float32)
    c = torch.as_tensor(np.broadcast_to(np.ravel(plan.const),
                                        (len(sc),)).copy(),
                        dtype=torch.float32)
    gamma = 10 * float(np.finfo(np.float32).eps)
    nbins = plan.params['omax'] + 1
    grads = []
    for bins, scatter in ((cwt_cuda.cwt_bins, ssq_cuda.scatter_kv),
                          (cwt_cuda.cwt_bins_plain,
                           ssq_cuda.scatter_kv_plain)):
        xp = torch.as_tensor(xp_np).requires_grad_()
        Wf, kk = bins(rfft(xp).contiguous(), sc, wav, n_up, n1, N, 1., True,
                      plan.params, gamma, True)
        Tf = scatter(Wf, kk, c, nbins)
        ((Tf.real ** 2).sum() + (Wf.real ** 2).sum()).backward()
        grads.append(xp.grad)
    assert torch.isfinite(grads[0]).all()
    assert float(grads[0].abs().sum()) > 0
    assert torch.allclose(grads[0], grads[1], rtol=1e-5,
                          atol=1e-6 * float(grads[1].abs().max()))


# ---- every Function: adjoint, grad_fn, the path without grad ---------------
N_K = 300


def _cwt_case(dtype, batch=False):
    wav = resolve_wavelet(('gmw', {'dtype': dtype}), N=N_K)
    plan, _ = _ssq_cwt_plan(wav, N_K, 'log', 8, None, 'peak', True, 1.)
    n_up, n1, _ = pad_params(N_K, 'reflect')
    tdt = getattr(torch, dtype)
    x = np.random.default_rng(1).standard_normal((2, N_K) if batch
                                                 else N_K)
    xh = rfft(padsignal(torch.as_tensor(x, dtype=tdt), 'reflect'))
    sc = torch.as_tensor(plan.scales.ravel(), dtype=tdt)
    gamma = 10 * float(np.finfo(dtype).eps)
    return wav, plan, n_up, n1, xh.contiguous(), sc, gamma


def _stft_case(dtype, batch=False):
    n_fft = 32
    plan = stft_plan(None, None, n_fft, n_fft, 1., dtype)
    x = np.random.default_rng(2).standard_normal((2, N_K) if batch
                                                 else N_K)
    xh = signal_spectrum(torch.as_tensor(x, dtype=getattr(torch, dtype)),
                         n_fft, 'reflect')
    H = conv_table(plan.window, n_fft, xh.shape[-1], True, dtype, 'cpu')
    Hd = conv_table(plan.diff_window, n_fft, xh.shape[-1], True, dtype,
                    'cpu')
    Sfs = torch.as_tensor(plan.Sfs)
    bins = dict(Sfs=Sfs, params=plan.params, gamma=1e-8, flipud=False)
    bank = conv_bank(fsst2_plan(None, None, n_fft, n_fft, 1., dtype).bank,
                     n_fft, xh.shape[-1], True, dtype, 'cpu')
    return plan, xh, H, Hd, Sfs, bins, bank


def _scatter_case(dtype, batch=False):
    rng = np.random.default_rng(3)
    shape = ((2,) if batch else ()) + (24, 80)
    cdt = torch.complex64 if dtype == 'float32' else torch.complex128
    rdt = getattr(torch, dtype)
    Wx = torch.as_tensor(rng.standard_normal(shape)
                         + 1j * rng.standard_normal(shape)).to(cdt)
    dWx = torch.as_tensor(rng.standard_normal(shape)
                          + 1j * rng.standard_normal(shape)).to(cdt)
    k = torch.as_tensor(rng.integers(-30, 30, shape).astype(np.int32))
    valid = torch.as_tensor(rng.random(shape) > .2)
    const = torch.as_tensor(rng.random(24) + .5, dtype=rdt)
    params = ssq_bin_params(np.linspace(.01, .5, 24), False)
    return Wx, dWx, k, valid, const, params


def _functions(dtype, batch=False):
    """name -> (Function, wrapper(*floats), plain(*floats), floats): the
    wrapper and its plain version as functions of the differentiable
    inputs (the tuple `floats`), each returning a tuple of outputs."""
    wav, plan, n_up, n1, xh, sc, gamma = _cwt_case(dtype, batch)
    cw = (wav, n_up, n1, N_K, 1.)
    p = plan.params
    splan, sxh, H, Hd, Sfs, bins, bank = _stft_case(dtype, batch)
    Wx, dWx, k, valid, const, sp = _scatter_case(dtype, batch)
    nb = sp['omax'] + 1
    fs = 2.
    return {
        'cwt_bins': (
            cwt_cuda.CwtBinsGrad,
            lambda xh, sc: cwt_cuda.cwt_bins(xh, sc, *cw, True, p, gamma,
                                             True),
            lambda xh, sc: cwt_cuda.cwt_bins_plain(xh, sc, *cw, True, p,
                                                   gamma, True),
            (xh, sc)),
        'cwt_fused': (
            cwt_cuda.CwtFusedGrad,
            lambda xh, sc: cwt_cuda.cwt_fused(xh, sc, *cw, False, False),
            lambda xh, sc: cwt_cuda.cwt_fused_plain(xh, sc, *cw, False,
                                                    False),
            (xh, sc)),
        'cwt_fused_dwx': (
            cwt_cuda.CwtFusedGrad,
            lambda xh, sc: cwt_cuda.cwt_fused(xh, sc, *cw, True, True),
            lambda xh, sc: cwt_cuda.cwt_fused_plain(xh, sc, *cw, True,
                                                    True),
            (xh, sc)),
        'cwt_bins2': (
            cwt_cuda.CwtBins2Grad,
            lambda xh, sc: cwt_cuda.cwt_bins2(xh, sc, *cw, p, gamma, True),
            lambda xh, sc: cwt_cuda.cwt_bins2_plain(xh, sc, *cw, p, gamma,
                                                    True),
            (xh, sc)),
        'cwt_w2': (
            cwt_cuda.CwtW2Grad,
            lambda xh: cwt_cuda.cwt_w2(xh, sc, *cw, gamma),
            lambda xh: cwt_cuda.wsst2_rows(xh, sc, *cw, gamma),
            (xh,)),
        'scatter_kv': (
            ssq_cuda.ScatterKvGrad,
            lambda W, c: (ssq_cuda.scatter_kv(W, k, c, nb),),
            lambda W, c: (ssq_cuda.scatter_kv_plain(W, k, c, nb),),
            (Wx, const)),
        'ssq_fused': (
            ssq_cuda.SsqFusedGrad,
            lambda W, dW, c: (ssq_cuda.ssq_fused(W, dW, c, sp, 1e-8, True),),
            lambda W, dW, c: (ssq_cuda.ssq_fused_plain(W, dW, c, sp, 1e-8,
                                                       True),),
            (Wx, dWx, const)),
        'ssq_fused_sfs': (
            ssq_cuda.SsqFusedGrad,
            lambda W, dW, c: (ssq_cuda.ssq_fused(
                W, dW, c, sp, 1e-8, False, Sfs=c.detach() * .3),),
            lambda W, dW, c: (ssq_cuda.ssq_fused_plain(
                W, dW, c, sp, 1e-8, False, Sfs=c.detach() * .3),),
            (Wx, dWx, const)),
        'shift_scatter': (
            ssq_cuda.ShiftScatterGrad,
            lambda v, c: (ssq_cuda.shift_scatter(v, k, valid, nb, c),),
            lambda v, c: (ssq_cuda.shift_scatter_plain(v, k, valid, nb,
                                                       c),),
            (Wx, const)),
        'shift_scatter_noconst': (
            ssq_cuda.ShiftScatterGrad,
            lambda v: (ssq_cuda.shift_scatter(v, k, None, nb),),
            lambda v: (ssq_cuda.shift_scatter_plain(v, k, None, nb),),
            (Wx,)),
        'stft_conv_sx': (
            stft_cuda.StftConvGrad,
            lambda xh: stft_cuda.stft_conv(xh, H, None, N_K, fs),
            lambda xh: stft_cuda.stft_conv_plain(xh, H, None, N_K, fs),
            (sxh,)),
        'stft_conv_sx_dsx': (
            stft_cuda.StftConvGrad,
            lambda xh: stft_cuda.stft_conv(xh, H, Hd, N_K, fs),
            lambda xh: stft_cuda.stft_conv_plain(xh, H, Hd, N_K, fs),
            (sxh,)),
        'stft_conv_bins': (
            stft_cuda.StftConvGrad,
            lambda xh: stft_cuda.stft_conv(xh, H, Hd, N_K, fs, bins),
            lambda xh: stft_cuda.stft_conv_plain(xh, H, Hd, N_K, fs, bins),
            (sxh,)),
        'fsst2_conv': (
            stft_cuda.Fsst2ConvGrad,
            lambda xh: stft_cuda.fsst2_conv(xh, bank, N_K, fs, bins),
            lambda xh: stft_cuda.fsst2_conv_plain(xh, bank, N_K, fs, bins),
            (sxh,)),
        'fsst2_w': (
            stft_cuda.Fsst2WGrad,
            lambda xh: stft_cuda.fsst2_w(xh, bank, N_K, fs, Sfs, 1e-8),
            lambda xh: stft_cuda.fsst2_rows(xh, bank, N_K, fs, Sfs, 1e-8),
            (sxh,)),
    }


NAMES = list(_functions('float64'))


def _inner(a, b):
    a, b = a.detach(), b.detach()
    return float((a.conj() * b).real.sum()) if a.is_complex() else \
        float((a * b).sum())


def _floating(o):
    return o is not None and (o.is_floating_point() or o.is_complex())


@pytest.mark.parametrize('batch', [False, True])
@pytest.mark.parametrize('name', NAMES)
def test_function_backward_is_adjoint(name, batch):
    """float64: <J u, v> = <u, J^T v> to 1e-10 relative, J u by forward
    AD of the plain version, J^T v by the Function's backward."""
    Fn, wrapper, plain, floats = _functions('float64', batch)[name]
    rng = np.random.default_rng(5)

    def rand_like(t):
        r = torch.as_tensor(rng.standard_normal(t.shape), dtype=t.real.dtype)
        if t.is_complex():
            r = torch.complex(r, torch.as_tensor(
                rng.standard_normal(t.shape), dtype=t.real.dtype))
        # scales: a relative perturbation
        return r * t.abs() if not t.is_complex() else r

    us = [rand_like(t) for t in floats]
    with fwAD.dual_level():
        outs = plain(*(fwAD.make_dual(t, u) for t, u in zip(floats, us)))
        Ju = [None if not _floating(o) else fwAD.unpack_dual(o).tangent
              for o in outs]
    ins = [t.clone().requires_grad_() for t in floats]
    outs = wrapper(*ins)
    assert isinstance(outs[0].grad_fn, Fn._backward_cls)
    vs, pairs = [], []
    for o, ju in zip(outs, Ju):
        if not _floating(o):
            continue
        v = rand_like(o)
        if not o.is_complex():      # w2: its inf cells carry nothing
            v = torch.where(torch.isfinite(o), v, torch.zeros_like(v))
        if ju is None:
            ju = torch.zeros_like(o)
        ju = torch.where(torch.isfinite(ju), ju, torch.zeros_like(ju))
        vs.append(v)
        pairs.append((ju, v))
    gs = torch.autograd.grad([o for o in outs if _floating(o)], ins, vs,
                             allow_unused=True)
    lhs = sum(_inner(ju, v) for ju, v in pairs)
    rhs = sum(_inner(u, g) for u, g in zip(us, gs) if g is not None)
    assert abs(lhs) > 0
    assert abs(lhs - rhs) <= 1e-10 * max(abs(lhs), abs(rhs))


@pytest.mark.parametrize('name', NAMES)
def test_function_without_grad_is_the_plain_path(name):
    """No input that requires grad, or `torch.no_grad()`: no `grad_fn`,
    and the outputs `torch.equal` to the plain version's; with grad, the
    Function's outputs too."""
    for dtype in ('float32', 'float64'):
        Fn, wrapper, plain, floats = _functions(dtype)[name]
        ref = plain(*floats)

        def same(outs):
            assert len(outs) == len(ref)
            for o, r in zip(outs, ref):
                assert (o is None and r is None) or torch.equal(o, r)
        outs = wrapper(*floats)
        assert all(o is None or o.grad_fn is None for o in outs)
        same(outs)
        ins = [t.clone().requires_grad_() for t in floats]
        with torch.no_grad():
            outs = wrapper(*ins)
        assert all(o is None or o.grad_fn is None for o in outs)
        same(outs)
        outs = wrapper(*ins)
        assert isinstance(outs[0].grad_fn, Fn._backward_cls)
        same([None if o is None else o.detach() for o in outs])
        for o in outs:
            if o is not None and not _floating(o):
                assert not o.requires_grad


# ---- the public routes against jax.grad of the JAX calls -------------------
N = 1024
N_FFT = 64


def _signal(dtype, batch=False):
    """(x, y): a chirp in noise, and the chirp alone (the target of the
    reconstruction loss)."""
    rng = np.random.default_rng(7)
    t = np.linspace(0, 1, N, endpoint=False)
    y = np.cos(2 * np.pi * (30 * t + 120 * t ** 2))
    x = y + .3 * rng.standard_normal(N)
    if batch:
        x = np.stack([x, rng.standard_normal(N)])
    return x.astype(dtype), y.astype(dtype)


def _css(dtype):
    from ssqueezepy_tpu_torch.utils.cwt_utils import adm_ssq
    return adm_ssq(tstq.Wavelet(('gmw', {'dtype': dtype})))


def _istft_factor(dtype):
    window = get_window(None, N_FFT, n_fft=N_FFT)
    return 2 / window[N_FFT // 2]


def _routes(dtype):
    """name -> (port(x) -> (plane, rec, hop), jax(xj) -> (plane re, im,
    rec)): the route's output plane (Tx, Wx or Sx) and a reconstruction
    through its inverse, on the port (the inverses return a tensor that
    carries the graph) and on the JAX package (the same inverse as a
    differentiable formula)."""
    wav = ('gmw', {'dtype': dtype})
    css = _css(dtype)
    f = _istft_factor(dtype)
    jwin = get_window(None, N_FFT, n_fft=N_FFT, dtype=dtype)
    stft_kw = dict(n_fft=N_FFT, dtype=dtype)

    def ssq_cwt(kw, fn='ssq_cwt'):
        def port(x):
            Tx = getattr(tstq, fn)(x, wav, device='cpu', **kw)[0]
            return Tx, tstq.issq_cwt(Tx, wav), 1

        def ref(xj):
            Tx = getattr(jstq, fn)(xj, wav, **kw)[0]
            return Tx.re, Tx.im, Tx.re.sum(axis=-2) * (2 / css)
        return port, ref

    def cwt():
        _, sc = jstq.cwt(np.zeros(N, dtype), wav)
        c = np.asarray(jstq.icwt(np.eye(len(sc)).astype(complex), wav,
                                 scales=sc))

        def port(x):
            Wx, sc_ = tstq.cwt(x, wav, device='cpu')
            return Wx, tstq.icwt(Wx, wav, scales=sc_), 1

        def ref(xj):
            Wx, _ = jstq.cwt(xj, wav)
            return Wx.re, Wx.im, (Wx.re * jnp.asarray(c)[:, None]).sum(0)
        return port, ref

    def stft(hop):
        def port(x):
            Sx = tstq.stft(x, hop_len=hop, device='cpu', **stft_kw)
            return Sx, tstq.istft(Sx, n_fft=N_FFT, hop_len=hop, N=N), 1

        def ref(xj):
            Sx = jstq.stft(xj, hop_len=hop, **stft_kw)
            run = jstft_mod._istft_jit(Sx.shape, dtype, N_FFT, hop, N, 1,
                                       True, jstft_mod._window_key(jwin,
                                                                   None))
            return Sx.re, Sx.im, run(Sx.re, Sx.im)
        return port, ref

    def ssq_stft(fn, hop=1, **kw):
        def port(x):
            Tx = getattr(tstq, fn)(x, device='cpu', **stft_kw, **kw)[0]
            rec = (tstq.issq_stft(Tx, n_fft=N_FFT) if hop == 1 else
                   Tx.real.sum(-2) * f)
            return Tx, rec, hop

        def ref(xj):
            Tx = getattr(jstq, fn)(xj, **stft_kw, **kw)[0]
            return Tx.re, Tx.im, Tx.re.sum(axis=-2) * f
        return port, ref

    def ssqueeze():
        gamma = 10 * float(np.finfo(dtype).eps)
        kw = dict(wavelet=wav, gamma=gamma, maprange='peak')

        def port(x):
            Wx, sc, dWx = tstq.cwt(x, wav, derivative=True, device='cpu')
            Tx, _ = tstq.ssqueeze(Wx, dWx=dWx, scales=sc, device='cpu',
                                  **kw)
            return Tx, tstq.issq_cwt(Tx, wav), 1

        def ref(xj):
            Wx, sc, dWx = jstq.cwt(xj, wav, derivative=True)
            Tx, _ = jstq.ssqueeze(Wx, dWx=dWx, scales=sc, **kw)
            return Tx.re, Tx.im, Tx.re.sum(axis=-2) * (2 / css)
        return port, ref

    return {
        'ssq_cwt': ssq_cwt({}),
        'ssq_cwt_get_dWx': ssq_cwt(dict(get_dWx=True)),
        'ssq_cwt_get_w': ssq_cwt(dict(get_w=True)),
        'cwt': cwt(),
        'ssq_cwt2': ssq_cwt({}, 'ssq_cwt2'),
        'ssq_cwt2_get_w': ssq_cwt(dict(get_w=True), 'ssq_cwt2'),
        'stft': stft(1),
        'stft_hop3': stft(3),
        'ssq_stft': ssq_stft('ssq_stft'),
        'ssq_stft_hop3': ssq_stft('ssq_stft', 3, hop_len=3),
        'ssq_stft2': ssq_stft('ssq_stft2'),
        'ssq_stft2_get_w': ssq_stft('ssq_stft2', get_w=True),
        'ssqueeze_dwx': ssqueeze(),
    }


ROUTES = list(_routes('float32'))
TOL = {('rec', 'float32'): 1e-4, ('rec', 'float64'): 1e-9,
       ('sq', 'float32'): 2e-3, ('sq', 'float64'): 1e-9}


def _loss(kind, plane_re, plane_im, rec, y, hop):
    """sum |out|^2, or the reconstruction's mean squared distance from the
    target y (at the hops' samples)."""
    if kind == 'sq':
        return (plane_re ** 2 + plane_im ** 2).sum()
    return ((rec - y[..., ::hop]) ** 2).mean()


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
@pytest.mark.parametrize('kind', ['rec', 'sq'])
@pytest.mark.parametrize('route', ROUTES)
def test_public_route_grad_vs_jax(route, kind, dtype):
    """x.grad of the port's call (device='cpu') against `jax.grad` of the
    JAX package's, relative to the JAX gradient's max."""
    port, ref = _routes(dtype)[route]
    x, y = _signal(dtype)
    xt = torch.as_tensor(x).requires_grad_()
    plane, rec, hop = port(xt)
    assert plane.grad_fn is not None
    _loss(kind, plane.real, plane.imag, rec, torch.as_tensor(y),
          hop).backward()

    def jloss(xj):
        re, im, r = ref(xj)
        return _loss(kind, re, im, r, jnp.asarray(y), hop)
    g_ref = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    g = xt.grad.numpy()
    assert np.isfinite(g).all() and np.abs(g_ref).max() > 0
    assert _rel(g, g_ref) < TOL[kind, dtype], _rel(g, g_ref)


@pytest.mark.parametrize('route', [r for r in ROUTES if r not in (
    'ssq_cwt_get_w', 'ssq_cwt2_get_w')])
def test_batched_grad_rows_equal_one_signal(route):
    """A (2, N) batch through the route (every route but the `get_w` ones
    that take no batch in either package): each row's x.grad equal to
    the one-signal call's (the batched kernels' rows are the one-signal
    rows, and so are their backwards)."""
    port, _ = _routes('float32')[route]
    x, _ = _signal('float32', batch=True)

    def grad(sig):
        xt = torch.as_tensor(sig).requires_grad_()
        plane, _, _ = port(xt)
        (plane.abs() ** 2).sum().backward()
        return xt.grad
    gb = grad(x)
    for b in range(2):
        g1 = grad(x[b])
        assert torch.allclose(gb[b], g1, rtol=0,
                              atol=1e-6 * float(g1.abs().max()))
