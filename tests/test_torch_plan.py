# -*- coding: utf-8 -*-
"""The PyTorch port's host layers against the JAX package: padding and
FFT, GMW values, center frequency, admissibility, scale and ssq-frequency
plans, bin parameters and the bin map. Same numpy inputs to both; plans
must agree bit for bit, device values to the stated tolerance.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ssqueezepy_tpu.ops import pad as jpad, fft as jfft
from ssqueezepy_tpu.ops.complexlib import Complex
from ssqueezepy_tpu.models import wavelets as jwav, ssqueezing as jsq
from ssqueezepy_tpu.utils import cwt_utils as jcu
from ssqueezepy_tpu.ops import ssq_kernels as jssq

from ssqueezepy_tpu_torch.ops import pad as tpad, fft as tfft
from ssqueezepy_tpu_torch.models import wavelets as twav, ssqueezing as tsq
from ssqueezepy_tpu_torch.utils import cwt_utils as tcu
from ssqueezepy_tpu_torch.ops import ssq_kernels as tssq
from torch_jax_reference import xla_reference  # noqa: F401

PADTYPES = ('reflect', 'symmetric', 'replicate', 'wrap', 'zero')
TOL = {'float32': 1e-6, 'float64': 1e-13}


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
@pytest.mark.parametrize('padtype', PADTYPES)
def test_pad_and_fft(padtype, dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(300).astype(dtype)
    assert tpad.pad_params(300, padtype) == jpad.pad_params(300, padtype)
    xp_j = np.asarray(jpad.padsignal(jnp.asarray(x), padtype))
    xp_t = tpad.padsignal(torch.from_numpy(x), padtype)
    assert xp_t.dtype == getattr(torch, dtype)
    assert np.array_equal(xp_t.numpy(), xp_j)

    n_up = xp_j.shape[-1]
    half = n_up // 2 + 1
    X_j = jfft.fft(Complex(jnp.asarray(xp_j), jnp.zeros(n_up, dtype)),
                   out_range=(0, half), engine='xla').to_numpy()
    X_t = tfft.rfft(xp_t).numpy()
    m = np.abs(X_j).max()
    assert np.abs(X_t - X_j).max() < TOL[dtype] * m
    Xf_t = tfft.fft(xp_t.to(torch.complex128 if dtype == 'float64'
                            else torch.complex64)).numpy()
    assert np.abs(Xf_t[:half] - X_j).max() < TOL[dtype] * m
    x_back = tfft.ifft(torch.from_numpy(Xf_t), out_range=(5, 25)).numpy()
    assert np.abs(x_back.real - xp_j[5:25]).max() < 10 * TOL[dtype] * \
        np.abs(xp_j).max()


@pytest.mark.parametrize('norm', ['bandpass', 'energy'])
def test_gmw_values_center_frequency_adm(norm):
    spec = ('gmw', {'norm': norm, 'dtype': 'float64'})
    wj, wt = jwav.Wavelet(spec), twav.Wavelet(spec)
    assert wj.dtype == wt.dtype and wj.name == wt.name
    grid = np.concatenate([[-1., 0.], np.linspace(1e-3, 12, 997)])
    assert np.array_equal(wt.evaluate_np(grid), wj.evaluate_np(grid))
    # device values: the log-space exponent (beta ln w ~ 60 at the peak)
    # carries ~60 ulp of absolute error into exp in either framework
    for dtype, tol in (('float32', 2e-5), ('float64', 1e-13)):
        vj = np.asarray(wj.fn(jnp.asarray(grid, dtype), xp=jnp))
        vt = wt.fn(torch.tensor(grid, dtype=getattr(torch, dtype)),
                   xp=torch).numpy()
        assert np.abs(vt - vj).max() <= tol * np.abs(vj).max()
    for kind, scale in (('energy', None), ('peak', 7.), ('peak-ct', None)):
        assert twav.center_frequency(wt, scale, N=1024, kind=kind) == \
            jwav.center_frequency(wj, scale, N=1024, kind=kind)
    assert tcu.adm_ssq(wt) == jcu.adm_ssq(wj)


@pytest.mark.parametrize('scales', ['log', 'log-piecewise', 'linear'])
def test_process_scales_and_ssq_freqs(scales):
    N = 1000
    spec = ('gmw', {'dtype': 'float32'})
    wj, wt = jwav.Wavelet(spec, N=N), twav.Wavelet(spec, N=N)
    sj, tj, naj, nvj = jcu.process_scales(scales, N, wj, nv=16,
                                          get_params=True)
    st_, tt, nat, nvt = tcu.process_scales(scales, N, wt, nv=16,
                                           get_params=True)
    assert np.array_equal(st_, sj) and (tt, nat) == (tj, naj)
    assert np.array_equal(np.asarray(nvt), np.asarray(nvj))
    ssq_type = 'linear' if scales == 'linear' else scales
    fj = jsq._compute_associated_frequencies(sj, N, wj, ssq_type, 'peak')
    ft = tsq._compute_associated_frequencies(st_, N, wt, ssq_type, 'peak')
    assert np.array_equal(ft, fj)
    # array specs classify identically (the bench passes arrays)
    assert tcu.infer_scaletype(st_)[0] == jcu.infer_scaletype(sj)[0]


def test_scalebounds_and_downsampling_scale():
    wj, wt = jwav.Wavelet('gmw'), twav.Wavelet('gmw')
    for preset in ('maximal', 'minimal', 'naive'):
        assert tcu.cwt_scalebounds(wt, 4096, preset=preset) == \
            jcu.cwt_scalebounds(wj, 4096, preset=preset)
    scales = 2 ** (np.arange(40, 300) / 32)
    # the JAX package's native scan and the port's Python scan agree
    assert tcu.find_downsampling_scale(wt, scales) == \
        jcu.find_downsampling_scale(wj, scales)
    assert np.array_equal(tcu.nv_from_scales(scales),
                          jcu.nv_from_scales(scales))


def _freq_grids():
    lin = np.linspace(0.01, 0.45, 40)
    log = np.geomspace(0.01, 0.45, 40)
    pw = np.hstack([np.geomspace(0.01, 0.05, 20)[:-1],
                    np.geomspace(0.05, 0.45, 21)])
    return {'lin': (lin, False), 'log': (log, True),
            'log-piecewise': (pw, True)}


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
@pytest.mark.parametrize('mode', ['lin', 'log', 'log-piecewise'])
def test_bin_params_and_compute_bins(mode, dtype):
    freqs, logscale = _freq_grids()[mode]
    pj = jssq.ssq_bin_params(freqs, logscale)
    pt = tssq.ssq_bin_params(freqs, logscale)
    assert pt == pj and pt['mode'] == mode
    rng = np.random.default_rng(2)
    w = np.abs(rng.standard_normal(5000) * 0.2).astype(dtype)
    w[:7] = [np.inf, 0., freqs[0], freqs[-1], 10., 1e-9, np.nan]
    for flipud in (False, True):
        kj, vj = jssq.compute_bins(jnp.asarray(w), pj, flipud)
        kt, vt = tssq.compute_bins(torch.from_numpy(w), pt, flipud)
        assert np.array_equal(vt.numpy(), np.asarray(vj))
        assert kt.dtype == torch.int32
        assert np.array_equal(kt.numpy(), np.asarray(kj))


def test_natural_bins_and_piecewise_grid():
    N = 2048
    spec = ('gmw', {'dtype': 'float32'})
    wj, wt = jwav.Wavelet(spec, N=N), twav.Wavelet(spec, N=N)
    scales = jcu.process_scales('log-piecewise', N, wj, nv=8)
    assert jcu.logscale_transition_idx(scales) is not None
    fj = jsq._compute_associated_frequencies(scales, N, wj, 'log-piecewise',
                                             'peak')
    ft = tsq._compute_associated_frequencies(scales, N, wt, 'log-piecewise',
                                             'peak')
    assert np.array_equal(ft, fj)
    params = tssq.ssq_bin_params(ft, True)
    for flipud in (False, True):
        nt = tsq._natural_bins('cwt', scales, ft, params, flipud,
                               len(scales), 1.)
        nj = jsq._natural_bins('cwt', scales, fj, params, flipud,
                               len(scales), 1.)
        assert np.array_equal(nt, nj)
    for args in (('sum', 'peak', wt, 'trig'),
                 ('abs', 'maximal', None, None),
                 ('lebesgue', (0.1, 0.4), None, 'numeric', None, True)):
        assert tsq._check_ssqueezing_args(*args) == \
            jsq._check_ssqueezing_args(*args)
    with pytest.raises(ValueError):
        tsq._check_ssqueezing_args('sum', difftype='phase', get_w=False)
