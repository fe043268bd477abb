# -*- coding: utf-8 -*-
"""The port's wavelets against the JAX package's, on the CPU: morlet, bump
(om = 0 and om != 0), cmhat, hhhat (mu >= 0 and mu < 0), GMW of order 1
and 2 (L1 and L2) and a user's callable (a torch fn for the port, its jnp
twin for the JAX package): the spectral fn on a grid through numpy and
torch, the time-frequency properties, `center_frequency` of three kinds,
`freq_resolution`, `time_resolution`, the GMW utilities (`compute_gmw`,
`morsewave`, `morsefreq`, `laguerre`, `morseafun`), `process_scales`, and
the derivative tables of the second-order transforms against the JAX
package's `_wavelet_grad_fns`; the table of the order-0 GMW by autograd
against its closed form; two callables of one name.

Tolerances: float64 values within 1e-12 of their max (the same numpy
arithmetic; 1e-9 for the derivative tables, whose autograd and `jax.grad`
differ in the order of products), float32 within 1e-5 of max; host
properties within 1e-9 relative; the scales equal to 1e-12.
"""
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import ssqueezepy_tpu as jstq
from ssqueezepy_tpu.models import gmw as jgmw
from ssqueezepy_tpu.models.ssq_cwt2 import _wavelet_grad_fns
from ssqueezepy_tpu.models.wavelets import Wavelet as JWavelet
from ssqueezepy_tpu.utils import cwt_utils as jcwt_utils

import ssqueezepy_tpu_torch as tstq
from ssqueezepy_tpu_torch.models import gmw as tgmw
from ssqueezepy_tpu_torch.models.cwt import resolve_wavelet
from ssqueezepy_tpu_torch.models.wavelets import Wavelet as TWavelet
from ssqueezepy_tpu_torch.ops.cwt_cuda import (_wavelet_derivatives,
                                               wavelet_table, wsst2_rows)
from ssqueezepy_tpu_torch.utils import cwt_utils as tcwt_utils
from torch_jax_reference import xla_reference  # noqa: F401


def gauss4_t(w):
    """A user's wavelet: a real Gaussian bump at w = 4 (torch)."""
    return torch.exp(-(w - 4.) ** 2) * (w > 0)


def gauss4_j(w):
    """The same wavelet in jnp (the JAX package's custom callable)."""
    return jnp.exp(-(w - 4.) ** 2) * (w > 0)


gauss4_j.__name__ = 'gauss4_t'      # one name, as the two packages see it

# the wavelets of this slice; 'custom' is the Gaussian above
SPECS = {
    'morlet': 'morlet', 'bump': 'bump', 'bump_om1': ('bump', {'om': 1.}),
    'cmhat': 'cmhat', 'hhhat': 'hhhat', 'hhhat_neg': ('hhhat', {'mu': -.1}),
    'gmw1': ('gmw', {'order': 1}),
    'gmw2_l2': ('gmw', {'order': 2, 'norm': 'energy'}),
    'custom': 'custom'}
REAL = [k for k in SPECS if k != 'bump_om1']


def _pair(name, dtype=None):
    """(port Wavelet, JAX Wavelet) of SPECS[name] in `dtype`."""
    spec = SPECS[name]
    if spec == 'custom':
        return (TWavelet(gauss4_t, dtype=dtype),
                JWavelet(gauss4_j, dtype=dtype))
    if dtype is not None:
        spec = (spec, {}) if isinstance(spec, str) else spec
        spec = (spec[0], dict(spec[1], dtype=dtype))
    return TWavelet(spec), JWavelet(spec)


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * np.abs(b).max()


GRID = np.concatenate([np.linspace(-5., 30., 1999), [0., 4.999]])


@pytest.mark.parametrize('name', list(SPECS))
def test_fn_values(name):
    """psih on a grid: numpy (host plan) and torch in float64 within 1e-12
    of max, torch in float32 within 1e-5, against the JAX package's fn."""
    tw, jw = _pair(name)
    if name != 'custom':
        _close(tw.fn(GRID, xp=np), jw.fn(GRID, xp=np), 1e-12)
    for dtype, tol in (('float64', 1e-12), ('float32', 1e-5)):
        t = tw.fn(torch.as_tensor(GRID, dtype=getattr(torch, dtype)),
                  xp=torch)
        j = jw.fn(jnp.asarray(GRID, dtype=dtype), xp=jnp)
        if isinstance(j, tuple):
            assert isinstance(t, tuple)
            for a, b in zip(t, j):
                assert a.dtype == getattr(torch, dtype)
                _close(a.numpy(), np.asarray(b), tol)
        else:
            assert t.dtype == getattr(torch, dtype)
            _close(t.numpy(), np.asarray(j), tol)
    _close(tw.evaluate_np(GRID), jw.evaluate_np(GRID), 1e-12)


@pytest.mark.parametrize('name', REAL)
def test_properties(name):
    """The time-frequency properties and names: within 1e-9 relative."""
    tw, jw = _pair(name)
    assert tw.name == jw.name and tw.config_str == jw.config_str
    for prop in ('wc', 'wc_ct', 'scalec_ct', 'std_t', 'std_w', 'std_f',
                 'harea', 'std_t_d', 'std_w_d', 'std_f_d'):
        a, b = getattr(tw, prop), getattr(jw, prop)
        assert abs(a - b) <= 1e-9 * abs(b), (prop, a, b)


@pytest.mark.parametrize('name', ['morlet', 'hhhat', 'gmw1', 'custom'])
def test_center_frequency_and_resolutions(name):
    """`center_frequency` of each kind, `freq_resolution` and
    `time_resolution` at a scale and N of their own: within 1e-9."""
    tw, jw = _pair(name)
    for kind in ('energy', 'peak', 'peak-ct'):
        scale = None if kind == 'peak-ct' else 7.
        a = tstq.center_frequency(tw, scale=scale, N=512, kind=kind)
        b = jstq.center_frequency(jw, scale=scale, N=512, kind=kind)
        assert abs(a - b) <= 1e-9 * abs(b), kind
    for fn_t, fn_j in ((tstq.freq_resolution, jstq.freq_resolution),
                       (tstq.time_resolution, jstq.time_resolution)):
        for nondim in (True, False):
            a = fn_t(tw, scale=12., N=1024, nondim=nondim)
            b = fn_j(jw, scale=12., N=1024, nondim=nondim)
            assert abs(a - b) <= 1e-9 * abs(b)


def test_gmw_utilities():
    """`compute_gmw` (orders 0-2, both norms, centered, with time),
    `morsewave` (a family of three at two frequencies, one negative),
    `morsefreq` (all four measures), `laguerre`, `morseafun`:
    within 1e-12 of max."""
    for order in (0, 1, 2):
        for norm in ('bandpass', 'energy'):
            for centered in (False, True):
                kw = dict(gamma=3, beta=20, norm=norm, order=order,
                          centered_scale=centered, time=True)
                a = tgmw.compute_gmw(512, 4., **kw)
                b = jgmw.compute_gmw(512, 4., **kw)
                for u, v in zip(a, b):
                    _close(u, v, 1e-12)
    for beta, norm in ((20, 'bandpass'), (8, 'energy')):
        a = tstq.morsewave(256, [1., -2.], gamma=3, beta=beta, K=3,
                           norm=norm)
        b = jstq.morsewave(256, [1., -2.], gamma=3, beta=beta, K=3,
                           norm=norm)
        for u, v in zip(a, b):
            _close(u, v, 1e-12)
    _close(tstq.morsefreq(3, 60, n_out=4), jstq.morsefreq(3, 60, n_out=4),
           1e-12)
    x = np.linspace(0, 20, 101)
    _close(tgmw.laguerre(x, 3, 2.5), jgmw.laguerre(x, 3, 2.5), 1e-12)
    for k, norm in ((1, 'bandpass'), (2, 'energy')):
        assert np.isclose(tgmw.morseafun(3, 60, k, norm),
                          jgmw.morseafun(3, 60, k, norm), rtol=1e-12)


@pytest.mark.parametrize('name', REAL)
def test_process_scales(name):
    """The wavelet's own scales ('log-piecewise', 'log', 'linear') equal
    the JAX package's, and so do their bounds (`find_max_scale`,
    `cwt_scalebounds`) and the admissibility constants."""
    tw, jw = _pair(name)
    assert np.isclose(tcwt_utils.find_max_scale(tw, 2048),
                      jcwt_utils.find_max_scale(jw, 2048), rtol=1e-12)
    _close(tcwt_utils.cwt_scalebounds(tw, 2048),
           jcwt_utils.cwt_scalebounds(jw, 2048), 1e-12)
    for st in ('log-piecewise', 'log', 'linear'):
        if name == 'hhhat_neg' and st != 'log-piecewise':
            continue
        a = tstq.process_scales(st, 2048, tw, nv=16)
        b = jstq.process_scales(st, 2048, jw, nv=16)
        _close(a, b, 1e-12)
    assert np.isclose(tstq.adm_ssq(tw), jstq.adm_ssq(jw), rtol=1e-9)
    assert np.isclose(tstq.adm_cwt(tw), jstq.adm_cwt(jw), rtol=1e-9)


@pytest.mark.parametrize('name', REAL + ['gmw0', 'gmw0_l2'])
def test_derivative_tables_vs_jax_grad(name):
    """psih, psih' and psih'' of the table (closed form for the order-0
    GMW, torch autograd otherwise) against the JAX package's
    `_wavelet_grad_fns` on a grid of w >= 0 in float64: the same
    non-finite cells, finite ones within 1e-9 of max."""
    if name.startswith('gmw0'):
        spec = ('gmw', {'norm': 'energy' if name.endswith('l2') else
                        'bandpass'})
        tw, jw = TWavelet(spec), JWavelet(spec)
    else:
        tw, jw = _pair(name)
    w = np.linspace(0., 25., 2001)
    t = _wavelet_derivatives(tw.fn, torch.as_tensor(w))
    j = [np.asarray(g(jnp.asarray(w))) for g in _wavelet_grad_fns(jw)]
    for a, b in zip(t, j):
        a = a.numpy()
        fin = np.isfinite(b)
        assert np.array_equal(np.isfinite(a), fin)
        _close(a[fin], b[fin], 1e-9)


@pytest.mark.parametrize('order2', [False, True])
def test_plain_table_gmw0_vs_closed_form(order2):
    """The plain path fed the order-0 GMW through its table (its fn
    wrapped as a user's callable: derivatives by autograd) against the
    closed-form GMW, float64: within 1e-12 of max."""
    N = 1000
    gmw = resolve_wavelet(('gmw', {'dtype': 'float64'}))
    fn = gmw.fn
    twin = TWavelet(lambda w: fn(w), dtype='float64')
    sc = torch.as_tensor(tstq.process_scales('log-piecewise', N, gmw)
                         .ravel())
    n_up = 2048
    xh = torch.fft.rfft(torch.as_tensor(
        np.random.default_rng(5).standard_normal(n_up)))
    for a, b in zip(wavelet_table(twin, sc, n_up, order2),
                    wavelet_table(gmw, sc, n_up, order2)):
        _close(a.numpy(), b.numpy(), 1e-12)
    if order2:
        got = wsst2_rows(xh, sc, twin, n_up, 500, N, 1., 1e-12)
        ref = wsst2_rows(xh, sc, gmw, n_up, 500, N, 1., 1e-12)
        _close(got[0].numpy(), ref[0].numpy(), 1e-12)
        fin = np.isfinite(ref[1].numpy())
        assert np.array_equal(np.isfinite(got[1].numpy()), fin)
    else:
        from ssqueezepy_tpu_torch.models.cwt import cwt_core
        got = cwt_core(xh, twin, sc, n_up, 500, N, 1., True, True)
        ref = cwt_core(xh, gmw, sc, n_up, 500, N, 1., True, True)
        for a, b in zip(got, ref):
            _close(a.numpy(), b.numpy(), 1e-12)


def test_callables_of_one_name_are_two_wavelets(tmp_path):
    """Two different callables of the same `__name__` give different
    transforms (each its own plan and table), and no plan of either
    reaches the plan memo on disk."""
    f1 = lambda w: torch.exp(-(w - 4.) ** 2) * (w > 0)   # noqa: E731
    f2 = lambda w: torch.exp(-(w - 6.) ** 2) * (w > 0)   # noqa: E731
    assert f1.__name__ == f2.__name__
    x = np.random.default_rng(1).standard_normal(1024).astype(np.float32)
    cache = os.environ['SSQ_TPU_TORCH_CACHE']
    out1 = tstq.ssq_cwt(x, f1, device='cpu')
    out2 = tstq.ssq_cwt(x, f2, device='cpu')
    assert not np.array_equal(out1[3], out2[3])     # their own scales
    W1, _ = tstq.cwt(x, f1, scales=out1[3], device='cpu')
    W2, _ = tstq.cwt(x, f2, scales=out1[3], device='cpu')
    assert not torch.allclose(W1, W2)
    assert torch.equal(W1, tstq.cwt(x, f1, scales=out1[3],
                                    device='cpu')[0])
    assert not os.path.exists(cache) or not os.listdir(cache)
    tstq.ssq_cwt(x, 'cmhat', device='cpu')     # a named one does
    assert os.listdir(cache)


def test_fresh_callables_leave_no_cache_entries():
    """A sweep of fresh lambdas through `cwt`, `ssq_cwt` and `ssq_cwt2`
    adds no entry to any process-wide cache (wavelets, scales, plans,
    device plans, the order-2 gate, wavelet tables), and none of the
    lambdas outlives its calls."""
    import gc
    import weakref
    from ssqueezepy_tpu_torch.models import (cwt as tcwt, ssq_cwt as tssq,
                                             ssq_cwt2 as tssq2)
    from ssqueezepy_tpu_torch.ops import cwt_cuda
    caches = (tcwt._WAVELET_CANON, tcwt._SPEC_WAVELET_CACHE,
              tcwt._SCALES_CACHE, tssq._PLAN_CACHE, tssq._DEV_CACHE,
              tssq2._SUPPORTS2, cwt_cuda._TABLES)
    x = np.random.default_rng(2).standard_normal(512).astype(np.float32)
    sizes = [len(c) for c in caches]
    refs = []
    for mu in (3., 4., 5., 6.):
        f = lambda w, mu=mu: torch.exp(-(w - mu) ** 2) * (w > 0)  # noqa
        refs.append(weakref.ref(f))
        tstq.cwt(x, f, device='cpu')
        tstq.cwt(x, f, scales=2 ** (1 + np.arange(64) / 32), device='cpu')
        tstq.ssq_cwt(x, f, device='cpu')
        tstq.ssq_cwt2(x, f, device='cpu')
        del f
    assert [len(c) for c in caches] == sizes
    gc.collect()
    assert all(r() is None for r in refs)


def test_viz_raises_naming_a12():
    with pytest.raises(NotImplementedError, match='A12'):
        TWavelet('morlet').viz()


def test_wavelet_call_and_psifn():
    """`Wavelet.__call__` on a grid (halved Nyquist) and `psifn` against
    the JAX package's."""
    for name in ('morlet', 'gmw1'):
        tw, jw = _pair(name, 'float64')
        a = tw(scale=np.array([2., 5.]), N=64, nohalf=False)
        b = jw(scale=np.array([2., 5.]), N=64, nohalf=False)
        _close(a.numpy(), np.asarray(b), 1e-12)
        _close(tw.psifn(scale=3., N=128), jw.psifn(scale=3., N=128), 1e-12)
