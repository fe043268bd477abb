# -*- coding: utf-8 -*-
"""The transforms with every wavelet, the port (device='cpu': the plain
versions of the CWT kernel's table modes, `cwt_general`, the plain
reassignments) against the JAX package on the CPU: `cwt` (padded,
`padtype=None` at a 7-smooth N, `derivative`, a (2, N) batch,
`vectorized=False`, `rpadded`), `cwt(order=1)` and `cwt(order=(0, 1, 2))`
with and without `average`, `trigdiff`, `ssq_cwt` ('sum', 'lebesgue',
`get_w`, `get_dWx`; `order=1` and `order=(0, 1)`), `ssq_cwt2` (and
`get_w`), `icwt` and `issq_cwt`; the routes each call takes (the table
modes, or `cwt_general`) by their counters; `ssq_cwt2` raising the JAX
package's message for a wavelet its gate rejects.

Wavelets: morlet, bump (om = 0; om = 1 and a non-analytic one with array
scales), cmhat, hhhat (mu >= 0 and mu < 0), GMW of order 1 (L1) and 2
(L2), and a user's callable (a torch fn for the port, its jnp twin for
the JAX package, of one name).

Tolerances: Wx, dWx and trigdiff within 1e-5 of their max in float32 and
1e-9 in float64; Tx by the bins criterion (column sums within 1e-4 of
max, energy within 5e-3) in float32 and within 1e-9 of max in float64
(the order-2 bins criterion for `ssq_cwt2` in float32); w on the same
gated cells; round trips `mad_rms < 0.1`.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import ssqueezepy_tpu as jstq

import ssqueezepy_tpu_torch as tstq
from ssqueezepy_tpu_torch.models import cwt as tcwt
from torch_jax_reference import xla_reference  # noqa: F401

TOL = {'float32': 1e-5, 'float64': 1e-9}


def gauss5_t(w):
    """A user's wavelet: a real Gaussian bump at w = 5 (torch)."""
    return torch.exp(-(w - 5.) ** 2 / 2) * (w > 0)


def gauss5_j(w):
    return jnp.exp(-(w - 5.) ** 2 / 2) * (w > 0)


gauss5_j.__name__ = 'gauss5_t'

SPECS = {
    'morlet': 'morlet', 'bump': 'bump', 'cmhat': 'cmhat', 'hhhat': 'hhhat',
    'hhhat_neg': ('hhhat', {'mu': -.1}), 'gmw1': ('gmw', {'order': 1}),
    'gmw2_l2': ('gmw', {'order': 2, 'norm': 'energy'}), 'custom': None}
# the JAX package's XLA route (`cwt_general` in the port)
GENERAL = {'morlet', 'hhhat_neg', 'custom'}


def _spec(name, dtype=None, jax_side=False):
    if name == 'custom':
        return gauss5_j if jax_side else gauss5_t
    spec = SPECS[name]
    if dtype is None:
        return spec
    spec = (spec, {}) if isinstance(spec, str) else spec
    return (spec[0], dict(spec[1], dtype=dtype))


def _np(c):
    if isinstance(c, torch.Tensor):
        return c.numpy()
    if hasattr(c, 're'):
        return np.asarray(c.re) + 1j * np.asarray(c.im)
    return np.asarray(c)


def _rel(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / np.abs(b).max()


def _tx_close(Tx_t, Tx_j, dtype):
    Tx_t, Tx_j = _np(Tx_t), _np(Tx_j)
    assert Tx_t.shape == Tx_j.shape
    m = np.abs(Tx_j).max()
    if dtype == 'float64':
        assert np.abs(Tx_t - Tx_j).max() <= 1e-9 * m
        return
    assert np.abs(Tx_t.sum(-2) - Tx_j.sum(-2)).max() < 1e-4 * m
    e_t, e_j = np.abs(Tx_t).sum(), np.abs(Tx_j).sum()
    assert abs(e_t - e_j) / e_j < 5e-3


def _noise(N, dtype='float32', seed=0, B=None):
    return np.random.default_rng(seed + N).standard_normal(
        (B, N) if B else N).astype(dtype)


def _routes(fn):
    """(fn's result, {'cwt_general': calls of `cwt_general` it made})."""
    c0 = tcwt.cwt_general.calls
    out = fn()
    return out, {'cwt_general': tcwt.cwt_general.calls - c0}


# ---- cwt -------------------------------------------------------------------
CWT_CASES = [
    ('morlet', {}), ('bump', {}), ('cmhat', {}), ('hhhat', {}),
    ('hhhat_neg', {}), ('gmw1', {}), ('gmw2_l2', {}), ('custom', {}),
    ('cmhat', dict(padtype=None, N=1920)), ('morlet', dict(padtype=None,
                                                           N=1920)),
    ('gmw1', dict(derivative=True)), ('morlet', dict(derivative=True)),
    ('bump', dict(x2d=True)), ('custom', dict(x2d=True, derivative=True)),
    ('hhhat', dict(vectorized=False, derivative=True)),
    ('morlet', dict(vectorized=False)), ('cmhat', dict(rpadded=True)),
    ('morlet', dict(dtype='float64', derivative=True)),
    ('gmw1', dict(dtype='float64', x2d=True)),
    ('hhhat_neg', dict(dtype='float64', l1_norm=False)),
    ('custom', dict(dtype='float64'))]


@pytest.mark.parametrize('name,case', CWT_CASES,
                         ids=['%s-%s' % (n, '-'.join(sorted(c)) or 'default')
                              for n, c in CWT_CASES])
def test_cwt_vs_jax(name, case):
    case = dict(case)
    dtype = case.pop('dtype', 'float32')
    N = case.pop('N', 1000)
    x = _noise(N, dtype, B=2 if case.pop('x2d', False) else None)
    spec_t = _spec(name, dtype if name != 'custom' else None)
    spec_j = _spec(name, dtype if name != 'custom' else None, True)
    if name == 'custom' and dtype == 'float64':
        spec_t = tstq.Wavelet(gauss5_t, dtype='float64')
        spec_j = jstq.Wavelet(gauss5_j, dtype='float64')
    out_t, moved = _routes(lambda: tstq.cwt(x, spec_t, device='cpu',
                                            **case))
    out_j = jstq.cwt(x, spec_j, **case)
    assert np.allclose(out_t[1], out_j[1], rtol=1e-12)
    assert _rel(out_t[0], out_j[0]) <= TOL[dtype]
    if case.get('derivative'):
        assert _rel(out_t[2], out_j[2]) <= TOL[dtype]
    assert (moved['cwt_general'] > 0) == (name in GENERAL)


@pytest.mark.parametrize('om,mu', [(1., 5.), (0., .5)])
def test_cwt_complex_and_nonanalytic_bump(om, mu):
    """A complex bump (om = 1: the half spectrum times a complex psih) and
    a non-analytic one (mu = .5: the full spectrum), both through
    `cwt_general`, at given scales (their own scale search finds none, in
    both packages)."""
    x = _noise(1000)
    scales = 2 ** (np.arange(32, 200) / 32)           # 'log' at nv = 32
    spec = ('bump', {'om': om, 'mu': mu})
    (Wt, _, dWt), moved = _routes(lambda: tstq.cwt(
        x, spec, scales=scales, derivative=True, device='cpu'))
    Wj, _, dWj = jstq.cwt(x, spec, scales=scales, derivative=True)
    assert moved['cwt_general'] == 1
    assert _rel(Wt, Wj) <= 1e-5 and _rel(dWt, dWj) <= 1e-5


@pytest.mark.parametrize('order,average', [
    (1, None), (2, None), ((0, 1, 2), True), ((0, 1, 2), False),
    ([0, 1], None)])
def test_cwt_higher_order_vs_jax(order, average):
    """`cwt(order=...)` (`cwt_higher_order`): one transform per order at
    the order-0 GMW's scales, averaged or a list."""
    x = _noise(1000)
    Wt, st = tstq.cwt(x, order=order, average=average, device='cpu')
    Wj, sj = jstq.cwt(x, order=order, average=average)
    assert np.allclose(st, sj, rtol=1e-12)
    if isinstance(Wj, list):
        assert isinstance(Wt, list) and len(Wt) == len(Wj)
        for a, b in zip(Wt, Wj):
            assert _rel(a, b) <= 1e-5
    else:
        assert _rel(Wt, Wj) <= 1e-5


def test_cwt_higher_order_derivative_and_gate():
    """`cwt(order=1, derivative=True)` returns dWx as the JAX package
    does; a wavelet other than GMW raises in both."""
    x = _noise(1000)
    Wd, _, dWd = tstq.cwt(x, order=1, derivative=True, device='cpu')
    Wdj, _, dWdj = jstq.cwt(x, order=1, derivative=True)
    assert _rel(dWd, dWdj) <= 1e-5
    with pytest.raises(ValueError, match='must be GMW'):
        jstq.cwt(x, 'morlet', order=1)
    with pytest.raises(ValueError, match='must be GMW'):
        tstq.cwt(x, 'morlet', order=1, device='cpu')


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_trigdiff_vs_jax(dtype):
    """`trigdiff` of a padded CWT, rpadded (sliced to [n1, n1 + N)) and
    padded by itself, tensor and numpy in, against the JAX package's."""
    x = _noise(1000, dtype)
    spec = ('cmhat', {'dtype': dtype})
    Wt, _ = tstq.cwt(x, spec, rpadded=True, device='cpu')
    Wj, _ = jstq.cwt(x, spec, rpadded=True)
    a = tstq.trigdiff(Wt, fs=2., rpadded=True, N=1000, n1=12)
    b = jstq.trigdiff(Wj, fs=2., rpadded=True, N=1000, n1=12)
    assert _rel(a, b) <= TOL[dtype]
    U = _np(Wj)[:, 300:700]
    c = tstq.trigdiff(U)
    assert isinstance(c, np.ndarray)
    assert _rel(c, jstq.trigdiff(U)) <= TOL[dtype]


# ---- ssq_cwt -----------------------------------------------------------------
SSQ_CASES = [
    ('morlet', {}), ('cmhat', {}), ('hhhat_neg', {}), ('gmw1', {}),
    ('custom', {}), ('bump', dict(x2d=True)),
    ('morlet', dict(squeezing='lebesgue')), ('hhhat', dict(get_w=True)),
    ('morlet', dict(get_w=True)), ('custom', dict(get_dWx=True)),
    ('gmw2_l2', dict(get_dWx=True, squeezing='lebesgue')),
    ('morlet', dict(padtype=None, N=1001)),
    ('gmw1', dict(padtype=None, N=1920, get_w=True)),
    ('morlet', dict(dtype='float64', get_dWx=True)),
    ('cmhat', dict(dtype='float64', get_w=True))]


@pytest.mark.parametrize('name,case', SSQ_CASES,
                         ids=['%s-%s' % (n, '-'.join(sorted(c)) or 'default')
                              for n, c in SSQ_CASES])
def test_ssq_cwt_vs_jax(name, case):
    case = dict(case)
    dtype = case.pop('dtype', 'float32')
    N = case.pop('N', 1000)
    x = _noise(N, dtype, B=2 if case.pop('x2d', False) else None)
    out_t, moved = _routes(lambda: tstq.ssq_cwt(
        x, _spec(name, dtype if name != 'custom' else None), device='cpu',
        **case))
    out_j = jstq.ssq_cwt(x, _spec(name, dtype if name != 'custom' else
                                  None, True), **case)
    assert len(out_t) == len(out_j)
    assert np.allclose(out_t[2], out_j[2], rtol=1e-12)
    assert _rel(out_t[1], out_j[1]) <= TOL[dtype]
    _tx_close(out_t[0], out_j[0], dtype)
    if case.get('get_w'):
        wt, wj = _np(out_t[4]), _np(out_j[4])
        assert (np.isinf(wt) != np.isinf(wj)).mean() <= (
            0 if dtype == 'float64' else 1e-3)
    if case.get('get_dWx'):
        assert _rel(out_t[-1], out_j[-1]) <= TOL[dtype]
    assert (moved['cwt_general'] > 0) == (name in GENERAL)


@pytest.mark.parametrize('order,case', [
    (1, {}), ((0, 1), {}), (1, dict(squeezing='lebesgue', get_dWx=True)),
    ((0, 1), dict(get_w=True)), (2, dict(get_dWx=True)),
    ((0, 1), dict(x2d=True))],
    ids=['1', '0-1', '1-lebesgue-dWx', '0-1-get_w', '2-dWx', '0-1-x2d'])
def test_ssq_cwt_higher_order_vs_jax(order, case):
    """`ssq_cwt(order=...)`: the higher-order CWT over the padded window,
    `trigdiff`, the unpadded slice, then the fused reassignment ('sum') or
    the phase transform and the generic scatter."""
    case = dict(case)
    x = _noise(1000, B=2 if case.pop('x2d', False) else None)
    out_t = tstq.ssq_cwt(x, order=order, device='cpu', **case)
    out_j = jstq.ssq_cwt(x, order=order, **case)
    assert len(out_t) == len(out_j)
    assert _rel(out_t[1], out_j[1]) <= 1e-5
    _tx_close(out_t[0], out_j[0], 'float32')
    if case.get('get_dWx'):
        assert _rel(out_t[-1], out_j[-1]) <= 1e-5
    if case.get('get_w'):
        assert (np.isinf(_np(out_t[4])) != np.isinf(_np(out_j[4]))
                ).mean() <= 1e-3


# ---- ssq_cwt2 ------------------------------------------------------------------
def _bins2_close(Tx_t, Tx_j, dtype):
    Tx_t, Tx_j = _np(Tx_t), _np(Tx_j)
    m = np.abs(Tx_j).max()
    if dtype == 'float64':
        assert np.abs(Tx_t - Tx_j).max() <= 1e-9 * m
        return
    assert np.abs(Tx_t.sum(-2) - Tx_j.sum(-2)).max() < 1e-4 * m
    assert (np.abs(Tx_t - Tx_j) > 1e-3 * m).mean() < 0.02
    e_t, e_j = np.abs(Tx_t).sum(), np.abs(Tx_j).sum()
    assert abs(e_t - e_j) / e_j < 0.02


@pytest.mark.parametrize('name,case', [
    ('morlet', {}), ('cmhat', {}), ('gmw1', {}), ('custom', {}),
    ('hhhat', dict(get_w=True)), ('gmw2_l2', dict(get_w=True)),
    ('morlet', dict(dtype='float64', get_w=True)),
    ('bump', dict(x2d=True))],
    ids=['morlet', 'cmhat', 'gmw1', 'custom', 'hhhat-get_w',
         'gmw2_l2-get_w', 'morlet-float64-get_w', 'bump-x2d'])
def test_ssq_cwt2_vs_jax(name, case):
    """`ssq_cwt2` with every wavelet the JAX package's gate takes: the
    order-2 plain path reads the three-plane table; W within tolerance,
    Tx by the order-2 bins criterion, w2 on the same inf cells."""
    case = dict(case)
    dtype = case.pop('dtype', 'float32')
    x = _noise(1024, dtype, B=2 if case.pop('x2d', False) else None)
    out_t = tstq.ssq_cwt2(x, _spec(name, dtype if name != 'custom' else
                                   None), device='cpu', **case)
    out_j = jstq.ssq_cwt2(x, _spec(name, dtype if name != 'custom' else
                                   None, True), **case)
    assert _rel(out_t[1], out_j[1]) <= TOL[dtype]
    _bins2_close(out_t[0], out_j[0], dtype)
    if case.get('get_w'):
        wt, wj = _np(out_t[4]), _np(out_j[4])
        assert (np.isinf(wt) != np.isinf(wj)).mean() <= (
            0 if dtype == 'float64' else 1e-3)


@pytest.mark.parametrize('spec', [('bump', {'om': 1.}), ('bump',
                                                          {'mu': .5})],
                         ids=['complex', 'nonanalytic'])
def test_ssq_cwt2_rejects_as_jax(spec):
    """A wavelet the JAX package's `_supports_order2` rejects raises its
    message in both packages, before any transform."""
    x = _noise(1000)
    with pytest.raises(NotImplementedError) as ej:
        jstq.ssq_cwt2(x, spec)
    with pytest.raises(NotImplementedError) as et:
        tstq.ssq_cwt2(x, spec, device='cpu')
    assert str(et.value) == str(ej.value)
    assert 'ROADMAP' not in str(et.value)


# ---- inverses --------------------------------------------------------------------
@pytest.mark.parametrize('name', ['morlet', 'cmhat', 'hhhat', 'bump',
                                  'gmw1', 'custom'])
def test_round_trips(name):
    """`icwt` (one and two integrals) and `issq_cwt` with the wavelet:
    against the JAX package's inverse of the same planes (1e-5) and back
    to the chirp (mad_rms < 0.1; the synchrosqueezed inverse of the
    order-1 GMW is not one in either package, 0.49 at this chirp, and is
    held to the JAX package's alone)."""
    N = 2048
    t = np.linspace(0, 6, N, endpoint=False)
    x = np.cos(2 * np.pi * 2 * np.exp(t / 2)).astype(np.float32)
    st, sj = _spec(name), _spec(name, jax_side=True)
    Wx, _ = tstq.cwt(x, st, scales='log', device='cpu')
    xr = tstq.icwt(Wx, st, scales='log')
    assert np.allclose(xr, jstq.icwt(Wx.numpy(), sj, scales='log'),
                       rtol=1e-5, atol=1e-5)
    assert tstq.toolkit.mad_rms(x, xr) < 0.1
    x2 = tstq.icwt(Wx, st, scales='log', one_int=False)
    assert np.allclose(x2, jstq.icwt(Wx.numpy(), sj, scales='log',
                                     one_int=False), rtol=1e-5, atol=1e-5)
    Tx = tstq.ssq_cwt(x, st, device='cpu')[0]
    xs = tstq.issq_cwt(Tx, st)
    assert np.allclose(xs, jstq.issq_cwt(Tx.numpy(), sj), rtol=1e-5,
                       atol=1e-5)
    if name != 'gmw1':
        assert tstq.toolkit.mad_rms(x, xs) < 0.1
