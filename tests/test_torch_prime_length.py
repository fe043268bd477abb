# -*- coding: utf-8 -*-
"""The CWT family at lengths the CWT kernel does not take: `padtype=None`
at an N with a prime factor above 7 (1031, a prime; 1034 = 2 11 47). The
port routes such a length before anything runs (`ops/cwt_cuda.py::
kernel_length`) to its general path: `models/cwt.py::cwt_general`
(torch.fft) then the fused reassignment (B4) or the phase transform and
the generic scatter (B5) for `ssq_cwt` and `cwt`, and `models/
ssq_cwt2.py::wsst2_general` (the torch WSST2 rows) then B5 for
`ssq_cwt2`, as the JAX package's XLA branch runs them (`cwt_core`,
`_wsst2_rows`). Held here on `device='cpu'` (the plain versions) against
the JAX package on the CPU, with each route's counter read.

Tolerances: Wx, dWx and w2's W within 1e-5 of their max in float32 and
1e-9 in float64; Tx by the bins criterion in float32 (column sums within
1e-4 of max, energy within 5e-3) and within 1e-9 of max in float64; the
phase planes w (and w2) on cells finite in both within 1e-5 of their max
(float32; 1e-9 in float64), their inf cells the same but on at most 0.1%
of cells in float32 (|Wx| at the gate). A float32 w from a derivative
('trig' w = Im(dWx / Wx) / 2 pi, 'numeric', order 2's w2) carries the
FFTs' rounding divided by |Wx|, which reaches 2e-3 of max where |Wx| is
small (the float64 planes agree to 1e-9), so it is held weighted by
|Wx|^2, as the reassignment weighs it; 'phase' w by its max.
"""
import numpy as np
import pytest

import ssqueezepy_tpu as jstq

import ssqueezepy_tpu_torch as tstq
from ssqueezepy_tpu_torch.models.cwt import cwt_general
from ssqueezepy_tpu_torch.models.ssq_cwt2 import wsst2_general
from ssqueezepy_tpu_torch.ops import cwt_cuda
from torch_jax_reference import xla_reference  # noqa: F401

TOL = {'float32': 1e-5, 'float64': 1e-9}
LENGTHS = [1031, 1034]


def _noise(N, dtype, B=None):
    shape = (B, N) if B else N
    return np.random.default_rng(N).standard_normal(shape).astype(dtype)


def _np(c):
    if hasattr(c, 're'):
        return np.asarray(c.re) + 1j * np.asarray(c.im)
    return np.asarray(c)


def _rel(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
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


def _w_close(w_t, w_j, dtype, Wx=None):
    """The phase planes: the same inf cells (float32: on all but 0.1%);
    on cells finite in both, within TOL of max, or with `Wx` (a float32
    w from a derivative, whose error at a cell grows as 1 / |Wx|)
    weighted by |Wx|^2: sum |Wx|^2 |dw| <= TOL sum |Wx|^2 |w|."""
    w_t, w_j = _np(w_t), _np(w_j)
    assert w_t.shape == w_j.shape
    inf_t, inf_j = np.isinf(w_t), np.isinf(w_j)
    assert (inf_t != inf_j).mean() <= (0 if dtype == 'float64' else 1e-3)
    both = ~inf_t & ~inf_j
    dw = np.abs(w_t[both] - w_j[both])
    if Wx is None:
        assert dw.max() <= TOL[dtype] * np.abs(w_j[both]).max()
        return
    e = np.abs(_np(Wx))[both] ** 2
    assert (e * dw).sum() <= TOL[dtype] * (e * np.abs(w_j[both])).sum()


def _both(fn, x, dtype, **kw):
    kw = dict(wavelet=('gmw', {'dtype': dtype}), astensor=False,
              padtype=None, nv=16, **kw)
    return (getattr(tstq, fn)(x, device='cpu', **kw),
            getattr(jstq, fn)(x, **kw))


def _counted(fn):
    """(fn's result, calls of cwt_general, calls of wsst2_general)."""
    c0, w0 = cwt_general.calls, wsst2_general.calls
    out = fn()
    return out, cwt_general.calls - c0, wsst2_general.calls - w0


ROUTES = {
    'sum': dict(), 'lebesgue': dict(squeezing='lebesgue'),
    'get_dWx': dict(get_dWx=True), 'get_w-trig': dict(get_w=True),
    'get_w-phase': dict(get_w=True, difftype='phase'),
    'numeric': dict(get_w=True, difftype='numeric', difforder=4),
    'batch': dict(batch=True),
}


@pytest.mark.parametrize('N', LENGTHS)
@pytest.mark.parametrize('route', list(ROUTES))
def test_ssq_cwt_prime_length_vs_jax(route, N):
    """`ssq_cwt(padtype=None)` off the kernel's lengths, float32: one
    `cwt_general` call, then B4 ('sum') or the phase transform and B5."""
    kw = dict(ROUTES[route])
    x = _noise(N, 'float32', B=2 if kw.pop('batch', False) else None)
    (out_t, out_j), n_gen, n_w2 = _counted(
        lambda: _both('ssq_cwt', x, 'float32', **kw))
    assert (n_gen, n_w2) == (1, 0)
    assert len(out_t) == len(out_j)
    for a, b in zip(out_t, out_j):
        assert np.shape(a) == np.shape(b)
    assert np.array_equal(out_t[2], out_j[2])
    assert np.array_equal(out_t[3], out_j[3])
    assert _rel(out_t[1], out_j[1]) <= TOL['float32']
    if x.ndim == 2:
        for b in range(2):
            _tx_close(out_t[0][b], out_j[0][b], 'float32')
    else:
        _tx_close(out_t[0], out_j[0], 'float32')
    if route == 'get_dWx':
        assert _rel(out_t[4], out_j[4]) <= TOL['float32']
    if kw.get('get_w'):
        _w_close(out_t[4], out_j[4], 'float32',
                 None if kw.get('difftype') == 'phase' else out_j[1])


@pytest.mark.parametrize('N', LENGTHS)
def test_ssq_cwt_prime_length_float64(N):
    """float64 with `get_w` and `get_dWx`: every plane within 1e-9."""
    (out_t, out_j), n_gen, _ = _counted(lambda: _both(
        'ssq_cwt', _noise(N, 'float64'), 'float64', get_w=True,
        get_dWx=True))
    assert n_gen == 1
    _tx_close(out_t[0], out_j[0], 'float64')
    for i in (1, 5):
        assert _rel(out_t[i], out_j[i]) <= TOL['float64']
    _w_close(out_t[4], out_j[4], 'float64')


@pytest.mark.parametrize('N', LENGTHS)
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_cwt_prime_length_vs_jax(dtype, N):
    """`cwt(padtype=None)` with dWx, and on a (2, N) batch."""
    (out_t, out_j), n_gen, _ = _counted(lambda: _both(
        'cwt', _noise(N, dtype), dtype, derivative=True))
    assert n_gen == 1
    assert out_t[0].shape == (len(out_j[1]), N)
    assert np.array_equal(out_t[1], out_j[1])
    assert _rel(out_t[0], out_j[0]) <= TOL[dtype]
    assert _rel(out_t[2], out_j[2]) <= TOL[dtype]
    out_t, out_j = _both('cwt', _noise(N, dtype, B=2), dtype)
    assert _rel(out_t[0], out_j[0]) <= TOL[dtype]


@pytest.mark.parametrize('N', LENGTHS)
@pytest.mark.parametrize('kw', [dict(), dict(get_w=True),
                                dict(batch=True),
                                dict(dtype='float64', get_w=True)],
                         ids=['sum', 'get_w', 'batch', 'float64-get_w'])
def test_ssq_cwt2_prime_length_vs_jax(kw, N):
    """`ssq_cwt2(padtype=None)`: one `wsst2_general` call (no CWT kernel
    and no `cwt_general`), then B5 by the bins of w2."""
    kw = dict(kw)
    dtype = kw.pop('dtype', 'float32')
    x = _noise(N, dtype, B=2 if kw.pop('batch', False) else None)
    (out_t, out_j), n_gen, n_w2 = _counted(
        lambda: _both('ssq_cwt2', x, dtype, **kw))
    assert (n_gen, n_w2) == (0, 1)
    assert len(out_t) == len(out_j)
    assert _rel(out_t[1], out_j[1]) <= TOL[dtype]
    if x.ndim == 2:
        for b in range(2):
            _tx_close(out_t[0][b], out_j[0][b], dtype)
    else:
        _tx_close(out_t[0], out_j[0], dtype)
    if kw.get('get_w'):
        _w_close(out_t[4], out_j[4], dtype,
                 out_j[1] if dtype == 'float32' else None)


def test_route_decided_by_length():
    """`kernel_length` decides the route before anything runs: 7-smooth
    n_up >= 4 only; `cwt_length_rule` and `four_step` still raise on the
    others when called directly, naming the general path."""
    for n in (4, 7, 2048, 3000, 4725, 160000, 262144):
        assert cwt_cuda.kernel_length(n)
    for n in (1, 2, 3, 11, 1031, 1034, 2002, 160001):
        assert not cwt_cuda.kernel_length(n)
        with pytest.raises(NotImplementedError, match='general path'):
            cwt_cuda.cwt_length_rule(n, 8, 2)
