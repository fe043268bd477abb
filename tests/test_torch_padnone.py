# -*- coding: utf-8 -*-
"""The CWT family without padding and on its padded planes: `ssq_cwt`,
`cwt` and `ssq_cwt2` with `padtype=None` (n_up = N), `cwt(rpadded=True)`
and `ssq_cwt(difftype='numeric', get_w=True)`, the port (device='cpu',
i.e. the kernels' plain PyTorch versions) against the JAX package on the
CPU, at lengths whose prime factors are at most 7, even and odd
(3000 = 2^3 3 5^3, 4410 = 2 3^2 5 7^2, 4725 = 3^3 5^2 7) and a power of
two (2048); the plain versions at such an n_up against `np.fft`; the
length rule (a prime factor above 7 takes the general path through the
public calls, and raises naming it where the kernel's rule is called
directly; more in tests/test_torch_prime_length.py); and the plan's
memo on disk.

Tolerances: Wx and dWx within 2e-5 of their max in float32 and 1e-9 in
float64; Tx by the bins criterion in float32 (column sums within 1e-4 of
max, energy within 5e-3) and within 1e-9 of max in float64; the phase
transform w in float64 on the same gated cells and within 1e-6 of its
max elsewhere (and `phase_cwt_num` alone, on the same Wx, in both
dtypes); the plain versions within 1e-12 of `np.fft` in float64.
"""
import numpy as np
import pytest
import torch

import ssqueezepy_tpu as jstq
from ssqueezepy_tpu.ops.phase import phase_cwt_num as jphase_cwt_num

import ssqueezepy_tpu_torch as tstq
from ssqueezepy_tpu_torch.models import ssq_cwt as tssq_cwt
from ssqueezepy_tpu_torch.models.cwt import resolve_wavelet
from ssqueezepy_tpu_torch.models.wavelets import _xifn
from ssqueezepy_tpu_torch.ops.cwt_cuda import (cwt_bins_plain, cwt_fused,
                                               cwt_length_rule, wsst2_rows)
from ssqueezepy_tpu_torch.ops.phase import phase_cwt_num
from ssqueezepy_tpu_torch.ops.ssq_kernels import ssq_bin_params
from torch_jax_reference import xla_reference  # noqa: F401

TOL = {'float32': 2e-5, 'float64': 1e-9}
# (N, dtype): an even length in float32, an odd one in float64
CASES = [(3000, 'float32'), (4725, 'float64')]


def _np(c):
    if isinstance(c, torch.Tensor):
        return c.numpy()
    if hasattr(c, 're'):
        return np.asarray(c.re) + 1j * np.asarray(c.im)
    return np.asarray(c)


def _rel(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    return np.abs(a - b).max() / np.abs(b).max()


def _noise(N, dtype, seed=0, B=None):
    shape = (B, N) if B else N
    return np.random.default_rng(seed + N).standard_normal(shape).astype(
        dtype)


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


def _w_close(w_t, w_j):
    w_t, w_j = _np(w_t), _np(w_j)
    assert w_t.shape == w_j.shape
    inf = np.isinf(w_j)
    assert np.array_equal(np.isinf(w_t), inf)
    assert np.abs(w_t[~inf] - w_j[~inf]).max() <= 1e-6 * np.abs(
        w_j[~inf]).max()


def _both(fn, x, dtype, **kw):
    kw = dict(wavelet=('gmw', {'dtype': dtype}), astensor=False, **kw)
    return (getattr(tstq, fn)(x, device='cpu', **kw),
            getattr(jstq, fn)(x, **kw))


ROUTES = {
    'sum': dict(), 'lebesgue': dict(squeezing='lebesgue'),
    'abs': dict(squeezing='abs'), 'get_dWx': dict(get_dWx=True),
    'get_w-trig': dict(get_w=True),
    'get_w-phase': dict(get_w=True, difftype='phase'),
}


@pytest.mark.parametrize('N,dtype', CASES)
@pytest.mark.parametrize('route', list(ROUTES))
def test_ssq_cwt_padnone_vs_jax(route, N, dtype):
    """`ssq_cwt(padtype=None)` on each route: the port's kernels (B1 + B2,
    B3 + B4, B3 + phase transform + B5) against the JAX package's XLA CWT
    and `ssqueeze_fast` / `indexed_sum_onfly`."""
    kw = dict(ROUTES[route], padtype=None, nv=16)
    out_t, out_j = _both('ssq_cwt', _noise(N, dtype), dtype, **kw)
    assert len(out_t) == len(out_j)
    assert out_t[1].shape == (len(out_j[3]), N)
    assert np.array_equal(out_t[2], out_j[2])
    assert np.array_equal(out_t[3], out_j[3])
    assert _rel(out_t[1], out_j[1]) <= TOL[dtype]
    _tx_close(out_t[0], out_j[0], dtype)
    if route == 'get_dWx':
        assert _rel(out_t[4], out_j[4]) <= TOL[dtype]
    if route.startswith('get_w') and dtype == 'float64':
        _w_close(out_t[4], out_j[4])


@pytest.mark.parametrize('N', [4410, 2048])
def test_ssq_cwt_padnone_lengths(N):
    """Another even 7-smooth length and a power of two, float32."""
    out_t, out_j = _both('ssq_cwt', _noise(N, 'float32'), 'float32',
                         padtype=None, nv=16)
    assert _rel(out_t[1], out_j[1]) <= TOL['float32']
    _tx_close(out_t[0], out_j[0], 'float32')


@pytest.mark.parametrize('route', ['sum', 'lebesgue', 'get_dWx'])
def test_ssq_cwt_padnone_batch_vs_jax(route):
    """A (2, N) batch: B3b + batched B2, or batched B3 + B4 / B5."""
    kw = dict(ROUTES[route], padtype=None, nv=16)
    out_t, out_j = _both('ssq_cwt', _noise(4410, 'float32', B=2),
                         'float32', **kw)
    assert out_t[0].shape == out_j[0].shape and out_t[0].shape[0] == 2
    assert _rel(out_t[1], out_j[1]) <= TOL['float32']
    for b in range(2):
        _tx_close(out_t[0][b], out_j[0][b], 'float32')
    if route == 'get_dWx':
        assert _rel(out_t[4], out_j[4]) <= TOL['float32']


@pytest.mark.parametrize('N,dtype', CASES)
@pytest.mark.parametrize('derivative', [False, True])
@pytest.mark.parametrize('padtype,rpadded', [(None, False), (None, True),
                                             ('reflect', True)])
def test_cwt_padnone_rpadded_vs_jax(padtype, rpadded, derivative, N, dtype):
    """`cwt` unpadded and on its whole padded planes ((na, n_up)), with
    and without dWx."""
    out_t, out_j = _both('cwt', _noise(N, dtype), dtype, padtype=padtype,
                         rpadded=rpadded, derivative=derivative, nv=16)
    n_up = N if padtype is None else jstq.utils.common.p2up(N)[0]
    assert out_t[0].shape == out_j[0].shape == (len(out_j[1]), n_up)
    assert np.array_equal(out_t[1], out_j[1])
    assert _rel(out_t[0], out_j[0]) <= TOL[dtype]
    if derivative:
        assert _rel(out_t[2], out_j[2]) <= TOL[dtype]


@pytest.mark.parametrize('kw', [dict(l1_norm=False, padtype=None),
                                dict(rpadded=True, batch=True),
                                dict(padtype=None, vectorized=False)],
                         ids=['l2-padnone', 'rpadded-batch',
                              'padnone-chunked'])
def test_cwt_padnone_options_vs_jax(kw):
    """The L2 norm, a (2, N) batch and the chunked scales on these
    windows, float32."""
    kw = dict(kw)
    x = _noise(4410, 'float32', B=2 if kw.pop('batch', False) else None)
    out_t, out_j = _both('cwt', x, 'float32', nv=16, **kw)
    assert _rel(out_t[0], out_j[0]) <= TOL['float32']


@pytest.mark.parametrize('difforder,padtype,dtype,extra', [
    (1, 'reflect', 'float64', {}), (2, 'reflect', 'float64', {}),
    (4, 'reflect', 'float64', dict(get_dWx=True)),
    (4, None, 'float64', {}),
    (2, None, 'float32', dict(get_dWx=True, squeezing='abs')),
    (4, 'reflect', 'float32', dict(squeezing='lebesgue')),
])
def test_ssq_cwt_numeric_vs_jax(difforder, padtype, dtype, extra):
    """`difftype='numeric'`: the padded planes of B3, `phase_cwt_num` on
    the window [n1 - 4, n1 + N + 4) of p2up's left pad n1 (with
    `padtype=None` too, as the JAX package slices, which leaves N - n1 - 4
    columns), B5, the 4-column trims; dWx returned padded."""
    N = 3000
    out_t, out_j = _both('ssq_cwt', _noise(N, dtype), dtype, nv=16,
                         get_w=True, difftype='numeric',
                         difforder=difforder, padtype=padtype, **extra)
    assert len(out_t) == len(out_j)
    for a, b in zip(out_t, out_j):
        assert np.shape(a) == np.shape(b)
    if padtype is None:
        assert out_t[0].shape[-1] == N - jstq.utils.common.p2up(N)[1] - 4
    assert _rel(out_t[1], out_j[1]) <= TOL[dtype]
    _tx_close(out_t[0], out_j[0], dtype)
    if dtype == 'float64':
        _w_close(out_t[4], out_j[4])
    if extra.get('get_dWx'):
        n_up = N if padtype is None else jstq.utils.common.p2up(N)[0]
        assert out_t[5].shape[-1] == n_up
        assert _rel(out_t[5], out_j[5]) <= TOL[dtype]


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
@pytest.mark.parametrize('difforder', [1, 2, 4])
def test_phase_cwt_num_vs_jax(difforder, dtype):
    """`phase_cwt_num` alone on one Wx, with cells below gamma planted:
    the same gated cells, the rest within 1e-6 of max."""
    rng = np.random.default_rng(difforder)
    cdt = np.complex64 if dtype == 'float32' else np.complex128
    Wx = (rng.standard_normal((5, 64)) + 1j * rng.standard_normal((5, 64))
          ).astype(cdt)
    Wx[1, 10:14] = 0
    Wx[3, 20] = 1e-9
    w_t = phase_cwt_num(torch.from_numpy(Wx), 0.5, difforder)
    w_j = jphase_cwt_num(Wx, 0.5, difforder)
    assert w_t.dtype == (torch.float32 if dtype == 'float32'
                         else torch.float64)
    assert np.isinf(_np(w_t)[1, 10:14]).all()
    _w_close(w_t, w_j)
    with pytest.raises(ValueError):
        phase_cwt_num(torch.from_numpy(Wx), 0.5, 3)


@pytest.mark.parametrize('N,dtype,B', [(3000, 'float32', None),
                                       (4725, 'float64', None),
                                       (4410, 'float32', 2)])
def test_ssq_cwt2_padnone_vs_jax(N, dtype, B):
    """`ssq_cwt2(padtype=None)`: B8 on the unpadded spectrum, then B2,
    against the JAX package's `_wsst2_rows` and scatter; the plan built
    with `was_padded=False`, as the JAX package builds it."""
    out_t, out_j = _both('ssq_cwt2', _noise(N, dtype, B=B), dtype,
                         padtype=None, nv=16)
    assert np.array_equal(out_t[2], out_j[2])
    assert _rel(out_t[1], out_j[1]) <= TOL[dtype]
    if B:
        for b in range(B):
            _tx_close(out_t[0][b], out_j[0][b], dtype)
    else:
        _tx_close(out_t[0], out_j[0], dtype)


@pytest.mark.parametrize('n_up', [3000, 4410, 4725])
def test_plain_versions_at_a_mixed_n_up(n_up):
    """The kernels' plain versions at a 7-smooth n_up against `np.fft`
    (float64): Wx and dWx of B3, Wx of B1 and W of B8 from the half
    spectrum, the Nyquist bin halved only when n_up is even."""
    x = np.random.default_rng(n_up).standard_normal(n_up)
    wav = resolve_wavelet(('gmw', {'dtype': 'float64'}), N=n_up)
    scales = np.array([1.5, 4., 17., 60.])
    half = n_up // 2 + 1
    xh = np.fft.rfft(x)
    xi = _xifn(1., n_up)[:half]
    psih = np.asarray(wav.fn(torch.as_tensor(scales[:, None] * xi),
                             xp=torch))
    if n_up % 2 == 0:
        psih[:, -1] /= 2
    spec = np.zeros((len(scales), n_up), complex)
    spec[:, :half] = psih * xh
    n1, N = n_up // 5, n_up - n_up // 5 - 7
    want = np.fft.ifft(spec)[:, n1:n1 + N]
    dwant = np.fft.ifft(spec * np.pad(1j * xi / 2., (0, n_up - half))
                        )[:, n1:n1 + N]
    xh_t, sc = torch.as_tensor(xh), torch.as_tensor(scales)
    Wx, dWx = cwt_fused(xh_t, sc, wav, n_up, n1, N, 2., True, True)
    m = np.abs(want).max()
    assert np.abs(Wx.numpy() - want).max() <= 1e-12 * m
    assert np.abs(dWx.numpy() - dwant).max() <= 1e-12 * np.abs(dwant).max()
    params = ssq_bin_params(np.linspace(.01, .45, 32), False)
    Wb, _ = cwt_bins_plain(xh_t, sc, wav, n_up, n1, N, 2., True, params,
                           1e-12, False)
    W8, _ = wsst2_rows(xh_t, sc, wav, n_up, n1, N, 2., 1e-12)
    assert np.abs(Wb.numpy() - want).max() <= 1e-12 * m
    assert np.abs(W8.numpy() - want).max() <= 1e-12 * m


@pytest.mark.parametrize('fn', ['ssq_cwt', 'cwt', 'ssq_cwt2'])
def test_length_rule_names_a6b(fn):
    """A length with a prime factor above 7 (2002 = 2 7 11 13) runs the
    general path unpadded (`cwt_general` or `wsst2_general`, chosen by the
    length before anything runs) and agrees with the JAX package, while
    the kernel's own rule still raises on it, naming that path; the same
    length padded (n_up a power of two) runs."""
    x = _noise(2002, 'float32')
    with pytest.raises(NotImplementedError, match='general path'):
        cwt_length_rule(2002, 8, 5 if fn == 'ssq_cwt2' else 2)
    out_t, out_j = _both(fn, x, 'float32', padtype=None, nv=16)
    assert out_t[0].shape == _np(out_j[0]).shape
    assert out_t[0].shape[-1] == 2002
    if fn == 'cwt':
        assert _rel(out_t[0], out_j[0]) <= TOL['float32']
    else:
        assert _rel(out_t[1], out_j[1]) <= TOL['float32']
        _tx_close(out_t[0], out_j[0], 'float32')
    out = getattr(tstq, fn)(x, nv=16, device='cpu')
    assert out[0].shape[-1] == 2002


def test_plan_disk_memo(tmp_path, monkeypatch):
    """The plan of string specs is kept on disk under
    `$SSQ_TPU_TORCH_CACHE` and comes back equal, key prefixed with the
    port's name; array specs stay in memory only."""
    monkeypatch.setenv('SSQ_TPU_TORCH_CACHE', str(tmp_path))
    wav = resolve_wavelet(('gmw', {'dtype': 'float64'}), N=4725)
    args = (wav, 4725, 'log-piecewise', 16, None, 'peak', False, 1.)
    tssq_cwt._PLAN_CACHE.clear()
    p1, key = tssq_cwt._ssq_cwt_plan(*args)
    files = list(tmp_path.iterdir())
    assert len(files) == 1 and files[0].suffix == '.npz'
    tssq_cwt._PLAN_CACHE.clear()
    p2, key2 = tssq_cwt._ssq_cwt_plan(*args)
    assert key2 == key and p2 is not p1
    assert np.array_equal(p1.scales, p2.scales)
    assert np.array_equal(p1.ssq_freqs, p2.ssq_freqs)
    assert np.array_equal(np.asarray(p1.const), np.asarray(p2.const))
    assert p1.params == p2.params
    tssq_cwt._PLAN_CACHE.clear()
    tssq_cwt._ssq_cwt_plan(wav, 4725, p1.scales, None, None, 'peak', False,
                           1.)
    assert len(list(tmp_path.iterdir())) == 1
