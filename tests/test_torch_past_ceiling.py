# -*- coding: utf-8 -*-
"""The general routes that the public calls take past the kernels' rules
(ROADMAP.md queue C, C1b), on `device='cpu'`, against the JAX package's
XLA path on the CPU.

The three rules are made to refuse every shape here: the shared-memory
limits that `ops/cwt_cuda.py::cwt_length_rule`, `ops/stft_cuda.py::
stft_length_rule` and `ops/ssq_cuda.py::scatter_rule` read are set to
0 (their launch plans' memos cleared), so `cwt_kernel_fits`,
`stft_kernel_fits` and `scatter_fits` are all False and any kernel
wrapper the call reached would raise C1b. Each call then runs
`models/cwt.py::cwt_general`, `models/ssq_cwt2.py::wsst2_general`,
`models/stft.py::stft_general` or `models/ssq_stft.py::fsst2_general`,
and every scatter `ops/ssq_kernels.py::scatter_general` (after the torch
phase transform and bin map in B4's place), each counted.

Float64 at N = 2048 (CWT: 12 scales; STFT: n_fft 96, 49 rows): every
plane within 1e-9 of its max, Tx too (the float64 bins agree; the bins
criterion of ROADMAP.md is weaker). The row blocks of the general
functions (`utils/common.py::row_blocks`) are bit-identical to one
block, and `scatter_general` is held to the plain scatter and to the
JAX package's `_scatter_xla` on planted wrapped, dropped and invalid
cells.
"""
import numpy as np
import pytest
import torch

import ssqueezepy_tpu as jstq
from ssqueezepy_tpu.ops.complexlib import Complex
from ssqueezepy_tpu.ops.ssq_kernels import _scatter_xla

import ssqueezepy_tpu_torch as tstq
from ssqueezepy_tpu_torch.models import cwt as tcwt
from ssqueezepy_tpu_torch.models import ssq_cwt2 as tssq2
from ssqueezepy_tpu_torch.models import ssq_stft as tssq_stft
from ssqueezepy_tpu_torch.models import stft as tstft
from ssqueezepy_tpu_torch.ops import cwt_cuda, ssq_cuda, stft_cuda
from ssqueezepy_tpu_torch.ops.ssq_cuda import shift_scatter_plain
from ssqueezepy_tpu_torch.ops.ssq_kernels import scatter_general
from ssqueezepy_tpu_torch.utils import common
from torch_jax_reference import xla_reference  # noqa: F401

TOL = 1e-9
N = 2048
SCALES = 2. ** (1.5 + np.arange(12) / 2)
WAV = ('gmw', {'dtype': 'float64'})
N_FFT = 96

GENERAL = {'cwt_general': tcwt.cwt_general,
           'wsst2_general': tssq2.wsst2_general,
           'stft_general': tstft.stft_general,
           'fsst2_general': tssq_stft.fsst2_general,
           'scatter_general': scatter_general}


def _clear_plans():
    for fn in (cwt_cuda.bins_plan, stft_cuda.launch_plan):
        fn.cache_clear()


@pytest.fixture
def past_ceilings(monkeypatch):
    """Every kernel rule refuses every shape (and raises if a wrapper is
    reached)."""
    _clear_plans()
    monkeypatch.setattr(cwt_cuda, '_SMEM_MAX', 0)
    monkeypatch.setattr(stft_cuda, '_MAX_LEN', 0)
    monkeypatch.setattr(ssq_cuda, '_SMEM_BUDGET', 0)
    yield
    _clear_plans()


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _noise(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


def _np(c):
    if isinstance(c, Complex):
        return np.asarray(c.re) + 1j * np.asarray(c.im)
    if isinstance(c, torch.Tensor):
        return c.numpy()
    return np.asarray(c)


def _close(a, b, tol=TOL):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * np.abs(b).max()


def _w_close(w_t, w_j):
    """Phase planes: the same inf cells, the finite ones within TOL."""
    w_t, w_j = _np(w_t), _np(w_j)
    inf_t, inf_j = np.isinf(w_t), np.isinf(w_j)
    assert np.array_equal(inf_t, inf_j)
    _close(w_t[~inf_t], w_j[~inf_j])


def _counted(fn):
    """(fn's result, {general function: calls it made})."""
    before = {k: f.calls for k, f in GENERAL.items()}
    out = fn()
    return out, {k: f.calls - before[k] for k, f in GENERAL.items()
                 if f.calls != before[k]}


CWT_ROUTES = {
    'sum': (dict(), {'cwt_general': 1, 'scatter_general': 1}),
    'lebesgue': (dict(squeezing='lebesgue'),
                 {'cwt_general': 1, 'scatter_general': 1}),
    'get_w': (dict(get_w=True, get_dWx=True),
              {'cwt_general': 1, 'scatter_general': 1}),
    'unpadded': (dict(padtype=None), {'cwt_general': 1,
                                      'scatter_general': 1}),
    'batch': (dict(batch=True), {'cwt_general': 1, 'scatter_general': 1}),
}


@pytest.mark.parametrize('route', list(CWT_ROUTES))
def test_ssq_cwt_general_vs_jax(past_ceilings, one_thread, route):
    """`ssq_cwt`: `cwt_general`, then the torch phase transform, bin map
    and `scatter_general` ('sum' in B4's place), every plane within
    1e-9 of the JAX package's."""
    kw, need = CWT_ROUTES[route]
    kw = dict(kw)
    x = _noise((2, N) if kw.pop('batch', False) else N)
    kw.update(wavelet=WAV, scales=SCALES, astensor=False)
    out_t, moved = _counted(lambda: tstq.ssq_cwt(x, device='cpu', **kw))
    assert moved == need
    out_j = jstq.ssq_cwt(x, **kw)
    assert len(out_t) == len(out_j)
    _close(out_t[0], out_j[0])
    _close(out_t[1], out_j[1])
    assert np.allclose(out_t[2], out_j[2], rtol=1e-12)
    if kw.get('get_w'):
        _w_close(out_t[4], out_j[4])
        _close(out_t[5], out_j[5])


def test_cwt_general_vs_jax(past_ceilings, one_thread):
    """`cwt` with dWx, one `cwt_general` call."""
    x = _noise(N)
    kw = dict(scales=SCALES, nv=None, derivative=True, astensor=False)
    out_t, moved = _counted(lambda: tstq.cwt(x, WAV, device='cpu', **kw))
    assert moved == {'cwt_general': 1}
    out_j = jstq.cwt(x, WAV, **kw)
    _close(out_t[0], out_j[0])
    _close(out_t[2], out_j[2])


@pytest.mark.parametrize('kw', [dict(), dict(get_w=True),
                                dict(batch=True)],
                         ids=['sum', 'get_w', 'batch'])
def test_ssq_cwt2_general_vs_jax(past_ceilings, one_thread, kw):
    """`ssq_cwt2`: `wsst2_general`, then the bins of w2 and
    `scatter_general`."""
    kw = dict(kw)
    x = _noise((2, N) if kw.pop('batch', False) else N)
    kw.update(wavelet=WAV, scales=SCALES, astensor=False)
    out_t, moved = _counted(lambda: tstq.ssq_cwt2(x, device='cpu', **kw))
    assert moved == {'wsst2_general': 1, 'scatter_general': 1}
    out_j = jstq.ssq_cwt2(x, **kw)
    _close(out_t[0], out_j[0])
    _close(out_t[1], out_j[1])
    if kw.get('get_w'):
        _w_close(out_t[4], out_j[4])


def test_stft_general_vs_jax(past_ceilings, one_thread):
    """Hop-1 `stft` with dSx, and on a (2, N) batch: `stft_general`."""
    x = _noise(N)
    kw = dict(n_fft=N_FFT, dtype='float64')
    (Sx, dSx), moved = _counted(lambda: tstq.stft(
        x, derivative=True, device='cpu', **kw))
    assert moved == {'stft_general': 1}
    Sx_j, dSx_j = jstq.stft(x, derivative=True, **kw)
    _close(Sx, Sx_j)
    _close(dSx, dSx_j)
    xb = _noise((2, N), 1)
    _close(tstq.stft(xb, device='cpu', **kw), jstq.stft(xb, **kw))


STFT_ROUTES = {
    'sum': dict(),
    'lebesgue': dict(squeezing='lebesgue'),
    'get_w': dict(get_w=True, get_dWx=True),
    'batch': dict(batch=True),
}


@pytest.mark.parametrize('route', list(STFT_ROUTES))
def test_ssq_stft_general_vs_jax(past_ceilings, one_thread, route):
    """Hop-1 `ssq_stft`: `stft_general` for (Sx, dSx), then the torch
    phase transform, bin map and `scatter_general`."""
    kw = dict(STFT_ROUTES[route])
    x = _noise((2, N) if kw.pop('batch', False) else N)
    kw.update(n_fft=N_FFT, dtype='float64', astensor=False)
    out_t, moved = _counted(lambda: tstq.ssq_stft(x, device='cpu', **kw))
    assert moved == {'stft_general': 1, 'scatter_general': 1}
    out_j = jstq.ssq_stft(x, **kw)
    assert len(out_t) == len(out_j)
    _close(out_t[0], out_j[0])
    _close(out_t[1], out_j[1])
    if kw.get('get_w'):
        _w_close(out_t[4], out_j[4])
        _close(out_t[5], out_j[5])


@pytest.mark.parametrize('kw', [dict(), dict(get_w=True, flipud=True),
                                dict(batch=True, squeezing='abs')],
                         ids=['sum', 'get_w', 'batch-abs'])
def test_ssq_stft2_general_vs_jax(past_ceilings, one_thread, kw):
    """`ssq_stft2`: `fsst2_general`, then the bins of w2 and
    `scatter_general`."""
    kw = dict(kw)
    x = _noise((2, N) if kw.pop('batch', False) else N)
    kw.update(n_fft=N_FFT, dtype='float64', astensor=False)
    out_t, moved = _counted(lambda: tstq.ssq_stft2(x, device='cpu', **kw))
    assert moved == {'fsst2_general': 1, 'scatter_general': 1}
    out_j = jstq.ssq_stft2(x, **kw)
    _close(out_t[0], out_j[0])
    _close(out_t[1], out_j[1])
    if kw.get('get_w'):
        _w_close(out_t[4], out_j[4])


def test_ssqueeze_and_scatters_general_vs_jax(past_ceilings, one_thread):
    """`ssqueeze` from (Wx, dWx) ('sum': `ssqueeze_fast` in B4's place)
    and from w, `indexed_sum_onfly` and `indexed_sum`: each on
    `scatter_general`, against the JAX package."""
    Wx, _, dWx = jstq.cwt(_noise(N), WAV, scales=SCALES, nv=None,
                          derivative=True, astensor=False)
    kw = dict(scales=SCALES, gamma=1e-8)
    (Tx, _), moved = _counted(lambda: tstq.ssqueeze(
        Wx, dWx=dWx, device='cpu', **kw))
    assert moved == {'scatter_general': 1}
    _close(Tx, jstq.ssqueeze(Wx, dWx=dWx, **kw)[0])
    w = np.asarray(jstq.phase_cwt(Wx, dWx, 'trig', 1e-8))
    freqs = np.linspace(.01, .45, 16)
    for fn in ('ssqueeze', 'indexed_sum_onfly'):
        args = ((Wx, w) if fn == 'ssqueeze' else (Wx, w, freqs))
        fkw = (dict(ssq_freqs=freqs, scales=SCALES, squeezing='abs')
               if fn == 'ssqueeze' else {})
        out_t, moved = _counted(lambda: getattr(tstq, fn)(
            *args, device='cpu', **fkw))
        assert moved == {'scatter_general': 1}
        out_j = getattr(jstq, fn)(*args, **fkw)
        _close(out_t[0] if fn == 'ssqueeze' else out_t,
               out_j[0] if fn == 'ssqueeze' else out_j)
    k = np.random.default_rng(3).integers(-12, 12, Wx.shape)
    out_t, moved = _counted(lambda: tstq.indexed_sum(Wx, k, device='cpu'))
    assert moved == {'scatter_general': 1}
    _close(out_t, jstq.indexed_sum(Wx, k))


@pytest.mark.parametrize('batch', [False, True])
@pytest.mark.parametrize('masked', [False, True])
def test_scatter_general_semantics(batch, masked):
    """`scatter_general` against the plain generic scatter (B5's plain
    version) and the JAX package's `_scatter_xla` on planted wrapped
    (k < 0), dropped (k < -nbins, k >= nbins) and invalid cells, with and
    without const; no rule is involved."""
    rng = np.random.default_rng(7 + 2 * batch + masked)
    na, n, nbins = 9, 33, 7
    shape = ((3,) if batch else ()) + (na, n)
    v = torch.as_tensor(rng.standard_normal(shape)
                        + 1j * rng.standard_normal(shape))
    k = torch.as_tensor(rng.integers(-2 * nbins, 2 * nbins, shape),
                        dtype=torch.int32)
    valid = (torch.as_tensor(rng.random(shape) < .7) if masked else None)
    for const in (None, torch.as_tensor(rng.random(na) + .5)):
        out = scatter_general(v, k, valid, nbins, const)
        ref = shift_scatter_plain(v, k, valid, nbins, const)
        _close(out, ref, 1e-14)
        vc = v if const is None else v * const.reshape(-1, 1)
        kw = torch.where(k < 0, k + nbins, k)
        ok = (kw >= 0) & (kw < nbins)
        if valid is not None:
            ok &= valid
        for b in range(3 if batch else 1):
            sl = (b,) if batch else ()
            ref_j = _scatter_xla(np.ascontiguousarray(vc[sl].real.numpy()),
                                 np.ascontiguousarray(vc[sl].imag.numpy()),
                                 np.asarray(k[sl]), np.asarray(ok[sl]),
                                 nbins)
            _close(out[sl], ref_j, 1e-14)


def test_row_blocks_bit_identical(monkeypatch, one_thread):
    """`cwt_general`, `wsst2_general`, `stft_general`, `fsst2_general`
    and `scatter_general` in row blocks of 1-3 rows equal one block bit
    for bit."""
    x = torch.as_tensor(_noise((2, 1000)))
    sc = torch.as_tensor(SCALES[:7])
    wav = tcwt.resolve_wavelet(WAV)
    plan = tssq_stft.fsst2_plan(None, None, N_FFT, N_FFT, 1., 'float64')
    sfs = torch.as_tensor(plan.Sfs)
    v = torch.as_tensor(_noise((2, 7, 50)) + 1j * _noise((2, 7, 50), 1))
    k = torch.as_tensor(np.random.default_rng(2).integers(-3, 9, v.shape),
                        dtype=torch.int32)
    runs = {
        'cwt_general': lambda: tcwt.cwt_general(
            tcwt.padded_signal(x, 'reflect')[0], wav, sc, 1000, 1000, 1.,
            True, False),
        'wsst2_general': lambda: tssq2.wsst2_general(
            x, 'reflect', sc, wav, 1000, 1., 1e-10),
        'stft_general': lambda: tstft.stft_general(
            x, plan.bank[:2], N_FFT, 'reflect', True),
        'fsst2_general': lambda: tssq_stft.fsst2_general(
            x, plan.bank, N_FFT, 'reflect', True, 1., sfs, 1e-10),
        'scatter_general': lambda: (scatter_general(
            v, k, k > 0, 8, torch.arange(1., 8., dtype=torch.float64)),)}
    whole = {name: run() for name, run in runs.items()}
    for budget in (1, 200000):
        # one row per block, then 1-3 rows (by each function's row bytes)
        monkeypatch.setattr(common, '_BLOCK_BYTES', budget)
        for name, run in runs.items():
            for a, b in zip(run(), whole[name]):
                assert torch.equal(a, b), name
