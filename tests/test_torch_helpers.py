# -*- coding: utf-8 -*-
"""The port's helpers against the JAX package's on the same numpy inputs,
on the CPU: the elementwise scrubbers (`ops/elementwise.py`; numpy in
place as the JAX package's numpy path, a tensor anew on its device and
in its dtype with the same values),
the numpy/torch backend (`utils/backend.py`: `S` and `Q` keep a tensor's
dtype and device), `mad` and `est_riskshrink_thresh`, `unbuffer`,
`window_resolution`, `window_area`, the `FFT` handle, the configs'
reports (`IS_PARALLEL`, `USE_GPU`, `backend`) and `wavs`. Exact, or
within 1e-12 where the arithmetic's order differs.
"""
import numpy as np
import pytest
import torch

import ssqueezepy_tpu as jstq
from ssqueezepy_tpu.ops import elementwise as jel

import ssqueezepy_tpu_torch as tstq
from ssqueezepy_tpu_torch.ops import elementwise as tel
from ssqueezepy_tpu_torch.ops import fft as tfft
from torch_jax_reference import xla_reference  # noqa: F401


def _planted(seed=0, complex_=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(40) * 1e-3
    x[[1, 5]], x[[2, 9]], x[3] = np.inf, np.nan, -np.inf
    x[[7, 11]] = 0.
    if complex_:
        x = x + 1j * rng.standard_normal(40) * 1e-3
        x[21] = complex(np.nan, np.inf)
        x[23] = complex(0., np.inf)
    return x


CASES = {
    'replace_at_inf_or_nan': dict(replacement=7.),
    'replace_at_inf': dict(replacement=-2.),
    'replace_at_nan': dict(),
    'replace_at_value': dict(value=0., replacement=3.),
    'replace_under_abs': dict(value=5e-4, replacement=0.),
}


@pytest.mark.parametrize('name', list(CASES))
@pytest.mark.parametrize('complex_', [False, True])
def test_elementwise_vs_jax(name, complex_):
    """numpy in place, equal to the JAX package's numpy path; a tensor
    (with and without `ref`) anew, dtype kept, with the same values."""
    kw = CASES[name]
    x = _planted(1, complex_)
    ref = _planted(2, complex_)
    for r in (None, ref):
        jout = getattr(jel, name)(x.copy(), r, **kw)
        xn = x.copy()
        out = getattr(tel, name)(xn, r, **kw)
        assert out is xn
        np.testing.assert_array_equal(out, jout)
        t = torch.as_tensor(x)
        tout = getattr(tel, name)(t, None if r is None else
                                  torch.as_tensor(r), **kw)
        assert tout.dtype == t.dtype and tout is not t
        np.testing.assert_array_equal(tout.numpy(), jout)
        np.testing.assert_array_equal(t.numpy(), x)        # not in place


def test_zero_denormals_nck_min_neglect_vs_jax():
    for dtype in ('float32', 'float64'):
        x = _planted(3).astype(dtype)
        x[[4, 6]] = np.finfo(dtype).tiny * 10
        x[[8, 10]] = np.finfo(dtype).tiny * 2000
        x[~np.isfinite(x)] = 1.
        ref = jel.zero_denormals(x.copy())
        np.testing.assert_array_equal(tel.zero_denormals(x.copy()), ref)
        t = tel.zero_denormals(torch.as_tensor(x))
        assert t.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(t.numpy(), ref)
    for n, k in ((10, 3), (52, 5), (7, 0), (7, 7), (30, 15)):
        assert tel.nCk(n, k) == jel.nCk(n, k)
    for arr in (np.array([1., .5, 1e-13, 1e-14]), np.ones(5)):
        assert tel._min_neglect_idx(arr) == jel._min_neglect_idx(arr)


def test_backend_dispatch_keeps_dtype():
    """`S` and `Q` take torch where an argument (or `like`) is a tensor,
    in its dtype, numpy otherwise; `asnumpy`, `is_tensor`."""
    S, Q = tstq.S, tstq.Q
    t32 = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    t64 = torch.arange(6, dtype=torch.float64)
    for t in (t32, t64):
        for out in (S.asarray([1, 2], like=t), S.zeros((2,), like=t),
                    S.ones(3, like=t), S.array(t), S.atleast_1d(t),
                    S.vstack([t, t]), Q.abs(t), Q.exp(t), Q.sum(t)):
            assert isinstance(out, torch.Tensor)
        assert S.asarray(t).dtype == t.dtype
        assert S.astype(t, 'float32').dtype == torch.float32
        assert Q.abs(-t).dtype == t.dtype and Q.exp(t).dtype == t.dtype
        assert S.asarray([1., 2.], dtype='float64', like=t).dtype == \
            torch.float64
        assert S.arange(4, like=t, dtype='float32').dtype == torch.float32
        assert tstq.is_tensor(t) and not tstq.is_tensor(t.numpy())
        np.testing.assert_array_equal(tstq.asnumpy(t), t.numpy())
    a = np.arange(6.)
    for out in (S.asarray([1, 2]), S.zeros(2), S.ones(3), S.arange(4),
                S.vstack([a, a]), S.atleast_1d(a), Q.abs(a), Q.sum(a)):
        assert isinstance(out, np.ndarray) or np.isscalar(out)
    assert S.astype(a, 'float32').dtype == np.float32
    np.testing.assert_array_equal(Q.cumsum(a), jstq.Q.cumsum(a))
    assert S.is_dtype(t32, 'float32') and not S.is_dtype(a, 'int')


def test_mad_riskshrink_vs_jax():
    rng = np.random.default_rng(4)
    data = rng.standard_normal((6, 50))
    for axis in (None, 0):
        ref = jstq.mad(data, axis)
        np.testing.assert_allclose(tstq.mad(data, axis), ref, rtol=1e-12)
        out = tstq.mad(torch.as_tensor(data), axis)
        assert isinstance(out, torch.Tensor) and out.dtype == torch.float64
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12)
    Wx = data + 1j * rng.standard_normal((6, 50))
    ref = jstq.est_riskshrink_thresh(Wx, 3)
    assert abs(tstq.est_riskshrink_thresh(Wx, 3) - ref) <= 1e-12 * ref
    out = tstq.est_riskshrink_thresh(torch.as_tensor(Wx), 3)
    assert isinstance(out, torch.Tensor)
    assert abs(float(out) - ref) <= 1e-12 * ref


@pytest.mark.parametrize('hop,win_exp', [(1, 1), (4, 0), (3, 2)])
def test_unbuffer_vs_jax(hop, win_exp):
    n_fft, N = 32, 300
    window = tstq.get_window('hann', n_fft, n_fft)
    xbuf = np.random.default_rng(hop).standard_normal((n_fft, 70))
    ref = jstq.unbuffer(xbuf, window, hop, n_fft, N, win_exp)
    np.testing.assert_allclose(tstq.unbuffer(xbuf, window, hop, n_fft, N,
                                             win_exp), ref, rtol=1e-12,
                               atol=1e-12)
    out = tstq.unbuffer(torch.as_tensor(xbuf), window, hop, n_fft, N,
                        win_exp)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize('name', ['hann', 'triang', 'hamming'])
def test_window_measures_vs_jax(name):
    window = tstq.get_window(name, 128, 128)
    np.testing.assert_allclose(tstq.window_resolution(window),
                               jstq.window_resolution(window), rtol=1e-12)
    for time, frequency in ((True, False), (False, True), (True, True)):
        np.testing.assert_allclose(
            tstq.window_area(window, time, frequency),
            jstq.window_area(window, time, frequency), rtol=1e-12)
    with pytest.raises(ValueError):
        tstq.window_resolution(window - 1)


def test_fft_handle_configs_wavs(monkeypatch, caplog):
    """`FFT` over the port's FFTs (a NOTE once for a non-zero patience),
    `FFT_GLOBAL`, the configs' reports and `wavs`."""
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(16))
    h = tstq.FFT(patience=0)
    assert torch.equal(h.rfft(x), torch.fft.rfft(x))
    assert torch.equal(tstq.FFT_GLOBAL.ifft(h.fft(x)), torch.fft.ifft(
        torch.fft.fft(x)))
    monkeypatch.setattr(tfft, '_PATIENCE_NOTED', False)
    with caplog.at_level('WARNING', logger='ssqueezepy_tpu_torch'):
        tstq.FFT(patience=1)
        tstq.FFT(patience=2)
    assert sum('patience' in r.message for r in caplog.records) == 1
    monkeypatch.setenv('SSQ_PARALLEL', '0')
    assert tstq.IS_PARALLEL() is False
    monkeypatch.setenv('SSQ_PARALLEL', '1')
    assert tstq.IS_PARALLEL() is jstq.IS_PARALLEL() is True
    assert tstq.USE_GPU() is torch.cuda.is_available()
    assert tstq.backend() == ('cuda' if torch.cuda.is_available()
                              else 'cpu')
    assert tstq.wavs() == jstq.wavs()
