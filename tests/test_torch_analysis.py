# -*- coding: utf-8 -*-
"""The analysis layer of the port against the JAX package, on the CPU:

  * the ridge dynamic program (`ops/ridge_cuda.py`, plain versions) on
    the same seeded planted input as the JAX package's `_fw_bw_jit`:
    identical indices, float32 and float64, one signal and a batch;
  * `extract_ridges` (2-D and a (3, 40, 200) batch, two ridges,
    `get_params`, 'cwt' and 'stft', float32 and float64): identical
    indices; where a ridge differs, the two -log-normalized energies
    (numpy's and torch's `log` and `abs`) must differ, by rounding only
    (16 eps absolute: a few ulps of |Tf|^2 / max through -log), and the
    DP's total penalized energy (min_f pe[T-1, f]) on each side's input
    must agree within 1e-6 relative (the trace falls back to a column's
    argmin where no predecessor matches within eps, so the path itself
    is a near-tie's choice);
  * `TestSignals`: every `DEMO` signal (and the rest of the catalog)
    bit-identical at N = 256, also with `snr=10, seed=0`, with the same
    `get_params`; the defaults equal; the drawing methods draw (on
    `device='cpu'` where they run a transform; the default 'cuda' raises
    without a card);
  * `experimental`: `freq_to_scale` and `scale_to_freq` within 1e-6
    relative, `phase_ssqueeze` (CWT and STFT, with and without `get_w`)
    by the bins criterion (column sums within 1e-4 of max, energy within
    5e-3) and its w within 1e-5 of max; `toolkit`: `cos_f`, `sin_f`,
    `where_amax` equal;
  * the new top-level names.
"""
import jax
import numpy as np
import pytest
import torch

import ssqueezepy_tpu as jstq
from ssqueezepy_tpu import experimental as jexp, toolkit as jtk
from ssqueezepy_tpu.models import test_signals as jts
from ssqueezepy_tpu.models.ridge_extraction import _fw_bw_jit

import ssqueezepy_tpu_torch as tstq
from ssqueezepy_tpu_torch import experimental as texp, toolkit as ttk
from ssqueezepy_tpu_torch.models import test_signals as tts
from ssqueezepy_tpu_torch.models.ridge_extraction import _normalized
from ssqueezepy_tpu_torch.ops.ridge_cuda import (ridge_forward, ridge_plan,
                                                 ridge_resident, ridge_trace)
from torch_jax_reference import xla_reference  # noqa: F401

DTYPES = {'float32': (np.complex64, np.finfo(np.float32).eps),
          'float64': (np.complex128, np.finfo(np.float64).eps)}


def _planted(shape, seed, dtype):
    """Noise with two wandering ridges of different strength, (na, T)
    or (B, na, T)."""
    rng = np.random.default_rng(seed)
    B, na, T = (1,) + shape if len(shape) == 2 else shape
    Tf = (rng.standard_normal((B, na, T))
          + 1j * rng.standard_normal((B, na, T))) * .1
    t = np.arange(T)
    for b in range(B):
        r1 = (na * (.3 + .15 * np.sin(t / 20 + b))).astype(int)
        r2 = (na * (.75 + .1 * np.cos(t / 15 + b))).astype(int)
        Tf[b, r1, t] += 3
        Tf[b, r2, t] += 2
    Tf = Tf.astype(DTYPES[dtype][0])
    return Tf[0] if len(shape) == 2 else Tf


def _v(scales, transform, dtype):
    s = np.asarray(scales, dtype)
    return (np.log(s) if transform == 'cwt' else s).reshape(-1)


# ---- the dynamic program -----------------------------------------------
@pytest.mark.parametrize('B', [1, 3])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_ridge_dp_vs_jax(dtype, B):
    """The plain forward and trace on the JAX package's own input:
    `_fw_bw_jit` over e (F, T), penalty 2 on log scales."""
    F, T = 40, 300
    eps = DTYPES[dtype][1]
    Tf = _planted((B, F, T), B, dtype)
    E = np.abs(Tf) ** 2
    e_np = (-np.log(E / E.max(axis=1, keepdims=True) + eps)).astype(dtype)
    v = _v(np.geomspace(1, 64, F), 'cwt', dtype)
    P = (np.asarray(2., dtype) * np.subtract.outer(v, v) ** 2).astype(dtype)
    P_j = jax.numpy.asarray(P)
    run = jax.jit(jax.vmap(lambda e: _fw_bw_jit(P_j, e, np.dtype(
        dtype).type(eps))))
    want = np.asarray(run(e_np))
    e = torch.as_tensor(np.ascontiguousarray(e_np.transpose(0, 2, 1)))
    vt = torch.as_tensor(v)
    pe = ridge_forward(e, vt, 2.)
    got = ridge_trace(pe, e, vt, 2., eps).numpy()
    assert np.array_equal(got, want)
    # pe's first column is e's, and every column satisfies the recurrence
    Pt = torch.as_tensor(P)
    assert torch.equal(pe[:, 0], e[:, 0])
    assert torch.equal(pe[:, 1:], e[:, 1:] + torch.amin(
        pe[:, :-1, None, :] + Pt, dim=-1))


def test_ridge_rule():
    """The resident plan up to one block's shared memory of rows (F =
    11264 in float32, 5632 in float64), the row-tiled plan past it on
    every device, up to F = 10^6: no F raises (C1b before the tiled
    mode)."""
    assert ridge_resident(11264, 4) and ridge_resident(5632, 8)
    assert not ridge_plan(11264, 4).tiled and not ridge_plan(5632, 8).tiled
    for F, itemsize in ((11265, 4), (5633, 8), (10 ** 6, 4), (10 ** 6, 8)):
        assert not ridge_resident(F, itemsize)
        assert ridge_plan(F, itemsize).tiled


def _jax_state(Tf, dtype, eps, ridges, bw):
    """The JAX package's -log-normalized energy (B, F, T) before each
    ridge, its kill replayed from `ridges` (B, T, n)."""
    E = np.abs(Tf) ** 2
    E = E[None] if E.ndim == 2 else E
    rows = np.arange(E.shape[1])[:, None]
    out = []
    for i in range(ridges.shape[-1]):
        out.append((-np.log(E / E.max(axis=1, keepdims=True) + eps)
                    ).astype(dtype))
        r = ridges[..., i]
        E = np.where((rows >= r[:, None, :] - bw) & (rows < r[:, None, :] +
                                                     bw), 0, E)
    return out


def _port_state(Tf, dtype, eps, ridges, bw):
    """The port's (`_normalized`, torch) before each ridge, (B, F, T)."""
    a = torch.as_tensor(Tf).abs()
    E = a * a
    E = E[None] if E.dim() == 2 else E
    rows = torch.arange(E.shape[1])[:, None]
    out = []
    for i in range(ridges.shape[-1]):
        out.append(_normalized(E, float(eps), getattr(torch, dtype))
                   .transpose(-1, -2).numpy())
        r = torch.as_tensor(ridges[..., i])
        E = E.masked_fill((rows >= r[:, None, :] - bw) &
                          (rows < r[:, None, :] + bw), 0)
    return out


def _ulp_close(a, b, eps):
    """a and b differ, and only by rounding: -log(y) turns y's relative
    error into an absolute one, so each cell within 16 eps absolute (y =
    |Tf|^2 / max off by a few ulps through abs, the square and the
    division; the near-tie input below reads 8 eps)."""
    d = np.abs(a.astype(np.float64) - b)
    return 0 < d.max() <= 16 * eps


def _penalized_energy(e, v):
    """The DP's total penalized energy of e (F, T): min_f pe[T-1, f] of
    the forward pass (penalty 2)."""
    et = torch.as_tensor(np.ascontiguousarray(e.T))[None]
    return float(ridge_forward(et, torch.as_tensor(v), 2.)[0, -1].min())


def _hold_ridges(Tf, scales, transform, dtype, bw):
    """Two ridges with `get_params`, port against JAX: the indices
    identical, with ridge_f and ridge_e as they give them; a ridge that
    differs is held by its ulp-level input and its path's penalized
    energy (module docstring). Returns the count of differing cells."""
    kw = dict(penalty=2., n_ridges=2, bw=bw, transform=transform,
              get_params=True)
    r_t, f_t, e_t = tstq.extract_ridges(Tf, scales, device='cpu', **kw)
    r_j, f_j, e_j = jstq.extract_ridges(Tf, scales, **kw)
    assert r_t.shape == r_j.shape == Tf.shape[:-2] + (Tf.shape[-1], 2)
    assert r_t.dtype == r_j.dtype and f_t.dtype == f_j.dtype
    assert e_t.dtype == e_j.dtype
    if np.array_equal(r_t, r_j):
        assert np.array_equal(f_t, f_j)
        assert np.allclose(e_t, e_j, rtol=1e-6, atol=0)
        return 0
    eps = DTYPES[dtype][1]
    rt3, rj3 = (r_t[None], r_j[None]) if Tf.ndim == 2 else (r_t, r_j)
    st = _port_state(Tf, dtype, eps, rt3, bw)
    sj = _jax_state(Tf, dtype, eps, rj3, bw)
    v = _v(scales, transform, dtype)
    for i in range(2):
        for b in range(rt3.shape[0]):
            if np.array_equal(rt3[b, :, i], rj3[b, :, i]):
                continue
            if np.array_equal(rt3[b, :, :i], rj3[b, :, :i]):
                # the same kills before it: the inputs differ by rounding
                assert _ulp_close(st[i][b], sj[i][b], eps)
            ja = _penalized_energy(st[i][b], v)
            jc = _penalized_energy(sj[i][b], v)
            assert abs(ja - jc) <= 1e-6 * abs(jc)
    return int((r_t != r_j).sum())


@pytest.mark.parametrize('transform', ['cwt', 'stft'])
@pytest.mark.parametrize('shape', [(40, 200), (3, 40, 200)])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_extract_ridges_vs_jax(dtype, shape, transform):
    """Two ridges of a planted input with `get_params` (`_hold_ridges`)."""
    scales = (np.geomspace(1, 64, shape[-2]) if transform == 'cwt' else
              np.linspace(0, .5, shape[-2]))
    _hold_ridges(_planted(shape, len(shape), dtype), scales, transform,
                 dtype, 4)


def test_extract_ridges_near_tie():
    """An input where, with numpy 2.0's and torch 2.x's CPU `abs` and
    `log`, one column of the second ridge lands on another row: held by
    the ulp rule and the path's penalized energy (`_hold_ridges`)."""
    rng = np.random.default_rng(0)
    t = np.arange(200)
    Tf = (rng.standard_normal((40, 200))
          + 1j * rng.standard_normal((40, 200))) * .1
    Tf[(10 + 8 * np.sin(t / 20)).astype(int), t] += 3
    Tf[(30 + 3 * np.cos(t / 15)).astype(int), t] += 2
    _hold_ridges(Tf.astype(np.complex64), np.geomspace(1, 64, 40), 'cwt',
                 'float32', 15)


# ---- TestSignals ---------------------------------------------------------
@pytest.mark.parametrize('name', tts.TestSignals.DEMO)
@pytest.mark.parametrize('noise', [{}, dict(snr=10, seed=0)],
                         ids=['clean', 'snr10'])
def test_test_signals_bit_identical(name, noise):
    a = jts.TestSignals(N=256, **noise).make_signals([name], get_params=True)
    b = tts.TestSignals(N=256, **noise).make_signals([name], get_params=True)
    (xa, ta, pa), = a.values()
    (xb, tb, pb), = b.values()
    assert list(a) == list(b) == [name]
    assert np.array_equal(xa, xb) and xa.dtype == xb.dtype
    assert (ta is None and tb is None) or np.array_equal(ta, tb)
    assert repr(pa) == repr(pb)


def test_test_signals_catalog_and_defaults():
    """Every catalog method with its defaults, the anti-alias N, the
    module defaults and the batch generator's list form."""
    for k in ('DEFAULT_N', 'DEFAULT_ARGS', 'DEFAULT_TKW', 'DEFAULT_SNR',
              'DEFAULT_SEED'):
        assert repr(getattr(jts, k)) == repr(getattr(tts, k))
    assert tts.TestSignals.SUPPORTED == jts.TestSignals.SUPPORTED
    ja, ta = jts.TestSignals(N=300), tts.TestSignals(N=300)
    for name in ja.SUPPORTED:
        meth = name.replace('-', '_')
        xa, _ = getattr(ja, meth)()
        xb, _ = getattr(ta, meth)()
        assert np.array_equal(xa, xb), name
    xa, _ = ja.lchirp(fmin=1, fmax=40, tmin=0, tmax=1)
    xb, _ = ta.lchirp(fmin=1, fmax=40, tmin=0, tmax=1)
    assert len(xa) == len(xb) and np.array_equal(xa, xb)
    sigs = ['sine:am-cosine', ('echirp', dict(fmin=2, fmax=60)),
            ('am-gauss', dict(amin=.2))]
    for a, b in zip(ja.make_signals(sigs), ta.make_signals(sigs)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize('method', ['demo', 'test_transforms', 'wavcomp',
                                    'cwt_vs_stft', 'ridgecomp'])
def test_test_signals_drawing_raises(method, monkeypatch):
    """Each drawing method draws at N = 256 (`plt.show` counted, under
    Agg); those that run the port's transforms (`wavcomp`,
    `cwt_vs_stft`, `ridgecomp`) take `device='cpu'` for it, and without a
    card their default 'cuda' raises as every entry point does."""
    import matplotlib.pyplot as plt
    shows = []
    monkeypatch.setattr(plt, 'show', lambda *a, **k: shows.append(1))
    args = {'test_transforms': (lambda x, t, p: (x[None], {}),),
            'wavcomp': (['gmw'],), 'cwt_vs_stft': ('gmw', 'hann')}.get(
                method, ())
    kw = dict(signals='cosine')
    transform = method in ('wavcomp', 'cwt_vs_stft', 'ridgecomp')
    try:
        getattr(tts.TestSignals(N=256), method)(
            *args, **kw, **(dict(device='cpu') if transform else {}))
        assert shows
        if transform and not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                getattr(tts.TestSignals(N=256), method)(*args, **kw)
    finally:
        plt.close('all')


# ---- experimental and toolkit ------------------------------------------
@pytest.mark.parametrize('wavelet', ['gmw', 'morlet'])
def test_freq_scale_maps_vs_jax(wavelet):
    f = np.linspace(.01, .45, 24)
    a = texp.freq_to_scale(f, wavelet, 512)
    b = jexp.freq_to_scale(f, wavelet, 512)
    assert np.abs(a / b - 1).max() <= 1e-6
    sc = np.geomspace(1.5, 100, 40)
    for padtype in ('reflect', None):
        a = texp.scale_to_freq(sc, wavelet, 777, fs=2, padtype=padtype)
        b = jexp.scale_to_freq(sc, wavelet, 777, fs=2, padtype=padtype)
        assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()


def _tx_bins(Tx_t, Tx_j):
    Tx_t = Tx_t.numpy() if isinstance(Tx_t, torch.Tensor) else Tx_t
    Tx_j = np.asarray(Tx_j.re) + 1j * np.asarray(Tx_j.im) \
        if hasattr(Tx_j, 're') else np.asarray(Tx_j)
    m = np.abs(Tx_j).max()
    assert Tx_t.shape == Tx_j.shape
    assert np.abs(Tx_t.sum(-2) - Tx_j.sum(-2)).max() < 1e-4 * m
    e_t, e_j = np.abs(Tx_t).sum(), np.abs(Tx_j).sum()
    assert abs(e_t - e_j) / e_j < 5e-3


@pytest.mark.parametrize('get_w', [False, True])
@pytest.mark.parametrize('transform', ['cwt', 'stft'])
def test_phase_ssqueeze_vs_jax(transform, get_w):
    """`phase_ssqueeze` on the JAX package's own float32 transform and
    derivative (the CWT's dWx also derived by `trigdiff` when absent)."""
    x = np.random.default_rng(3).standard_normal(1024).astype(np.float32)
    if transform == 'cwt':
        out = jstq.ssq_cwt(x, get_dWx=True, astensor=False, nv=16)
        Wx, dWx, scales = out[1], out[4], out[3]
        kw = dict(scales=scales, wavelet='gmw', flipud=True)
    else:
        out = jstq.ssq_stft(x, get_dWx=True, astensor=False, n_fft=128)
        Wx, dWx = out[1], out[4]
        kw = dict(ssq_freqs=np.linspace(0, .5, 65, dtype=np.float32))
    Wx, dWx = np.asarray(Wx), np.asarray(dWx)
    for d in ((dWx, None) if transform == 'cwt' else (dWx,)):
        if d is None and get_w:
            continue
        a = texp.phase_ssqueeze(Wx, d, get_w=get_w, transform=transform,
                                device='cpu', **kw)
        b = jexp.phase_ssqueeze(Wx, d, get_w=get_w, transform=transform,
                                **kw)
        _tx_bins(a[0], b[0])
        assert np.array_equal(a[2], b[2])
        if get_w:
            w_t, w_j = a[5].numpy(), np.asarray(b[5])
            fin = np.isfinite(w_j)
            assert np.array_equal(np.isfinite(w_t), fin)
            assert np.abs(w_t[fin] - w_j[fin]).max() <= 1e-5 * np.abs(
                w_j[fin]).max()


def test_toolkit_vs_jax():
    f = [1, 3.5, 8]
    assert np.array_equal(ttk.cos_f(f), jtk.cos_f(f))
    assert np.array_equal(ttk.sin_f(f, N=65, phi=.3, endpoint=True),
                          jtk.sin_f(f, N=65, phi=.3, endpoint=True))
    x = np.random.default_rng(1).standard_normal((7, 9))
    x[2, 3] = x[5, 1] = -10
    for got in (ttk.where_amax(x), ttk.where_amax(torch.as_tensor(x))):
        want = jtk.where_amax(x)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    for args in (((64, 500), .5, .1, .025), ((100, 37), 1.2, -.2, .1)):
        got = ttk._linear_band_geometry(*args)
        want = jtk._linear_band_geometry(*args)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_analysis_exports():
    """The names of the JAX package's top level that this layer adds."""
    for name in ('extract_ridges', 'TestSignals', 'ridge_extraction',
                 'experimental', 'toolkit'):
        assert hasattr(jstq, name) and hasattr(tstq, name)
        assert name in tstq.__all__
    assert tstq.ridge_extraction.extract_ridges is tstq.extract_ridges
    for name in texp.__all__:
        assert hasattr(jexp, name)
    assert set(ttk.__all__) == set(jtk.__all__)
