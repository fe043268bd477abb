# -*- coding: utf-8 -*-
"""The port's multirate streaming plan (`ssqueezepy_tpu_torch/
streaming_multirate.py`, device='cpu': the plain versions of B3 and B5 on
each octave block) and the primitives the streaming plans stand on,
against the JAX package on the same seeded input:

  * `halfband_fir` to 1e-15; `conv_valid`, `decimate2` and `interp2` to
    1e-12 in float64 (1-D and batched rows);
  * the carry state's reflection (`ops/pad.py::reflect_index`,
    `_reflect`) against `np.pad(..., 'reflect')` for pads of 0, < n,
    n - 1 and several periods, and against the JAX package's `_reflect`;
  * `ops/fft.py::next_fft_len` against `ssqueezepy_tpu/parallel/
    time_sharded.py::_next_fft_len`, the streaming length rule;
  * the plan's geometry (octaves, blocks, contexts, `_geo`, history,
    lookahead, `compute_ratio`) exactly, and the lookahead cap raising;
  * the emission schedule, `state_dict` after every chunk (bit-equal),
    Wx within 2e-5 of max and Tx by the bins criterion, with the GMW
    (B3 closed form), cmhat (B3 from the plan's table) and morlet
    (`cwt_general`), without ssq, and on a (2, chunk) batch;
  * a JAX plan's snapshot resuming in the port, and the port's own resume
    bit for bit.
"""
import numpy as np
import pytest
import torch

import ssqueezepy_tpu.ops.multirate as jmr
from ssqueezepy_tpu import streaming as js
from ssqueezepy_tpu import streaming_multirate as jsm
from ssqueezepy_tpu.parallel.time_sharded import (_next_fft_len,
                                                  _reflect as jreflect)

from ssqueezepy_tpu_torch import streaming as ts
from ssqueezepy_tpu_torch import streaming_multirate as tsm
from ssqueezepy_tpu_torch.ops import multirate as tmr
from ssqueezepy_tpu_torch.ops.fft import next_fft_len
from ssqueezepy_tpu_torch.ops.pad import _reflect, reflect_index
from torch_jax_reference import xla_reference  # noqa: F401


def _np(c):
    if c is None:
        return None
    if isinstance(c, torch.Tensor):
        return c.numpy()
    if hasattr(c, 're'):
        return np.asarray(c.re) + 1j * np.asarray(c.im)
    return np.asarray(c)


def _rel(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / np.abs(b).max()


def _bins_criterion(Tx_t, Tx_j):
    Tx_t, Tx_j = _np(Tx_t), _np(Tx_j)
    assert Tx_t.shape == Tx_j.shape
    m = np.abs(Tx_j).max()
    assert np.abs(Tx_t.sum(-2) - Tx_j.sum(-2)).max() < 1e-4 * m
    e_t, e_j = np.abs(Tx_t).sum(), np.abs(Tx_j).sum()
    assert abs(e_t - e_j) / e_j < 5e-3


def _chirp(N, f0=0.001, f1=0.15):
    n = np.arange(N)
    return np.cos(2 * np.pi * (f0 * n + (f1 - f0) / (2 * N) * n ** 2)) \
        .astype(np.float32)


def _scales(smax=256., n=41):
    return np.geomspace(1., smax, n).reshape(-1, 1)


# ---- primitives ----------------------------------------------------------------
@pytest.mark.parametrize('taps,beta', [(63, 9.), (31, 9.), (127, 6.)])
def test_halfband_fir_matches_jax(taps, beta):
    np.testing.assert_allclose(tmr.halfband_fir(taps, beta),
                               jmr.halfband_fir(taps, beta), rtol=0,
                               atol=1e-15)
    h = tmr.halfband_fir(taps, beta)
    off = np.arange(taps) - (taps - 1) // 2
    assert not h[(off % 2 == 0) & (off != 0)].any()
    assert h.sum() == pytest.approx(1., abs=1e-15)
    for bad in (62, 65):
        with pytest.raises(ValueError):
            tmr.halfband_fir(bad)
        with pytest.raises(ValueError):
            jmr.halfband_fir(bad)


@pytest.mark.parametrize('shape', [(500,), (3, 257)], ids=['1d', 'rows'])
def test_conv_decimate_interp_match_jax(shape):
    x = np.random.default_rng(1).standard_normal(shape)
    xt = torch.as_tensor(x)
    h = tmr.halfband_fir(63)
    for t, j in ((tmr.conv_valid(xt, h), jmr.conv_valid(x, h)),
                 (tmr.decimate2(xt), jmr.decimate2(x)),
                 (tmr.interp2(xt), jmr.interp2(x)),
                 (tmr.interp2(xt, n_out=100, taps=31),
                  jmr.interp2(x, n_out=100, taps=31))):
        j = np.asarray(j)
        assert t.dtype == torch.float64 and t.shape == j.shape
        assert np.abs(t.numpy() - j).max() <= 1e-12 * np.abs(j).max()
    n = shape[-1]
    assert tmr.interp2(xt).shape[-1] == 2 * n - 1 - 63 + 1
    assert tmr.decimate2(xt).shape[-1] == (n - 63 + 1 + 1) // 2


@pytest.mark.parametrize('n', [0, 3, 8, 9, 30], ids=lambda n: 'pad%d' % n)
@pytest.mark.parametrize('from_start', [True, False], ids=['start', 'end'])
def test_reflection_matches_np_pad(n, from_start):
    """Pads of 0, < N, N - 1 and several periods of a length-10 signal:
    the material `np.pad(..., 'reflect')` puts before or after it (the
    streaming plans' pre-signal context and synthetic tail), and for
    n < N the JAX package's `_reflect`."""
    N = 10
    x = np.random.default_rng(2).standard_normal((2, N))
    if from_start:
        want = np.pad(x, [(0, 0), (n, 0)], 'reflect')[:, :n]
    else:
        want = np.pad(x, [(0, 0), (0, n)], 'reflect')[:, N:]
    got = _reflect(torch.as_tensor(x), n, from_start).numpy()
    np.testing.assert_array_equal(got, want)
    assert reflect_index(N, n, from_start, torch.device('cpu')).shape == (n,)
    if 0 < n < N:
        np.testing.assert_array_equal(got, np.asarray(jreflect(x, n,
                                                               from_start)))


def test_next_fft_len_matches_time_sharded():
    ns = list(range(1, 5000)) + [40961, 98304, 160000, 262145, 1 << 22]
    assert [next_fft_len(n) for n in ns] == [_next_fft_len(n) for n in ns]


# ---- the plan ---------------------------------------------------------------------------
@pytest.mark.parametrize('kw', [
    dict(chunk=1024, scales=_scales(256., 161), N=16384),
    dict(chunk=512, scales=_scales(256., 41), N=4096, ssq=False),
    dict(chunk=4096, scales=np.geomspace(1, 512, 181).reshape(-1, 1),
         N=65536),
    dict(chunk=768, scales=_scales(128., 33), N=4096, taps=31,
         guard_frac=.3)],
    ids=['bench16k', 'small', 'wide181', 'taps31'])
def test_multirate_plan_matches_jax(kw):
    kw = dict(kw, nv=None)
    chunk = kw.pop('chunk')
    pj = jsm.StreamingMultirateSSQCWT(chunk, 'gmw', **kw)
    pt = tsm.StreamingMultirateSSQCWT(chunk, 'gmw', device='cpu', **kw)
    np.testing.assert_array_equal(pt.octaves, pj.octaves)
    assert pt._blocks == pj._blocks and pt._ctx == pj._ctx
    assert pt._geo == pj._geo
    assert (pt.history, pt.lookahead) == (pj.history, pj.lookahead)
    assert pt.compute_ratio == pj.compute_ratio
    np.testing.assert_allclose(pt.support_np, pj.support_np, rtol=1e-12)
    np.testing.assert_allclose(pt.ssq_freqs_out, pj.ssq_freqs_out,
                               rtol=1e-12)
    np.testing.assert_allclose(pt.const_np, pj.const_np, rtol=1e-12)
    assert pt.nbins == pj.nbins
    # every block's CWT window lies within the kernel's length rule
    assert all(p['n_up'] == next_fft_len(p['n_up']) for p in pt._plans)


def test_multirate_lookahead_cap_raises():
    kw = dict(scales=_scales(256., 41), nv=None, N=4096, lookahead=100)
    with pytest.raises(ValueError) as ej:
        jsm.StreamingMultirateSSQCWT(512, 'gmw', **kw)
    with pytest.raises(ValueError) as et:
        tsm.StreamingMultirateSSQCWT(512, 'gmw', device='cpu', **kw)
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize('wav,ssq', [('gmw', True), ('cmhat', True),
                                     ('morlet', True), ('gmw', False)],
                         ids=['gmw', 'cmhat', 'morlet', 'gmw_nossq'])
def test_multirate_matches_jax(wav, ssq):
    """Columns per call, `state_dict` after each chunk (bit-equal), and
    every emitted Wx/Tx column against the JAX plan's (the derived
    lookahead exceeds the record: finalize flushes several chunks)."""
    N, chunk = 4096, 512
    x = _chirp(N)
    kw = dict(scales=_scales(256. if wav == 'gmw' else 64., 41), nv=None,
              N=N, ssq=ssq)
    pj = jsm.StreamingMultirateSSQCWT(chunk, wav, **kw)
    pt = tsm.StreamingMultirateSSQCWT(chunk, wav, device='cpu', **kw)
    assert pt._kernel == (wav != 'morlet')
    assert pt.octaves.max() >= (3 if wav == 'gmw' else 1)
    out_j, out_t = [], []
    for i in range(N // chunk):
        xi = x[i * chunk:(i + 1) * chunk]
        out_j.append(pj.process(xi))
        out_t.append(pt.process(xi))
        sj, st = pj.state_dict(), pt.state_dict()
        for k in ('hist', 'pend'):
            np.testing.assert_array_equal(st[k], sj[k])
        assert st['ncalls'] == sj['ncalls']
    out_j.append(pj.finalize())
    out_t.append(pt.finalize())
    assert ([o[1].shape[-1] for o in out_t] ==
            [o[1].re.shape[-1] for o in out_j])
    W_t = np.concatenate([_np(o[1]) for o in out_t], axis=-1)
    W_j = np.concatenate([_np(o[1]) for o in out_j], axis=-1)
    assert W_t.shape[-1] == N
    assert _rel(W_t, W_j) <= 2e-5
    if ssq:
        _bins_criterion(np.concatenate([_np(o[0]) for o in out_t], -1),
                        np.concatenate([_np(o[0]) for o in out_j], -1))
    else:
        assert all(o[0] is None for o in out_t)


def test_multirate_batched_matches_jax():
    N, chunk = 4096, 512
    n = np.arange(N)
    xb = np.stack([_chirp(N, 0.005, 0.1),
                   np.sin(2 * np.pi * 0.03 * n).astype(np.float32)])
    kw = dict(scales=_scales(128., 41), nv=None, N=N)
    Tx_j, W_j = js._drive(jsm.StreamingMultirateSSQCWT(chunk, 'gmw', **kw),
                          xb, chunk)
    Tx_t, W_t = ts._drive(tsm.StreamingMultirateSSQCWT(chunk, 'gmw',
                                                       device='cpu', **kw),
                          xb, chunk)
    assert _rel(W_t, W_j) <= 2e-5
    for b in range(2):
        _bins_criterion(Tx_t[b], _np(Tx_j)[b])


def test_multirate_resume():
    """A JAX snapshot after two chunks continues in the port to the JAX
    continuation; the port's own snapshot, in a fresh plan, bit for
    bit."""
    N, chunk = 4096, 512
    x = _chirp(N)
    kw = dict(scales=_scales(), nv=None, N=N)
    pj = jsm.StreamingMultirateSSQCWT(chunk, 'gmw', **kw)
    pt = tsm.StreamingMultirateSSQCWT(chunk, 'gmw', device='cpu', **kw)
    whole = [pt.process(x[i * chunk:(i + 1) * chunk])
             for i in range(N // chunk)] + [pt.finalize()]
    for i in range(2):
        pj.process(x[i * chunk:(i + 1) * chunk])
    state = pj.state_dict()
    pt2 = tsm.StreamingMultirateSSQCWT(chunk, 'gmw', device='cpu', **kw)
    pt2.load_state(state)
    pt.reset()
    for i in range(2):
        pt.process(x[i * chunk:(i + 1) * chunk])
    pt3 = tsm.StreamingMultirateSSQCWT(chunk, 'gmw', device='cpu', **kw)
    pt3.load_state(pt.state_dict())
    rest_j, rest_t, rest_3 = [], [], []
    for i in range(2, N // chunk):
        xi = x[i * chunk:(i + 1) * chunk]
        rest_j.append(pj.process(xi))
        rest_t.append(pt2.process(xi))
        rest_3.append(pt3.process(xi))
    rest_j.append(pj.finalize())
    rest_t.append(pt2.finalize())
    rest_3.append(pt3.finalize())
    W_t = np.concatenate([_np(o[1]) for o in rest_t], -1)
    W_j = np.concatenate([_np(o[1]) for o in rest_j], -1)
    assert _rel(W_t, W_j) <= 2e-5
    _bins_criterion(np.concatenate([_np(o[0]) for o in rest_t], -1),
                    np.concatenate([_np(o[0]) for o in rest_j], -1))
    for a, b in zip(whole[2:], rest_3):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
