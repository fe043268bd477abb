# -*- coding: utf-8 -*-
"""The port's batched (B, N) STFT family and second-order CWT
(device='cpu', i.e. the plain PyTorch versions of the STFT table kernel
B6/B7 and the WSST2 kernel B8 over a batch) against the JAX package on
the CPU:

  * batched `stft` at hop 1 and hop 3, modulated and not, with and
    without `derivative`;
  * batched `ssq_stft` over hop {1, 3} x squeezing {'sum', 'lebesgue',
    'abs'} x `get_dWx` x float32/float64, and with `flipud`;
  * batched `ssq_stft2` and `ssq_cwt2` in both dtypes;
  * every batched row against the port's own one-signal call on that
    row (bit for bit: the plain versions run each row's arithmetic as a
    one-signal call does), with the CPU's thread count at 1 and at 4;
  * `stft_conv_plain`, `fsst2_conv_plain` and `cwt_bins2_plain` on a
    batch against a loop over its rows;
  * `get_w` on a batch raising as in the JAX package, and the wrappers
    rejecting a batch whose spectra do not match the tables;
  * batched `stft` -> `istft` in float64.

Tolerances (ROADMAP.md): Sx, dSx, W within 2e-5 of their max in float32
and 1e-9 in float64; first-order Tx by the bins criterion in float32
(column sums within 1e-4 of max, energy within 5e-3) and within 1e-9 of
max in float64; second-order Tx by the order-2 bins criterion of
`tests/test_torch_order2.py` (column sums 1e-4 of max, |dTx| > 1e-3 max
on under 2% of cells, energy within 0.02).
"""
import numpy as np
import pytest
import torch

import ssqueezepy_tpu as jstq

import ssqueezepy_tpu_torch as tstq
from ssqueezepy_tpu_torch.models.cwt import resolve_wavelet
from ssqueezepy_tpu_torch.models.ssq_cwt import _ssq_cwt_plan
from ssqueezepy_tpu_torch.models.ssq_stft import fsst2_plan, stft_plan
from ssqueezepy_tpu_torch.models.stft import signal_spectrum
from ssqueezepy_tpu_torch.ops.cwt_cuda import cwt_bins2, cwt_bins2_plain
from ssqueezepy_tpu_torch.ops.fft import rfft
from ssqueezepy_tpu_torch.ops.pad import pad_params, padsignal
from ssqueezepy_tpu_torch.ops.stft_conv import conv_bank, conv_table
from ssqueezepy_tpu_torch.ops.stft_cuda import (fsst2_conv, fsst2_conv_plain,
                                                stft_conv, stft_conv_plain)
from torch_jax_reference import xla_reference  # noqa: F401

TOL = {'float32': 2e-5, 'float64': 1e-9}
B, N, N_FFT = 3, 700, 64


def _np(c):
    """numpy complex from a JAX `Complex`, a torch tensor or numpy."""
    if isinstance(c, torch.Tensor):
        return c.numpy()
    if hasattr(c, 're'):
        return np.asarray(c.re) + 1j * np.asarray(c.im)
    return np.asarray(c)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _batch(dtype, seed=0, n=N):
    """B signals: white noise, a chirp plus noise, a tone plus noise."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, n, endpoint=False)
    x = rng.standard_normal((B, n))
    x[1] = np.cos(2 * np.pi * (20 * t + 150 * t ** 2)) + .1 * x[1]
    x[2] = np.cos(2 * np.pi * 60 * t) + .1 * x[2]
    return x.astype(dtype)


def _bins_criterion(Tx_t, Tx_j):
    m = np.abs(Tx_j).max()
    assert np.abs(Tx_t.sum(-2) - Tx_j.sum(-2)).max() < 1e-4 * m
    e_t, e_j = np.abs(Tx_t).sum(), np.abs(Tx_j).sum()
    assert abs(e_t - e_j) / e_j < 5e-3


def _bins2_criterion(Tx_t, Tx_j):
    m = np.abs(Tx_j).max()
    assert np.abs(Tx_t.sum(-2) - Tx_j.sum(-2)).max() < 1e-4 * m
    assert (np.abs(Tx_t - Tx_j) > 1e-3 * m).mean() < 0.02
    e_t, e_j = np.abs(Tx_t).sum(), np.abs(Tx_j).sum()
    assert abs(e_t - e_j) / e_j < 0.02


def _rows_equal(batched, one_signal, threads=(1, 4)):
    """Each row of the batched outputs `batched()` bit-equal to
    `one_signal(b)`'s, both computed with the CPU's thread count set to
    each of `threads` in turn (the count is restored afterwards): a row
    may not depend on the batch it rides in, nor on how the CPU splits
    the work."""
    before = torch.get_num_threads()
    try:
        for n in threads:
            torch.set_num_threads(n)
            outs = batched()
            for b in range(B):
                for o_b, o_1 in zip(outs, one_signal(b)):
                    assert o_b[b].shape == o_1.shape
                    assert torch.equal(o_b[b], o_1), (n, b)
    finally:
        torch.set_num_threads(before)


# ---- stft ------------------------------------------------------------------
@pytest.mark.parametrize('hop', [1, 3])
@pytest.mark.parametrize('modulated', [True, False])
@pytest.mark.parametrize('derivative', [False, True])
def test_batched_stft_vs_jax(hop, modulated, derivative):
    for dtype in ('float32', 'float64'):
        x = _batch(dtype)
        kw = dict(n_fft=N_FFT, hop_len=hop, modulated=modulated,
                  derivative=derivative, dtype=dtype, fs=3.)
        out_j = jstq.stft(x, **kw)
        out_t = tstq.stft(x, device='cpu', **kw)
        if not derivative:
            out_j, out_t = (out_j,), (out_t,)
        for o_t, o_j in zip(out_t, out_j):
            assert o_t.shape == (B, N_FFT // 2 + 1, -(-N // hop))
            assert o_t.dtype == (torch.complex64 if dtype == 'float32'
                                 else torch.complex128)
            assert _rel(o_t, o_j) <= TOL[dtype]

        def call(sig):
            out = tstq.stft(sig, device='cpu', **kw)
            return out if derivative else (out,)
        _rows_equal(lambda: call(x), lambda b: call(x[b]))


def test_batched_stft_istft_round_trip():
    x = _batch('float64', seed=4)
    for hop in (1, 3):
        S = tstq.stft(x, n_fft=N_FFT, hop_len=hop, dtype='float64',
                      device='cpu')
        xr = tstq.istft(S, n_fft=N_FFT, hop_len=hop, N=N)
        assert xr.shape == (B, N)
        assert np.abs(xr - x).mean() < 1e-14


# ---- ssq_stft --------------------------------------------------------------
@pytest.mark.parametrize('hop', [1, 3])
@pytest.mark.parametrize('squeezing', ['sum', 'lebesgue', 'abs'])
@pytest.mark.parametrize('get_dWx', [False, True])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_batched_ssq_stft_vs_jax(hop, squeezing, get_dWx, dtype):
    """Hop 1 runs B6's bins mode on the batch and the batched scatter B2
    (`get_dWx`: B6's Sx + dSx mode); hop 3 the framed STFT on the batch;
    then B4 ('sum') or the phase transform and B5."""
    x = _batch(dtype, seed=1)
    kw = dict(n_fft=N_FFT, hop_len=hop, squeezing=squeezing,
              get_dWx=get_dWx, dtype=dtype, astensor=False)
    out_j = jstq.ssq_stft(x, **kw)
    out_t = tstq.ssq_stft(x, device='cpu', **kw)
    assert len(out_t) == len(out_j) == (5 if get_dWx else 4)
    Tx_t, Sx_t, fr_t, Sfs_t = out_t[:4]
    Tx_j, Sx_j, fr_j, Sfs_j = out_j[:4]
    n_segs = -(-N // hop)
    assert Tx_t.shape == Tx_j.shape == (B, len(fr_j), n_segs)
    assert Sx_t.shape == Sx_j.shape == (B, N_FFT // 2 + 1, n_segs)
    assert Tx_t.dtype == Tx_j.dtype
    assert np.array_equal(fr_t, fr_j) and np.array_equal(Sfs_t, Sfs_j)
    assert _rel(Sx_t, Sx_j) <= TOL[dtype]
    if get_dWx:
        assert _rel(out_t[4], out_j[4]) <= TOL[dtype]
    if dtype == 'float64':
        assert _rel(Tx_t, Tx_j) <= 1e-9
    else:
        _bins_criterion(Tx_t, Tx_j)


@pytest.mark.parametrize('hop', [1, 3])
def test_batched_ssq_stft_flipud_user_grid_vs_jax(hop):
    x = _batch('float32', seed=2)
    kw = dict(n_fft=N_FFT, hop_len=hop, fs=10., flipud=True,
              ssq_freqs=np.linspace(.05, 4.5, 40), astensor=False)
    Tx_j, Sx_j, fr_j, _ = jstq.ssq_stft(x, **kw)
    Tx_t, Sx_t, fr_t, _ = tstq.ssq_stft(x, device='cpu', **kw)
    assert Tx_t.shape == Tx_j.shape == (B, 40, -(-N // hop))
    assert np.array_equal(fr_t, fr_j)
    assert _rel(Sx_t, Sx_j) <= TOL['float32']
    _bins_criterion(Tx_t, Tx_j)


@pytest.mark.parametrize('hop,squeezing,get_dWx', [
    (1, 'sum', False), (1, 'lebesgue', True), (3, 'sum', False),
    (3, 'abs', True)])
def test_batched_ssq_stft_rows_equal_one_signal(hop, squeezing, get_dWx):
    x = _batch('float32', seed=3)
    kw = dict(n_fft=N_FFT, hop_len=hop, squeezing=squeezing,
              get_dWx=get_dWx, device='cpu')
    planes = (0, 1, 4) if get_dWx else (0, 1)
    _rows_equal(lambda: [tstq.ssq_stft(x, **kw)[i] for i in planes],
                lambda b: [
        tstq.ssq_stft(x[b], **kw)[i] for i in planes])


# ---- second order ----------------------------------------------------------
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
@pytest.mark.parametrize('squeezing', ['sum', 'lebesgue'])
def test_batched_ssq_stft2_vs_jax(dtype, squeezing):
    x = _batch(dtype, seed=5)
    kw = dict(n_fft=N_FFT, squeezing=squeezing, dtype=dtype,
              astensor=False)
    Tx_j, V_j, fr_j, Sfs_j = jstq.ssq_stft2(x, **kw)
    Tx_t, V_t, fr_t, Sfs_t = tstq.ssq_stft2(x, device='cpu', **kw)
    assert Tx_t.shape == Tx_j.shape == (B, len(fr_j), N)
    assert V_t.shape == V_j.shape == (B, N_FFT // 2 + 1, N)
    assert np.array_equal(fr_t, fr_j) and np.array_equal(Sfs_t, Sfs_j)
    assert _rel(V_t, V_j) <= TOL[dtype]
    _bins2_criterion(Tx_t, Tx_j)
    _rows_equal(lambda: tstq.ssq_stft2(
        x, n_fft=N_FFT, squeezing=squeezing, dtype=dtype,
        device='cpu')[:2], lambda b: tstq.ssq_stft2(
        x[b], n_fft=N_FFT, squeezing=squeezing, dtype=dtype,
        device='cpu')[:2])


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
@pytest.mark.parametrize('squeezing', ['sum', 'abs'])
def test_batched_ssq_cwt2_vs_jax(dtype, squeezing):
    x = _batch(dtype, seed=6)
    wav = ('gmw', {'dtype': dtype})
    kw = dict(scales='log', nv=8, squeezing=squeezing)
    Tx_j, W_j, fr_j, sc_j = jstq.ssq_cwt2(x, wav, astensor=False, **kw)
    Tx_t, W_t, fr_t, sc_t = tstq.ssq_cwt2(x, wav, astensor=False,
                                          device='cpu', **kw)
    assert Tx_t.shape == Tx_j.shape == (B, len(fr_j), N)
    assert W_t.shape == W_j.shape == (B, len(sc_j), N)
    assert np.array_equal(fr_t, fr_j) and np.array_equal(sc_t, sc_j)
    assert _rel(W_t, W_j) <= TOL[dtype]
    _bins2_criterion(Tx_t, Tx_j)
    _rows_equal(lambda: tstq.ssq_cwt2(x, wav, device='cpu', **kw)[:2],
                lambda b: tstq.ssq_cwt2(x[b], wav, device='cpu', **kw)[:2])


# ---- the kernels' plain versions on a batch --------------------------------
def _stft_tables(dtype, n=N):
    x = torch.as_tensor(_batch(dtype, seed=7, n=n))
    xh = signal_spectrum(x, N_FFT, 'reflect')
    plan = stft_plan(None, None, N_FFT, N_FFT, 1., dtype)
    H = conv_table(plan.window, N_FFT, xh.shape[-1], True, dtype, 'cpu')
    Hd = conv_table(plan.diff_window, N_FFT, xh.shape[-1], True, dtype,
                    'cpu')
    bins = dict(Sfs=torch.as_tensor(plan.Sfs), params=plan.params,
                flipud=False, gamma=10 * float(np.finfo(dtype).eps))
    return xh, H, Hd, bins


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_stft_plain_versions_batch_vs_row_loop(dtype):
    """B6's three modes and B7 on a (B, Np2) batch: the plain versions
    (and the wrappers, which run them on the CPU) equal a loop over the
    rows, in shape (B, n_rows, N)."""
    xh, H, Hd, bins = _stft_tables(dtype)
    for Hd_, bins_ in ((None, None), (Hd, None), (Hd, bins)):
        out = stft_conv_plain(xh, H, Hd_, N, 2., bins_)
        assert out[0].shape == (B, H.shape[0], N)
        _rows_equal(lambda: [o for o in stft_conv_plain(
            xh, H, Hd_, N, 2., bins_) if o is not None], lambda b: [
            o for o in stft_conv_plain(xh[b], H, Hd_, N, 2., bins_)
            if o is not None])
        for o_w, o_p in zip(stft_conv(xh, H, Hd_, N, 2., bins_), out):
            assert (o_w is None and o_p is None) or torch.equal(o_w, o_p)
    plan = fsst2_plan(None, None, N_FFT, N_FFT, 1., dtype)
    tables = conv_bank(plan.bank, N_FFT, xh.shape[-1], True, dtype, 'cpu')
    bins7 = dict(Sfs=torch.as_tensor(plan.Sfs), params=plan.params,
                 flipud=True, gamma=bins['gamma'])
    V, k = fsst2_conv_plain(xh, tables, N, 2., bins7)
    assert V.shape == k.shape == (B, tables.shape[1], N)
    _rows_equal(lambda: fsst2_conv_plain(xh, tables, N, 2., bins7),
                lambda b: fsst2_conv_plain(xh[b], tables, N, 2., bins7))
    V_w, k_w = fsst2_conv(xh, tables, N, 2., bins7)
    assert torch.equal(V_w, V) and torch.equal(k_w, k)


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_cwt_bins2_plain_batch_vs_row_loop(dtype):
    wav = resolve_wavelet(('gmw', {'dtype': dtype}), N=N)
    plan, _ = _ssq_cwt_plan(wav, N, 'log', 8, None, 'peak', True, 1.)
    n_up, n1, _ = pad_params(N, 'reflect')
    tdt = getattr(torch, dtype)
    xh = rfft(padsignal(torch.as_tensor(_batch(dtype, seed=8)),
                        'reflect')).contiguous()
    sc = torch.as_tensor(plan.scales.ravel(), dtype=tdt)
    args = (sc, wav, n_up, n1, N, 1., plan.params,
            10 * float(np.finfo(dtype).eps), True)
    W, k = cwt_bins2_plain(xh, *args)
    assert W.shape == k.shape == (B, len(sc), N)
    _rows_equal(lambda: cwt_bins2_plain(xh, *args),
                lambda b: cwt_bins2_plain(xh[b], *args))
    W_w, k_w = cwt_bins2(xh, *args)
    assert torch.equal(W_w, W) and torch.equal(k_w, k)


# ---- what a batch may not do -----------------------------------------------
@pytest.mark.parametrize('fn', ['ssq_stft', 'ssq_cwt2'])
@pytest.mark.parametrize('kw', [dict(), dict(squeezing='abs'),
                                dict(flipud=True)],
                         ids=['default', 'abs', 'flipud'])
def test_batched_get_w_raises_like_jax(fn, kw):
    """`get_w=True` on a batch raises NotImplementedError with the JAX
    package's message, whatever the other options, on any device."""
    x = _batch('float32', seed=9)
    msg = "`get_w=True` unsupported with batched input."
    for call, extra in ((getattr(jstq, fn), {}),
                        (getattr(tstq, fn), dict(device='cpu')),
                        (getattr(tstq, fn), {})):
        with pytest.raises(NotImplementedError) as e:
            call(x, get_w=True, **kw, **extra)
        assert str(e.value) == msg


def test_batched_ssq_stft2_get_w_and_3d_input_raise():
    """`ssq_stft2(get_w=True)` returns w2 for a signal and a batch (each
    batched row the signal's, held against the JAX package in
    tests/test_torch_order2_w.py), `ssq_cwt2(get_w=True)` on a batch
    raises as the JAX package's does; 3-D input raises in every batched
    entry point."""
    x = _batch('float32', seed=10)
    outs = [tstq.ssq_stft2(xi, n_fft=N_FFT, get_w=True, device='cpu')
            for xi in (x, x[0])]
    for out, lead in zip(outs, ((B,), ())):
        assert len(out) == 5
        assert out[4].shape == lead + (N_FFT // 2 + 1, N)
        assert out[4].dtype == torch.float32
    assert torch.equal(outs[0][4][0], outs[1][4])
    with pytest.raises(NotImplementedError,
                       match='unsupported with batched input'):
        tstq.ssq_cwt2(x, get_w=True, device='cpu')
    for fn in (tstq.stft, tstq.ssq_stft, tstq.ssq_stft2, tstq.ssq_cwt2):
        with pytest.raises(ValueError, match='1D or 2D'):
            fn(x[None], device='cpu')


def test_wrappers_reject_a_batch_that_mismatches_the_tables():
    xh, H, Hd, bins = _stft_tables('float32')
    bad = torch.cat([xh, xh[:, :1]], dim=-1)
    for args in ((bad, H, None, N), (bad, H, Hd, N, 1., bins),
                 (xh[None], H, None, N)):
        with pytest.raises(ValueError, match='batch'):
            stft_conv(*args)
    plan = fsst2_plan(None, None, N_FFT, N_FFT, 1., 'float32')
    tables = conv_bank(plan.bank, N_FFT, xh.shape[-1], True, 'float32',
                       'cpu')
    bins7 = dict(Sfs=torch.as_tensor(plan.Sfs), params=plan.params,
                 flipud=False, gamma=bins['gamma'])
    with pytest.raises(ValueError, match='batch'):
        fsst2_conv(bad, tables, N, 1., bins7)
    wav = resolve_wavelet(('gmw', {'dtype': 'float32'}), N=N)
    p2, _ = _ssq_cwt_plan(wav, N, 'log', 8, None, 'peak', True, 1.)
    n_up, n1, _ = pad_params(N, 'reflect')
    xh2 = torch.zeros((B, n_up // 2 + 2), dtype=torch.complex64)
    sc = torch.as_tensor(p2.scales.ravel(), dtype=torch.float32)
    with pytest.raises(ValueError, match='batch'):
        cwt_bins2(xh2, sc, wav, n_up, n1, N, 1., p2.params, 1e-6, True)
