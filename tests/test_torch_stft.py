# -*- coding: utf-8 -*-
"""The port's STFT family (device='cpu', i.e. the plain PyTorch version of
the STFT table kernel) against the JAX package on the CPU:

  * `get_window` equal to the JAX one;
  * `stft` (hop 1: the table kernel's plain version; hop 3: the framed
    path) against the JAX `stft` (its framed path), with and without the
    modulation, over transform lengths with the factors 15, 9 and 2^a;
  * `stft_conv_plain` in its three modes against the JAX table kernel
    (`stft_conv`, `stft_conv_bins`) run in interpret mode;
  * `ssq_stft` against the JAX `ssq_stft`, default and user grids;
  * `istft`/`issq_stft` against the JAX ones, and the round trips.

Tolerances: Sx and dSx within 2e-5 of their max in float32 and 1e-9 in
float64 (transform vs framed DFTs, summation order); bins equal on >= 99%
of valid cells and within +-1 elsewhere (float32 rounding of w at bin
boundaries), Tx by the bins criterion (column sums within 1e-4 of max,
energy within 5e-3); ssq_freqs and Sfs exactly; `stft` -> `istft` in
float64 MAE < 1e-14 (as tests/test_reconstruction.py); `issq_stft`
mad_rms < 0.1.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import ssqueezepy_tpu as jstq
from ssqueezepy_tpu.models.stft import _window_key
from ssqueezepy_tpu.models.windows import get_window as jget_window
from ssqueezepy_tpu.ops.ssq_kernels import ssq_bin_params as jbin_params
from ssqueezepy_tpu.ops.stft_conv import (stft_conv as jstft_conv,
                                          stft_conv_bins as jstft_conv_bins,
                                          _device_filterbank)

import ssqueezepy_tpu_torch as tstq
from ssqueezepy_tpu_torch.convert import stft_plan_from_numpy
from ssqueezepy_tpu_torch.models.ssq_stft import stft_plan
from ssqueezepy_tpu_torch.models.stft import signal_spectrum
from ssqueezepy_tpu_torch.ops.fft import next_fft_len
from ssqueezepy_tpu_torch.ops.stft_conv import conv_table
from ssqueezepy_tpu_torch.ops.stft_cuda import (stft_conv, stft_conv_plain,
                                                split_fft_len)
from torch_jax_reference import xla_reference  # noqa: F401

TOL = {'float32': 2e-5, 'float64': 1e-9}


def _np(c):
    """numpy complex from a JAX `Complex` or a torch tensor."""
    if isinstance(c, torch.Tensor):
        return c.numpy()
    return np.asarray(c.re) + 1j * np.asarray(c.im)


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def _noise(N, dtype='float32', seed=0):
    return np.random.default_rng(seed).standard_normal(N).astype(dtype)


def _chirp(N, dtype='float32'):
    t = np.linspace(0, 1, N, endpoint=False)
    return np.cos(2 * np.pi * (20 * t + 150 * t ** 2)).astype(dtype)


def _bins_criterion(Tx_t, Tx_j):
    m = np.abs(Tx_j).max()
    assert np.abs(Tx_t.sum(-2) - Tx_j.sum(-2)).max() < 1e-4 * m
    e_t, e_j = np.abs(Tx_t).sum(), np.abs(Tx_j).sum()
    assert abs(e_t - e_j) / e_j < 5e-3


@pytest.mark.parametrize('window,win_len,n_fft', [
    (None, 64, 64), ('hann', 60, 60), (None, 50, 64),
    (np.hanning(48).astype(np.float32), 48, 64)],
    ids=['dpss', 'hann', 'dpss-short', 'array-short'])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_get_window_vs_jax(window, win_len, n_fft, dtype):
    w_t, dw_t = tstq.get_window(window, win_len, n_fft, derivative=True,
                                dtype=dtype)
    w_j, dw_j = jget_window(window, win_len, n_fft, derivative=True,
                            dtype=dtype)
    assert w_t.dtype == w_j.dtype and len(w_t) == n_fft
    assert np.array_equal(w_t, w_j) and np.array_equal(dw_t, dw_j)


# (N, n_fft): transform lengths N + n_fft - 1 -> 960 = 15 x 2^6,
# 1152 = 9 x 2^7, 4608 = 9 x 2^9 and 4096 = 2^12
@pytest.mark.parametrize('N,n_fft', [(777, 64), (1000, 121), (4000, 256),
                                     (4000, 97)])
@pytest.mark.parametrize('modulated', [True, False])
@pytest.mark.parametrize('hop', [1, 3])
def test_stft_vs_jax(N, n_fft, modulated, hop):
    for dtype in ('float32', 'float64'):
        x = _noise(N, dtype)
        kw = dict(n_fft=n_fft, hop_len=hop, modulated=modulated,
                  derivative=True, dtype=dtype, fs=3.)
        Sx_j, dSx_j = jstq.stft(x, **kw)
        Sx_t, dSx_t = tstq.stft(x, device='cpu', **kw)
        assert Sx_t.shape == (n_fft // 2 + 1, -(-N // hop))
        assert Sx_t.dtype == (torch.complex64 if dtype == 'float32'
                              else torch.complex128)
        assert _rel(_np(Sx_t), _np(Sx_j)) <= TOL[dtype]
        assert _rel(_np(dSx_t), _np(dSx_j)) <= TOL[dtype]
    assert split_fft_len(next_fft_len(N + n_fft - 1))


def test_fft_lengths():
    assert [next_fft_len(n) for n in (840, 1120, 4255, 4096)] == \
        [960, 1152, 4608, 4096]
    for n in (12288, 163840, 4096, 9216, 7680, 1 << 22):
        f1, f2 = split_fft_len(n)
        assert f1 * f2 == n
    assert split_fft_len(12288) == (96, 128)
    assert split_fft_len(163840) == (320, 512)
    for bad in (7 * 1024, 1 << 23):
        with pytest.raises(NotImplementedError):
            split_fft_len(bad)


@pytest.mark.parametrize('N,n_fft,modulated', [(777, 64, True),
                                               (1000, 121, False)])
def test_stft_conv_plain_vs_jax_pallas(N, n_fft, modulated):
    """All three modes of the plain version against the JAX table kernel
    in interpret mode, on the same signal, window and bin plan."""
    fs, dtype = 2., 'float32'
    x = _noise(N, seed=1)
    win, dwin = jget_window(None, n_fft, n_fft, derivative=True,
                            dtype=dtype)
    wk = _window_key(win, dwin)
    padlength = N + n_fft - 1
    Sx_j, dSx_j = jstft_conv(jnp.asarray(x), fs, n_fft, N, wk, modulated,
                             True, 'reflect', padlength, dtype,
                             interpret=True)
    Sfs = np.linspace(0, .5 * fs, n_fft // 2 + 1, dtype=dtype)
    params = jbin_params(Sfs, False)
    gamma = float(10 * np.finfo(np.float32).eps)
    tables = _device_filterbank(wk, n_fft, next_fft_len(padlength),
                                modulated, dtype)
    Sxb_j, k_j = jstft_conv_bins(jnp.asarray(x), fs, n_fft, N, wk, modulated,
                                 'reflect', padlength, dtype, params, gamma,
                                 True, tuple(Sfs.tolist()), tables,
                                 interpret=True)

    # the port runs on the JAX plan's own constants
    plan = stft_plan_from_numpy(win, dwin, Sfs, params=params)
    xh = signal_spectrum(torch.from_numpy(x), n_fft, 'reflect')
    H = conv_table(plan.window, n_fft, xh.shape[0], modulated, dtype, 'cpu')
    Hd = conv_table(plan.diff_window, n_fft, xh.shape[0], modulated, dtype,
                    'cpu')
    bins = dict(Sfs=torch.from_numpy(plan.Sfs), params=plan.params,
                gamma=gamma, flipud=True)
    S0, none = stft_conv_plain(xh, H, None, N, fs)
    S1, dS1 = stft_conv_plain(xh, H, Hd, N, fs)
    S2, k_t = stft_conv(xh, H, Hd, N, fs, bins)      # CPU: the plain path
    assert none is None and k_t.dtype == torch.int32
    for S in (S0, S1, S2):
        assert _rel(S.numpy(), _np(Sx_j)) <= 2e-5
    assert _rel(dS1.numpy(), _np(dSx_j)) <= 2e-5
    assert _rel(S2.numpy(), _np(Sxb_j)) <= 2e-5
    k_t, k_j = k_t.numpy(), np.asarray(k_j)
    assert np.array_equal(k_t == -1, k_j == -1)
    valid = k_j >= 0
    assert (k_t[valid] == k_j[valid]).mean() >= 0.99
    # within one bin, except on a few low-magnitude cells (DC row of the
    # unmodulated STFT, |Sx| ~ 4e-4 of max) where the JAX kernel's bf16x3
    # products are what is off: there the port agrees with a float64
    # plain version within one bin
    far = valid & (np.abs(k_t - k_j) > 1)
    assert far.sum() <= 1e-3 * valid.sum()
    if far.any():
        x64 = torch.from_numpy(x.astype(np.float64))
        xh64 = signal_spectrum(x64, n_fft, 'reflect')
        w64, dw64 = tstq.get_window(None, n_fft, n_fft, derivative=True,
                                    dtype='float64')
        tab = [conv_table(w, n_fft, xh.shape[0], modulated, 'float64', 'cpu')
               for w in (w64, dw64)]
        _, k64 = stft_conv_plain(xh64, tab[0], tab[1], N, fs, dict(
            bins, Sfs=torch.from_numpy(Sfs.astype(np.float64))))
        assert np.abs(k_t[far] - k64.numpy()[far]).max() <= 1


@pytest.mark.parametrize('case', ['default', 'user-grid-flipud', 'float64'])
def test_ssq_stft_vs_jax(case):
    N, n_fft = 1200, 128
    dtype = 'float64' if case == 'float64' else 'float32'
    kw = dict(n_fft=n_fft, dtype=dtype, astensor=False)
    if case == 'user-grid-flipud':
        kw.update(fs=10., flipud=True, ssq_freqs=np.linspace(.05, 4.5, 150))
    x = _chirp(N, dtype) + .1 * _noise(N, dtype, seed=2)
    Tx_j, Sx_j, fr_j, Sfs_j = jstq.ssq_stft(x, **kw)
    Tx_t, Sx_t, fr_t, Sfs_t = tstq.ssq_stft(x, device='cpu', **kw)
    assert Tx_t.shape == Tx_j.shape and Sx_t.shape == Sx_j.shape
    assert Tx_t.dtype == Tx_j.dtype
    assert np.array_equal(fr_t, fr_j) and np.array_equal(Sfs_t, Sfs_j)
    assert _rel(Sx_t, Sx_j) <= TOL[dtype]
    _bins_criterion(Tx_t, Tx_j)


@pytest.mark.parametrize('hop,modulated', [(1, True), (3, True), (3, False)])
def test_istft_vs_jax_and_round_trip(hop, modulated):
    N, n_fft = 1500, 128
    x = _noise(N, 'float64', seed=3)
    Sx = tstq.stft(x, n_fft=n_fft, hop_len=hop, modulated=modulated,
                   dtype='float64', device='cpu')
    x_t = tstq.istft(Sx, n_fft=n_fft, hop_len=hop, N=N, modulated=modulated)
    x_j = jstq.istft(Sx.numpy(), n_fft=n_fft, hop_len=hop, N=N,
                     modulated=modulated)
    assert x_t.shape == (N,)
    assert np.abs(x_t - x).mean() < 1e-14
    assert np.abs(x_t - x_j).max() < 1e-12
    # a batch of two, and float32 against the JAX inverse
    xb = tstq.istft(torch.stack([Sx, 2 * Sx]), n_fft=n_fft, hop_len=hop,
                    N=N, modulated=modulated)
    assert xb.shape == (2, N) and np.abs(xb[1] - 2 * x).mean() < 1e-13
    S32 = Sx.to(torch.complex64)
    assert np.abs(tstq.istft(S32, n_fft=n_fft, hop_len=hop, N=N,
                             modulated=modulated)
                  - jstq.istft(S32.numpy(), n_fft=n_fft, hop_len=hop, N=N,
                               modulated=modulated)).max() < 1e-5


def test_issq_stft_vs_jax_and_round_trip():
    N = 2000
    x = _chirp(N)
    Tx, _, _, _ = tstq.ssq_stft(x, device='cpu')
    assert tstq.toolkit.mad_rms(x, tstq.issq_stft(Tx)) < 0.1
    Tx_np = Tx.numpy()
    x_j = jstq.issq_stft(Tx_np)
    # float32 sums over 257 rows, in another order on the tensor path
    assert np.allclose(tstq.issq_stft(Tx_np), x_j, rtol=1e-6, atol=1e-6)
    assert np.allclose(tstq.issq_stft(Tx), x_j, rtol=1e-5, atol=1e-5)
    na = Tx.shape[0]
    rng = np.random.default_rng(4)
    cc = rng.integers(0, na, (N, 2))
    cc[::5, 0] = -1
    cw = np.full((N, 2), 4)
    out_j = jstq.issq_stft(Tx_np, cc=cc, cw=cw)
    out_t = tstq.issq_stft(Tx, cc=cc, cw=cw)
    assert out_t.shape == out_j.shape == (3, N)
    assert np.allclose(out_t, out_j, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('grid', [None, np.linspace(.1, 2., 90)])
def test_stft_plan_from_jax_constants(grid):
    """The JAX plan's constants, carried across, equal the port's plan."""
    n_fft, fs, dtype = 96, 4., 'float32'
    win, dwin = jget_window(None, n_fft, n_fft, derivative=True, dtype=dtype)
    Sfs = np.linspace(0, .5 * fs, n_fft // 2 + 1, dtype=dtype)
    ssq = Sfs if grid is None else grid
    carried = stft_plan_from_numpy(win, dwin, Sfs, grid,
                                   params=jbin_params(ssq, False))
    own = stft_plan(None, grid, n_fft, n_fft, fs, dtype)
    for a, b in zip(carried, own):
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        else:
            assert a == b
    with pytest.raises(ValueError):
        stft_plan_from_numpy(win, dwin, Sfs, params=dict(
            carried.params, dv=1.))


def test_phase_stft_vs_jax():
    from ssqueezepy_tpu.ops.phase import phase_stft as jphase_stft
    from ssqueezepy_tpu_torch.ops.phase import phase_stft
    x = _chirp(900)
    Sx, dSx = tstq.stft(x, n_fft=64, derivative=True, device='cpu')
    Sfs = np.linspace(0, .5, 33, dtype=np.float32)
    w_t = phase_stft(Sx, dSx, Sfs).numpy()
    w_j = np.asarray(jphase_stft(Sx.numpy(), dSx.numpy(), Sfs))
    assert np.array_equal(np.isinf(w_t), np.isinf(w_j))
    fin = np.isfinite(w_j)
    assert np.abs(w_t[fin] - w_j[fin]).max() <= 1e-5 * np.abs(w_j[fin]).max()


def test_stft_plan_memo_and_tables():
    p1 = stft_plan(None, None, 64, 64, 1., 'float32')
    assert stft_plan(None, None, 64, 64, 1., 'float32') is p1
    grid = np.linspace(0, .5, 40)
    assert stft_plan(None, grid, 64, 64, 1., 'float32') is \
        stft_plan(None, grid.copy(), 64, 64, 1., 'float32')
    H = conv_table(p1.window, 64, 960, True, 'float32', 'cpu')
    assert H.shape == (33, 960) and H.dtype == torch.complex64
    assert conv_table(p1.window, 64, 960, True, 'float32', 'cpu') is H


def _cube(W):
    """A callable squeezing both packages can run: Sx * |Sx|."""
    return W * W.abs()


# the port's route differs from the JAX package's at hop 1 without
# get_dWx: the table kernel's bins (B6) against bins of an explicit w
@pytest.mark.parametrize('hop,get_dWx,squeezing,dtype,same_route', [
    (1, False, 'abs', 'float32', False),
    (1, False, 'lebesgue', 'float64', False),
    (1, False, 'callable', 'float32', False),
    (2, False, 'abs', 'float64', True),
    (3, False, 'callable', 'float64', True),
    (1, True, 'lebesgue', 'float64', True),
    (2, True, 'abs', 'float32', True)])
def test_ssq_stft_squeezing_vs_jax(hop, get_dWx, squeezing, dtype,
                                   same_route):
    """'abs', 'lebesgue' and a callable squeezing at hop 1 (the table
    kernel's bins, then the scatter from bins) and at hop > 1 or with
    get_dWx (the phase transform, then the generic scatter)."""
    x = _noise(900, dtype, seed=41)
    kw = dict(n_fft=96, hop_len=hop, get_dWx=get_dWx, dtype=dtype, fs=2.,
              squeezing=_cube if squeezing == 'callable' else squeezing,
              astensor=False)
    out_j = jstq.ssq_stft(x, **kw)
    out_t = tstq.ssq_stft(x, device='cpu', **kw)
    assert len(out_t) == len(out_j) == (5 if get_dWx else 4)
    Tx_j, Sx_j, fr_j, Sfs_j = out_j[:4]
    Tx_t, Sx_t, fr_t, Sfs_t = out_t[:4]
    assert np.array_equal(fr_t, fr_j) and np.array_equal(Sfs_t, Sfs_j)
    tol = TOL[dtype]
    assert _rel(Sx_t, Sx_j) <= tol
    if get_dWx:
        assert _rel(out_t[4], out_j[4]) <= tol
    if same_route and dtype == 'float64':
        assert _rel(Tx_t, Tx_j) <= 1e-9
    else:
        _bins_criterion(Tx_t, Tx_j)


@pytest.mark.parametrize('hop,get_dWx,squeezing', [
    (1, False, 'sum'), (2, True, 'abs'), (1, True, 'lebesgue')])
def test_ssq_stft_get_w_vs_jax(hop, get_dWx, squeezing):
    """float64: (Tx, Sx, ssq_freqs, Sfs, w[, dSx]), w the STFT phase
    transform offset from Sfs, Tx through the generic scatter."""
    x = _noise(900, 'float64', seed=42)
    kw = dict(n_fft=96, hop_len=hop, get_w=True, get_dWx=get_dWx,
              squeezing=squeezing, dtype='float64', astensor=False)
    out_j = jstq.ssq_stft(x, **kw)
    out_t = tstq.ssq_stft(x, device='cpu', **kw)
    assert len(out_t) == len(out_j) == (6 if get_dWx else 5)
    assert _rel(out_t[1], out_j[1]) <= 1e-9
    w_t, w_j = out_t[4], out_j[4]
    inf = np.isinf(w_j)
    assert np.array_equal(np.isinf(w_t), inf)
    assert np.abs(w_t[~inf] - w_j[~inf]).max() <= 1e-9 * np.abs(
        w_j[~inf]).max()
    assert _rel(out_t[0], out_j[0]) <= 1e-9
    if get_dWx:
        assert _rel(out_t[5], out_j[5]) <= 1e-9


# every squeezing, hop_len > 1, get_dWx, get_w and 2-D input are ported
# (compared with the JAX package above and in test_torch_stft_batch.py);
# get_w on 2-D input raises, whatever the other options, with the JAX
# package's own message, and `stft` takes no 3-D input
@pytest.mark.parametrize('kw', [
    dict(x2d=True), dict(hop_len=2, squeezing='abs', x2d=True),
    dict(squeezing='abs', x2d=True),
    dict(squeezing=lambda v: abs(v), x2d=True), dict(get_w=True, x2d=True),
    dict(get_dWx=True, squeezing='lebesgue', x2d=True)],
    ids=lambda kw: '%s=%s' % next((k, getattr(v, '__name__', v))
                                  for k, v in kw.items()))
def test_ssq_stft_outside_slice_raises(kw):
    kw = dict(kw, get_w=True)
    x = _noise(600)
    if kw.pop('x2d', False):
        x = np.stack([x, x])
    for ssq_stft, dev in ((jstq.ssq_stft, {}),
                          (tstq.ssq_stft, dict(device='cpu'))):
        with pytest.raises(NotImplementedError,
                           match='unsupported with batched input'):
            ssq_stft(x, **kw, **dev)
    with pytest.raises(ValueError, match='1D or 2D'):
        tstq.stft(x[None], device='cpu')


def test_stft_default_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match='CUDA'):
        tstq.ssq_stft(_noise(600))
    with pytest.raises(RuntimeError, match='CUDA'):
        tstq.stft(_noise(600))


def test_stft_conv_checks_inputs():
    xh = torch.zeros(960, dtype=torch.complex64)
    H = torch.zeros((33, 960), dtype=torch.complex64)
    with pytest.raises(ValueError):
        stft_conv(xh, H[:, :512], None, 100)
    with pytest.raises(TypeError):
        stft_conv(xh, H.to(torch.complex128), None, 100)
    with pytest.raises(ValueError):
        stft_conv(xh, H, None, 2000)
    with pytest.raises(ValueError):
        stft_conv(xh, H, None, 100, bins=dict(Sfs=torch.zeros(33)))
