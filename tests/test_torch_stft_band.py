# -*- coding: utf-8 -*-
"""The band plan of the STFT table kernel (`ops/stft_conv.py`:
`stft_tables`, `fsst2_tables`, `_banded`; `ops/stft_cuda.py::
BandedTable`) against the JAX package's (`_band_plan`, `_band_plan_bank`,
`_conv_filterbank_packed`, `_fsst2_tables_packed` of
`ssqueezepy_tpu/ops/stft_conv.py`), on the CPU:

  * at Np2 = 4096 (both packages split it 64 x 64) the port's bands equal
    the JAX package's, pair and bank, and its packed float64 tables equal
    the JAX ones within 1e-12 of max;
  * on the port's own split (Np2 = 4608 = 72 x 64, 2048 = 64 x 32) each
    row's dropped mass is at most 1e-7 of its total, starts 8-aligned,
    one width;
  * the banded plain versions (B6 modes 0-2, B7 modes 3-4) against the
    full-table ones, one signal and a batch;
  * public float32 `stft`, `ssq_stft` (and `get_w`), `ssq_stft2` (and
    `get_w`) on banded tables against the JAX package's XLA path and its
    banded kernel in interpret mode;
  * a rectangular window, float64 and `stft_band=False` on full tables,
    outputs bit-identical to the `conv_table` route; batched rows and a
    row block bit-identical to one signal and all rows; malformed bands
    raising; the adjoint of the banded plain version.

Tolerances: Sx, dSx, V within 2e-5 of max in float32 (the dropped 1e-7
tail and float32 rounding), k flips <= 1% of cells, Tx by the bins
criterion (column sums 1e-4 of max, energy 5e-3; order 2: 1e-4, cells
over 1e-3 of max on < 2%, energy 0.02), as `tests/test_torch_stft.py`
and `tests/test_torch_order2.py` hold the port to the JAX package. The
JAX package's interpret-mode `stft` and `ssq_stft(get_w=True)` do not
reach its banded kernel on the CPU (they lower `pallas_call` without
interpret mode), so those compare against the JAX `stft_conv(...,
interpret=True)` that they would call.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import ssqueezepy_tpu as jstq
from ssqueezepy_tpu.configs import configure as jconfigure, reset_config
from ssqueezepy_tpu.models.ssq_stft import _fsst2_bank as j_fsst2_bank
from ssqueezepy_tpu.models.stft import _window_key
from ssqueezepy_tpu.models.windows import get_window as jget_window
from ssqueezepy_tpu.ops.stft_conv import (
    stft_conv as jstft_conv, _band_plan, _band_plan_bank, _bank_key,
    _conv_filterbank_packed, _fsst2_tables_packed)

import ssqueezepy_tpu_torch as tstq
from ssqueezepy_tpu_torch.configs import Config, _from_env, configure
from ssqueezepy_tpu_torch.models.ssq_stft import fsst2_plan, stft_plan
from ssqueezepy_tpu_torch.models.stft import signal_spectrum
from ssqueezepy_tpu_torch.ops import stft_conv as tables_mod
from ssqueezepy_tpu_torch.ops.ssq_cuda import scatter_kv_plain
from ssqueezepy_tpu_torch.ops.ssq_kernels import compute_bins
from ssqueezepy_tpu_torch.ops.stft_conv import (
    conv_bank, conv_table, fsst2_tables, row_block, stft_tables)
from ssqueezepy_tpu_torch.ops.stft_cuda import (
    BandedTable, StftConvGrad, fsst2_conv, fsst2_conv_plain, fsst2_w,
    split_fft_len, stft_conv, stft_conv_plain)
from torch_jax_reference import xla_reference  # noqa: F401

TOL = 2e-5


def _np(c):
    if isinstance(c, torch.Tensor):
        return c.detach().numpy()
    if hasattr(c, 're'):
        return np.asarray(c.re) + 1j * np.asarray(c.im)
    return np.asarray(c)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _noise(shape, dtype='float32', seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _bins_criterion(Tx_t, Tx_j):
    Tx_t, Tx_j = _np(Tx_t), _np(Tx_j)
    m = np.abs(Tx_j).max()
    assert np.abs(Tx_t.sum(-2) - Tx_j.sum(-2)).max() < 1e-4 * m
    e_t, e_j = np.abs(Tx_t).sum(), np.abs(Tx_j).sum()
    assert abs(e_t - e_j) / e_j < 5e-3


def _bins2_criterion(Tx_t, Tx_j):
    Tx_t, Tx_j = _np(Tx_t), _np(Tx_j)
    m = np.abs(Tx_j).max()
    assert np.abs(Tx_t.sum(-2) - Tx_j.sum(-2)).max() < 1e-4 * m
    assert (np.abs(Tx_t - Tx_j) > 1e-3 * m).mean() < 0.02
    e_t, e_j = np.abs(Tx_t).sum(), np.abs(Tx_j).sum()
    assert abs(e_t - e_j) / e_j < 0.02


def _pair(n_fft, dtype='float32'):
    sp = stft_plan(None, None, n_fft, n_fft, 1., dtype)
    return sp, np.stack([sp.window, sp.diff_window])


@pytest.fixture
def band_off():
    configure(stft_band=False)
    try:
        yield
    finally:
        configure(stft_band=True)


# ---- the plan and the packed tables against the JAX package's ---------------
@pytest.mark.parametrize('n_fft', [128, 256])
def test_band_plan_and_tables_equal_jax(n_fft):
    N = 3900
    Np2 = 4096
    assert split_fft_len(Np2) == (64, 64)
    sp, pair = _pair(n_fft)
    w, dw = jget_window(None, n_fft, n_fft, derivative=True)
    assert np.array_equal(np.asarray(w), sp.window)
    wk = _window_key(w, dw)
    r0_j, br_j = _band_plan(wk, n_fft, Np2, True)
    band = tables_mod._banded(pair, n_fft, Np2, True, 'float64', 'cpu')
    assert isinstance(band, BandedTable) and band.br == br_j == 24
    assert np.array_equal(band.r0_host, r0_j)
    assert np.array_equal(band.r0.numpy(), r0_j) and band.r0.dtype == \
        torch.int32
    # the float32 tables the public calls take share the plan
    band32 = tables_mod._banded(pair, n_fft, Np2, True, 'float32', 'cpu')
    assert band32.br == 24 and np.array_equal(band32.r0_host, r0_j)
    Hbre, Hbim, Hdbre, Hdbim = _conv_filterbank_packed(
        wk, n_fft, Np2, True, 'float64')[:4]
    for q, (re, im) in enumerate(((Hbre, Hbim), (Hdbre, Hdbim))):
        ref = re + 1j * im
        assert np.abs(band.t[q].numpy() - ref).max() <= \
            1e-12 * np.abs(ref).max()

    bank = fsst2_plan(None, None, n_fft, n_fft, 1., 'float32').bank
    assert np.array_equal(bank, j_fsst2_bank(None, n_fft, n_fft, 'float32'))
    bkey = _bank_key(bank)
    plan_j = _band_plan_bank(bkey, n_fft, Np2, True)
    packed, _ = _fsst2_tables_packed(bkey, n_fft, Np2, True, 'float64')
    bb = tables_mod._banded(bank, n_fft, Np2, True, 'float64', 'cpu')
    assert bb.br == plan_j[1] == 24 and np.array_equal(bb.r0_host,
                                                        plan_j[0])
    assert bb.t.shape == (5, n_fft // 2 + 1, 24, 64)
    for q in range(5):
        ref = packed[2 * q] + 1j * packed[2 * q + 1]
        assert np.abs(bb.t[q].numpy() - ref).max() <= \
            1e-12 * np.abs(ref).max()


@pytest.mark.parametrize('N,n_fft,Np2,br_pair', [(4000, 512, 4608, 16),
                                                 (1900, 128, 2048, 24)])
@pytest.mark.parametrize('which', ['pair', 'bank'])
def test_band_geometry_on_own_split(N, n_fft, Np2, br_pair, which):
    """Each row keeps all but 1e-7 of the L1 mass of max |table| over the
    windows, from an 8-aligned start, one width for every row."""
    assert signal_spectrum(torch.zeros(N), n_fft, 'reflect').shape[-1] \
        == Np2
    f1, f2 = split_fft_len(Np2)
    windows = (_pair(n_fft)[1] if which == 'pair' else
               fsst2_plan(None, None, n_fft, n_fft, 1., 'float32').bank)
    band = tables_mod._banded(windows, n_fft, Np2, True, 'float32', 'cpu')
    r0, br = band.r0_host, band.br
    if which == 'pair':
        assert br == br_pair
    assert br % 8 == 0 and 8 <= br <= f1 // 2
    assert r0.shape == (n_fft // 2 + 1,)
    assert (r0 % 8 == 0).all() and ((0 <= r0) & (r0 < f1)).all()
    mag = torch.stack([tables_mod._build_table(w, n_fft, Np2, True,
                                               torch.complex128, 'cpu').abs()
                       for w in windows]).amax(0).numpy()
    mass = mag.reshape(-1, f1, f2).sum(-1)
    inside = ((np.arange(f1)[None] - r0[:, None]) % f1) < br
    dropped = np.where(inside, 0, mass).sum(-1)
    assert (dropped <= 1e-7 * mass.sum(-1)).all()


# ---- the banded plain versions against the full-table ones ----------------
def _kernel_inputs(shape, n_fft=128):
    N = shape[-1]
    x = torch.as_tensor(_noise(shape, seed=3))
    xh = signal_spectrum(x, n_fft, 'reflect')
    sp, _ = _pair(n_fft)
    Np2 = xh.shape[-1]
    bins = dict(Sfs=torch.as_tensor(sp.Sfs), params=sp.params,
                gamma=10 * float(np.finfo(np.float32).eps), flipud=False)
    fp = fsst2_plan(None, None, n_fft, n_fft, 1., 'float32')
    banded = stft_tables(sp.window, sp.diff_window, n_fft, Np2, True,
                         'float32', 'cpu') + (
        fsst2_tables(fp.bank, n_fft, Np2, True, 'float32', 'cpu'),)
    full = (conv_table(sp.window, n_fft, Np2, True, 'float32', 'cpu'),
            conv_table(sp.diff_window, n_fft, Np2, True, 'float32', 'cpu'),
            conv_bank(fp.bank, n_fft, Np2, True, 'float32', 'cpu'))
    assert all(isinstance(t, BandedTable) for t in banded)
    c = torch.full((n_fft // 2 + 1,), sp.const)
    return N, xh, bins, banded, full, c


@pytest.mark.parametrize('mode', ['sx', 'sx_dsx', 'bins', 'fsst2', 'w2'])
@pytest.mark.parametrize('shape', [(3900,), (2, 3900)], ids=['one', 'batch'])
def test_banded_plain_vs_full_plain(mode, shape):
    N, xh, bins, (H, Hd, B), (Hf, Hdf, Bf), c = _kernel_inputs(shape)
    nb = bins['params']['omax'] + 1
    if mode in ('sx', 'sx_dsx', 'bins'):
        Hd_, Hdf_ = (None, None) if mode == 'sx' else (Hd, Hdf)
        bins_ = bins if mode == 'bins' else None
        S_b, o_b = stft_conv_plain(xh, H, Hd_, N, 2., bins_)
        S_f, o_f = stft_conv_plain(xh, Hf, Hdf_, N, 2., bins_)
        # the wrapper on the CPU is the plain version
        S_w, o_w = stft_conv(xh, H, Hd_, N, 2., bins_)
        assert torch.equal(S_w, S_b)
    elif mode == 'fsst2':
        S_b, o_b = fsst2_conv_plain(xh, B, N, 2., bins)
        S_f, o_f = fsst2_conv_plain(xh, Bf, N, 2., bins)
        S_w, o_w = fsst2_conv(xh, B, N, 2., bins)
        assert torch.equal(S_w, S_b) and torch.equal(o_w, o_b)
    else:
        S_b, w_b = fsst2_w(xh, B, N, 2., bins['Sfs'], bins['gamma'])
        S_f, w_f = fsst2_w(xh, Bf, N, 2., bins['Sfs'], bins['gamma'])
        assert (torch.isinf(w_b) != torch.isinf(w_f)).double().mean() \
            <= 1e-3
        o_b, o_f = (torch.where(v, k, -1) for k, v in (
            compute_bins(w, bins['params'], False) for w in (w_b, w_f)))
    assert S_b.shape == shape[:-1] + (65, N)
    assert _rel(S_b, S_f) <= TOL
    if mode == 'sx_dsx':
        assert _rel(o_b, o_f) <= TOL
    elif mode != 'sx':
        assert (o_b != o_f).double().mean() <= 0.01
        _bins_criterion(scatter_kv_plain(S_b, o_b, c, nb),
                        scatter_kv_plain(S_f, o_f, c, nb))


# ---- public calls against the JAX package ---------------------------------
N_PUB, NFFT_PUB = 3900, 128


def _jax_banded_stft(x, derivative):
    """The JAX package's banded table kernel in interpret mode, as its
    `stft` calls it at hop 1."""
    w, dw = jget_window(None, NFFT_PUB, NFFT_PUB, derivative=True)
    wk = _window_key(w, dw if derivative else None)
    S, D = jstft_conv(jnp.asarray(x), 1., NFFT_PUB, N_PUB, wk, True,
                      derivative, 'reflect', N_PUB + NFFT_PUB - 1,
                      'float32', interpret=True)
    return _np(S), None if D is None else _np(D)


def test_public_stft_banded_vs_jax():
    x = _noise(N_PUB, seed=5)
    sp, _ = _pair(NFFT_PUB)
    assert isinstance(stft_tables(sp.window, sp.diff_window, NFFT_PUB, 4096,
                                  True, 'float32', 'cpu')[0], BandedTable)
    Sx_t, dSx_t = tstq.stft(x, n_fft=NFFT_PUB, derivative=True,
                            device='cpu')
    Sx_j, dSx_j = jstq.stft(x, n_fft=NFFT_PUB, derivative=True)
    assert _rel(Sx_t, Sx_j) <= TOL and _rel(dSx_t, dSx_j) <= TOL
    Sx_b, dSx_b = _jax_banded_stft(x, True)
    assert _rel(Sx_t, Sx_b) <= TOL and _rel(dSx_t, dSx_b) <= TOL
    # Sx alone reads H of the same memoized pair: bit-identical Sx
    assert torch.equal(tstq.stft(x, n_fft=NFFT_PUB, device='cpu'), Sx_t)
    Sx_b1, _ = _jax_banded_stft(x, False)
    assert _rel(Sx_t, Sx_b1) <= TOL


@pytest.mark.parametrize('get_w', [False, True])
def test_public_ssq_stft_banded_vs_jax(get_w):
    x = _noise(N_PUB, seed=6)
    kw = dict(n_fft=NFFT_PUB, astensor=False, get_w=get_w)
    out_t = tstq.ssq_stft(x, device='cpu', **kw)
    out_j = jstq.ssq_stft(x, **kw)
    assert _rel(out_t[1], out_j[1]) <= TOL
    _bins_criterion(out_t[0], out_j[0])
    if get_w:
        w_t, w_j = out_t[4], np.asarray(out_j[4])
        fin = np.isfinite(w_j) & np.isfinite(w_t)
        assert (np.isfinite(w_t) != np.isfinite(w_j)).mean() <= 1e-3
        assert (np.abs(w_t - w_j)[fin] > 1e-3 * np.abs(w_j[fin]).max()
                ).mean() <= 0.01
        Sx_b, _ = _jax_banded_stft(x, True)
        assert _rel(out_t[1], Sx_b) <= TOL
        return
    try:
        jconfigure(backend='tpu', pallas_interpret=True, stft_band=True)
        out_b = jstq.ssq_stft(x, **kw)
    finally:
        reset_config()
    assert _rel(out_t[1], out_b[1]) <= TOL
    _bins_criterion(out_t[0], out_b[0])


@pytest.mark.parametrize('get_w', [False, True])
def test_public_ssq_stft2_banded_vs_jax(get_w):
    # a linear chirp and noise, as tests/test_torch_order2.py holds order 2
    n = np.arange(N_PUB)
    x = (np.cos(2 * np.pi * (0.05 * n + 0.1 / (2 * N_PUB) * n ** 2))
         + 0.1 * _noise(N_PUB, 'float64', seed=7)).astype(np.float32)
    kw = dict(n_fft=NFFT_PUB, astensor=False, get_w=get_w)
    out_t = tstq.ssq_stft2(x, device='cpu', **kw)
    out_j = jstq.ssq_stft2(x, **kw)
    try:
        # full-precision products, as tests/test_torch_order2.py runs it
        jconfigure(backend='tpu', pallas_interpret=True, stft_band=True,
                   ssq_lowprec_deriv=False)
        out_b = jstq.ssq_stft2(x, **kw)
    finally:
        reset_config()
    for ref in (out_j, out_b):
        assert np.array_equal(out_t[2], ref[2])
        assert _rel(out_t[1], ref[1]) <= TOL
        _bins2_criterion(out_t[0], ref[0])
        if get_w:
            w_t, w_j = out_t[4], np.asarray(ref[4])
            assert (np.isinf(w_t) != np.isinf(w_j)).mean() <= 0.01


# ---- full tables where the band is not taken -------------------------------
@pytest.mark.parametrize('case', ['rect', 'float64', 'band_off'])
def test_full_tables_where_no_band(case, request):
    if case == 'band_off':
        request.getfixturevalue('band_off')
    dtype = 'float64' if case == 'float64' else 'float32'
    N, n_fft = 1000, 128
    window = np.ones(n_fft) if case == 'rect' else None
    sp = stft_plan(window, None, n_fft, n_fft, 1., dtype)
    x = _noise(N, dtype, seed=8)
    xh = signal_spectrum(torch.as_tensor(x), n_fft, 'reflect')
    Np2 = xh.shape[-1]
    if case == 'rect':
        assert tables_mod._banded(np.stack([sp.window, sp.diff_window]),
                                  n_fft, Np2, True, dtype, 'cpu') is None
    H, Hd = stft_tables(sp.window, sp.diff_window, n_fft, Np2, True, dtype,
                        'cpu')
    Hf = conv_table(sp.window, n_fft, Np2, True, dtype, 'cpu')
    Hdf = conv_table(sp.diff_window, n_fft, Np2, True, dtype, 'cpu')
    assert H is Hf and Hd is Hdf
    fp = fsst2_plan(window, None, n_fft, n_fft, 1., dtype)
    bank = fsst2_tables(fp.bank, n_fft, Np2, True, dtype, 'cpu')
    assert bank is conv_bank(fp.bank, n_fft, Np2, True, dtype, 'cpu')
    Sx, dSx = tstq.stft(x, window, n_fft=n_fft, derivative=True,
                        dtype=dtype, device='cpu')
    Sx_f, dSx_f = stft_conv(xh, Hf, Hdf, N, 1.)
    assert torch.equal(Sx, Sx_f) and torch.equal(dSx, dSx_f)
    Tx, V, _, _ = tstq.ssq_stft2(x, window, n_fft=n_fft, dtype=dtype,
                                 device='cpu')
    assert torch.equal(V, fsst2_w(xh, bank, N, 1., torch.as_tensor(fp.Sfs),
                                  10 * float(np.finfo(dtype).eps))[0])


def test_config_and_env(monkeypatch):
    assert Config().stft_band is True
    monkeypatch.setenv('SSQTORCH_STFT_BAND', '0')
    assert _from_env(Config()).stft_band is False
    monkeypatch.setenv('SSQTORCH_STFT_BAND', '1')
    assert _from_env(Config()).stft_band is True


# ---- batch rows, row blocks, streaming, checks, the adjoint ----------------
def test_batched_rows_bit_identical():
    x = _noise((2, 1900), seed=9)
    for fn in (lambda z: (tstq.stft(z, n_fft=128, device='cpu'),),
               lambda z: tstq.ssq_stft(z, n_fft=128, device='cpu')[:2],
               lambda z: tstq.ssq_stft2(z, n_fft=128, device='cpu')[:2]):
        outs = fn(x)
        for b in range(2):
            for o, o1 in zip(outs, fn(x[b])):
                assert torch.equal(o[b], o1)


def test_row_block_bit_identical():
    N, xh, bins, (H, Hd, B), _, _ = _kernel_inputs((1900,))
    lo, hi = 20, 41
    Sx, k = stft_conv(xh, H, Hd, N, 1., bins)
    blk = dict(bins, Sfs=bins['Sfs'][lo:hi])
    Hb, Hdb = row_block(H, lo, hi), row_block(Hd, lo, hi)
    assert Hb.br == H.br and torch.equal(Hb.r0, H.r0[lo:hi])
    Sx_b, k_b = stft_conv(xh, Hb, Hdb, N, 1., blk)
    assert torch.equal(Sx_b, Sx[lo:hi]) and torch.equal(k_b, k[lo:hi])
    V, kv = fsst2_conv(xh, B, N, 1., bins)
    Bb = row_block(B, lo, hi)
    assert Bb.t.shape == (5, hi - lo, B.br, B.t.shape[-1])
    V_b, kv_b = fsst2_conv(xh, Bb, N, 1., blk)
    assert torch.equal(V_b, V[lo:hi]) and torch.equal(kv_b, kv[lo:hi])
    full = conv_bank(fsst2_plan(None, None, 128, 128, 1., 'float32').bank,
                     128, xh.shape[-1], True, 'float32', 'cpu')
    assert torch.equal(row_block(full, lo, hi), full[:, lo:hi])


def test_streaming_plans_take_banded_tables():
    one = tstq.StreamingSSQSTFT(1024, n_fft=128, device='cpu')
    two = tstq.StreamingSSQSTFT2(1024, n_fft=128, device='cpu')
    assert isinstance(one._H, BandedTable) and isinstance(one._Hd,
                                                          BandedTable)
    assert isinstance(two._tables, BandedTable)


def test_malformed_bands_raise():
    N, xh, bins, (H, Hd, B), _, _ = _kernel_inputs((1900,))
    f1 = H.f1
    bad = [BandedTable(H.t, H.r0.long(), f1),
           BandedTable(H.t, H.r0[1:], f1),
           BandedTable(H.t, torch.full_like(H.r0, f1), f1),
           BandedTable(H.t, H.r0, f1 // 2)]
    for band in bad:
        with pytest.raises(ValueError):
            stft_conv(xh, band, None, N)
    with pytest.raises(ValueError):
        stft_conv(xh, H, BandedTable(Hd.t, (Hd.r0 + 8) % f1, f1), N)
    with pytest.raises(TypeError):
        stft_conv(xh, H, conv_table(_pair(128)[0].diff_window, 128,
                                    xh.shape[-1], True, 'float32', 'cpu'), N)
    with pytest.raises(ValueError):
        fsst2_conv(xh, B.plane(0), N, 1., bins)


def test_banded_adjoint_float64():
    """<J u, v> = <u, J^T v> for the banded B6 in mode 1 (xh and the
    band's packed rows), float64, J u by forward-mode AD of the plain
    version."""
    n_fft, N = 128, 1900
    sp, pair = _pair(n_fft, 'float64')
    rng = np.random.default_rng(4)
    xh = signal_spectrum(torch.as_tensor(rng.standard_normal(N)), n_fft,
                         'reflect')
    band = tables_mod._banded(pair, n_fft, xh.shape[-1], True, 'float64',
                              'cpu')
    assert band is not None
    H, Hd = band.plane(0), band.plane(1)

    def f(xh, h, hd):
        return stft_conv(xh, H.with_t(h), Hd.with_t(hd), N, 2.)

    def crand(shape):
        return torch.as_tensor(rng.standard_normal(shape)
                               + 1j * rng.standard_normal(shape))
    prim = (xh, H.t, Hd.t)
    tang = tuple(crand(p.shape) for p in prim)
    _, Ju = torch.func.jvp(lambda *a: stft_conv_plain(
        a[0], H.with_t(a[1]), Hd.with_t(a[2]), N, 2.), prim, tang)
    v = tuple(crand(o.shape) for o in Ju)
    ins = tuple(p.clone().requires_grad_(True) for p in prim)
    outs = f(*ins)
    assert isinstance(outs[0].grad_fn, StftConvGrad._backward_cls)
    JTv = torch.autograd.grad(outs, ins, v)
    lhs = sum((torch.conj(b) * a).sum().real for a, b in zip(Ju, v))
    rhs = sum((torch.conj(g) * t).sum().real for g, t in zip(JTv, tang))
    assert abs(float(lhs - rhs)) <= 1e-10 * abs(float(lhs))
