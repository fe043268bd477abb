# -*- coding: utf-8 -*-
"""Stage-1 support pruning of the CWT kernel (`csrc/cwt_bins.cu`, B1, B3,
B3b and B8) on the CPU, with no card and no kernel run:

  (a) the port's support plan of the closed-form GMW
      (`ops/cwt_cuda.py::support_klims`) equals the JAX package's
      `ops/cwt_pallas.py::support_klims` (one more row for order 2, as
      its `models/ssq_cwt2.py` adds) where the two four-step splits
      agree, float64's plan covering float32's;
  (b) the pruning is exact: the port's closed-form psih, evaluated in
      float32 and float64 as the kernel forms w = a xi, is 0.0 on every
      bin of the rows at or beyond each scale's limit, the headline plan
      included; a wavelet table (`table_klims`) is zero beyond its limit
      and nonzero in its last kept row;
  (c) the level skip of the radix-4 engine: inputs zero from column
      klim <= L / 2^j on, each kept column copied to its 2^j positions
      and run from level j + 1, equal the unpruned stage (level 1 in
      pairs, then the passes from level 2) bit for bit in float32 and
      float64, apart from the sign of a zero; the passes' addresses are
      the layout test's (`tests/test_torch_cwt_layout.py::_passes`), and
      the copies' stores cover each position once, free of bank
      conflicts; the mixed engine's skip of its leading Stockham passes
      (`csrc/dft_mixed.cuh`) the same way;
  (d) a CPU model of the pruned four-step over a batch, each row g taking
      the limit of its scale g % na, equals the unpruned model bit for bit
      (but for signed zeros) and the plain CWT.
"""
import numpy as np
import pytest
import torch

import ssqueezepy_tpu as jstq
from ssqueezepy_tpu.ops.cwt_pallas import support_klims as jax_klims

import ssqueezepy_tpu_torch as tstq
from ssqueezepy_tpu_torch.models.cwt import resolve_wavelet
from ssqueezepy_tpu_torch.ops.cwt_cuda import (
    bins_plan, cwt_fused_plain, four_step, stage1_rows, support_klims, swz,
    table_klims, wavelet_table)
from ssqueezepy_tpu_torch.ops.stft_cuda import radices
from test_torch_cwt_layout import _passes, _wavefronts
from torch_jax_reference import xla_reference  # noqa: F401

# padded length: (signal length whose scales it takes, scales kept)
SPLITS = {4096: (2500, None), 16384: (10000, None),
          262144: (160000, 300),                 # the headline plan
          160000: (160000, 300)}                 # unpadded, mixed engine
# unpadded lengths whose split the JAX package's kernel does not take:
# f2 = 1 (7), 5 (30) and odd (4725 = 75 x 63)
ODD = {7: (7, None), 30: (30, None), 4725: (4725, None)}


@pytest.fixture
def one_thread():
    """torch on one thread for a test of many mid-sized elementwise ops,
    whose thread pools would otherwise contend with the other test
    workers' on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
WAVELETS = {'gmw': {}, 'gmw order 1': {'order': 1}}


def _scales(n_up, config=None, lib=tstq):
    N, cut = {**SPLITS, **ODD}[n_up]
    wv = lib.Wavelet(('gmw', dict(config or {})))
    sc = np.asarray(lib.process_scales('log-piecewise', N, wv))
    return sc[:cut].ravel() if cut else sc.ravel()


@pytest.mark.parametrize('n_up', sorted(SPLITS))
@pytest.mark.parametrize('name', sorted(WAVELETS))
def test_support_klims_equal_the_jax_package(n_up, name):
    config = WAVELETS[name]
    scales = _scales(n_up, config)
    jw = jstq.Wavelet(('gmw', dict(config)))
    tw = resolve_wavelet(('gmw', dict(config)), N=SPLITS[n_up][0])
    want = np.asarray(jax_klims(jw, scales, n_up))
    rows0 = stage1_rows(n_up)
    got = support_klims(tw, scales, n_up, 'float32')
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        support_klims(tw, scales, n_up, 'float32', order2=True),
        np.minimum(want + 1, rows0))
    k64 = support_klims(tw, scales, n_up, 'float64')
    assert got.dtype == np.int32 and (k64 >= got).all()
    assert (got >= 1).all() and (k64 <= rows0).all()
    # a memo hit is the same plan
    assert support_klims(tw, scales, n_up, 'float32') is got


def test_headline_plan_prunes_as_planned():
    """The headline (293 scales, n_up = 262144 = 512 x 512, rows0 = 257):
    28.7% of the rows kept, klim quantiles 1 / 6 / 26 / 118 / 257, 48
    scales on row 0 alone, and the radix-4 levels stage 1 runs per row
    (8 unpruned, level 1 being fused) 4.73 on average."""
    scales = _scales(262144)
    wv = resolve_wavelet(('gmw', {}), N=160000)
    k = support_klims(wv, scales, 262144)
    assert (len(k), stage1_rows(262144)) == (293, 257)
    assert round(k.sum() / (293 * 257), 3) == 0.287
    np.testing.assert_array_equal(
        np.quantile(k, [.1, .25, .5, .75, .9]), [1, 6, 26, 118, 257])
    assert (k == 1).sum() == 48
    lg = 9
    j = np.array([0 if kl > 256 else max(
        jj for jj in range(1, lg + 1) if kl <= 512 >> jj) for kl in k])
    levels = np.where(j == 0, lg - 1, lg - j)
    assert round(levels.mean(), 2) == 4.73


def _kernel_w(scale, n_up, m, dtype):
    """w = a xi at bins `m` as the kernel forms it: xi = (T)(m 2 pi / n_up),
    then a xi in T."""
    xi = torch.as_tensor(m * (2 * np.pi / n_up), dtype=torch.float64)
    return torch.as_tensor(scale, dtype=dtype) * xi.to(dtype)


@pytest.mark.parametrize('n_up', sorted(SPLITS) + sorted(ODD))
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_closed_form_is_zero_beyond_the_limits(n_up, dtype, one_thread):
    scales = _scales(n_up)
    wv = resolve_wavelet(('gmw', {'dtype': dtype}), N={**SPLITS,
                                                       **ODD}[n_up][0])
    tdt = getattr(torch, dtype)
    f2, half = four_step(n_up)[1], n_up // 2 + 1
    k1 = support_klims(wv, scales, n_up, dtype)
    for a, kl in zip(scales, k1):             # one scale at a time
        m = np.arange(int(kl) * f2, half)
        if len(m):
            psih = wv.fn(_kernel_w(a, n_up, m, tdt), xp=torch)
            assert psih.dtype == tdt
            assert not psih.any(), (a, kl, int(psih.ne(0).sum()))
    # order 2's limits keep every row of order 1's, so they are exact too
    assert (support_klims(wv, scales, n_up, dtype, True) >= k1).all()
    # a limit one row short would cut a nonzero row somewhere
    cut = [(a, kl) for a, kl in zip(scales, k1) if kl > 2]
    if n_up in SPLITS:
        assert cut
    if cut:
        assert any(wv.fn(_kernel_w(a, n_up, np.arange((kl - 2) * f2, half),
                                    tdt), xp=torch).any() for a, kl in cut)


@pytest.mark.parametrize('n_up,N', [(4096, 2500), (16384, 10000),
                                     (3000, 3000)])   # 3000: mixed engine
@pytest.mark.parametrize('name', ['cmhat', 'morlet', 'bump'])
def test_table_zero_beyond_its_limit(n_up, N, name, one_thread):
    wv = resolve_wavelet((name, {'dtype': 'float64'}), N=N)
    sc = torch.as_tensor(np.asarray(tstq.process_scales('log-piecewise', N,
                                                        wv)).ravel())
    f2 = four_step(n_up)[1]
    for order2 in (False, True):
        table = wavelet_table(wv, sc, n_up, order2=order2)
        klims = table_klims(table, n_up)
        assert klims.dtype == torch.int32 and klims.shape == sc.shape
        assert int(klims.max()) <= stage1_rows(n_up)
        t = table if order2 else table[None]
        for a, kl in enumerate(klims.tolist()):
            assert not t[:, a, kl * f2:].any()
            last = t[:, a, (kl - 1) * f2:kl * f2]
            assert last.any() or (kl == 1 and not t[:, a].any())
        if name != 'bump':                    # bump's support is compact
            continue
        assert int(klims.min()) < stage1_rows(n_up)


# ---- (c) the radix-4 level skip, on the layout test's passes ------------

def _bfly(x0, x1, w):
    """csrc/cwt_bins.cu::bfly in the arrays' dtype: (x0 + w x1, x0 - w x1)
    of (re, im) pairs."""
    tr = w[0] * x1[0] - w[1] * x1[1]
    ti = w[0] * x1[1] + w[1] * x1[0]
    return (x0[0] + tr, x0[1] + ti), (x0[0] - tr, x0[1] - ti)


def _bitrev(i, lg):
    out = np.zeros_like(i)
    for t in range(lg):
        out |= ((i >> t) & 1) << (lg - 1 - t)
    return out


def _stage1_passes(x, P, planes, klim):
    """The radix-4 engine's stage 1 on `x` (planes * P, L) of (re, im)
    arrays, in `x`'s dtype: pruned at `klim` as `bins_stage1` prunes
    (`klim` > L/2: level 1 in pairs with twiddle 1, the passes from level
    2; else the L / 2^j columns m1 < L / 2^j, zero from klim on, copied
    to their 2^j positions, the passes from level j + 1). Returns the
    sequences in natural order and the first level run."""
    re, im = x
    nseq, L = re.shape
    lg, S, tw0 = L.bit_length() - 1, L + 1, L // 2
    dt = re.dtype
    mem = [np.zeros(tw0 + nseq * S, dt) for _ in range(2)]
    t = np.exp(2j * np.pi * np.arange(tw0) / L)
    mem[0][:tw0], mem[1][:tw0] = t.real.astype(dt), t.imag.astype(dt)
    pos = np.arange(L)
    at = tw0 + np.arange(nseq)[:, None] * S + pos
    col = _bitrev(pos, lg)                    # column at each position
    if klim > L // 2:
        s0 = 2
        a0, a1 = at[:, 0::2], at[:, 1::2]
        v0 = (re[:, col[0::2]], im[:, col[0::2]])
        v1 = (re[:, col[1::2]], im[:, col[1::2]])
        one = (dt.type(1), dt.type(0))
        y0, y1 = _bfly(v0, v1, one)
        for c in range(2):
            mem[c][a0], mem[c][a1] = y0[c], y1[c]
    else:
        j = max(jj for jj in range(1, lg + 1) if klim <= L >> jj)
        s0 = j + 1
        base = col[(pos >> j) << j]           # the block's first column
        live = base < klim
        for c, v in enumerate((re, im)):
            mem[c][at] = np.where(live, v[:, base], dt.type(0))
    for data, tws in _passes(L, P, S, s0, planes):
        v = [(mem[0][a], mem[1][a]) for a in data]
        w = [(mem[0][k], mem[1][k]) for k in tws]
        if len(v) == 4:
            v[0], v[1] = _bfly(v[0], v[1], w[0])
            v[2], v[3] = _bfly(v[2], v[3], w[0])
            v[0], v[2] = _bfly(v[0], v[2], w[1])
            v[1], v[3] = _bfly(v[1], v[3], w[2])
        else:
            v[0], v[1] = _bfly(v[0], v[1], w[0])
        for a, y in zip(data, v):
            mem[0][a], mem[1][a] = y
    return (mem[0][at], mem[1][at]), s0


def _case_klims(L):
    """(j, klim) for every j: the largest klim of its range, and the
    smallest where it has one, with j = 0 the unpruned rows0."""
    out = [(0, L // 2 + 1)]
    for j in range(1, L.bit_length()):
        out.append((j, L >> j))
        if (L >> (j + 1)) + 1 < L >> j:
            out.append((j, (L >> (j + 1)) + 1))
    return out


@pytest.mark.parametrize('L,j,klim', [(L, j, k) for L in (64, 512)
                                      for j, k in _case_klims(L)])
@pytest.mark.parametrize('planes', [1, 2, 5])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_level_skip_equals_the_unpruned_passes(L, j, klim, planes, dtype):
    P = 2
    rng = np.random.default_rng(L + 7 * j + klim)
    x = tuple(rng.standard_normal((planes * P, L)).astype(dtype)
              for _ in range(2))
    for v in x:
        v[:, klim:] = 0                        # beyond the support
        v[:, 0] = -0.0                         # signed zeros in the support
    full, s_full = _stage1_passes(x, P, planes, L // 2 + 1)
    pruned, s0 = _stage1_passes(x, P, planes, klim)
    assert (s_full, s0) == (2, 2 if j == 0 else j + 1)
    for a, b in zip(full, pruned):             # +0 == -0, no NaN here
        assert np.array_equal(a, b)
    # and both are the inverse DFT of the columns
    want = np.fft.ifft(x[0].astype(np.float64)
                       + 1j * x[1].astype(np.float64), axis=-1) * L
    tol = (2e-4 if dtype == 'float32' else 1e-11) * L
    np.testing.assert_allclose(pruned[0], want.real, atol=tol)
    np.testing.assert_allclose(pruned[1], want.imag, atol=tol)


def _skip_stores(plan, j):
    """`bins_stage1`'s stores of the pruned columns at level skip j, one
    (element indices per thread id, active) pair per copy r: thread e
    forms column p = e mod P of block start i = swz(e // P, w) << j and
    writes copy r at i + (r ^ rot) of sequence p (plane 0), rot the bits
    of its start that the walk leaves to the copy order."""
    L, P, S, sw = plan.f1, plan.P1, plan.S1, plan.sw1
    lgP = P.bit_length() - 1
    w, lgG = max(sw - j, 0), max(sw - lgP, 0)
    e = np.arange(P * (L >> j))
    t = e // P
    i = swz(t, w) << j
    rot = ((t & ((1 << lgG) - 1)) >> w) << lgP
    base = L // 2 + (e % P) * S + i
    return [(base + (r ^ rot), np.ones(e.size, bool))
            for r in range(1 << j)]


@pytest.mark.parametrize('n_up', [4096, 262144, 1 << 22])
@pytest.mark.parametrize('dtype,itemsize', [('float32', 8),
                                            ('float64', 16)])
@pytest.mark.parametrize('planes', [1, 2, 5])
def test_level_skip_stores_cover_and_free_of_bank_conflicts(n_up, dtype,
                                                            itemsize,
                                                            planes):
    """The pruned stage's stores write every position of each sequence
    once for every j, each in one wavefront per half-warp (float32) or
    quarter-warp (float64), at f1 = 64, the headline's 512 and 2048."""
    plan = bins_plan(n_up, itemsize, planes)
    L, P, S = plan.f1, plan.P1, plan.S1
    want = np.sort(np.add.outer(np.arange(P) * S, np.arange(L)).ravel()
                   + L // 2)
    for j in range(1, L.bit_length()):
        stores = _skip_stores(plan, j)
        got = np.sort(np.concatenate([a for a, _ in stores]))
        assert np.array_equal(got, want), j
        worst = max(_wavefronts(a, act, itemsize).max() for a, act in stores)
        assert worst == 1, (j, worst)


# ---- (c') the mixed engine's pass skip (Stockham, csrc/dft_mixed.cuh) ---

def _cmul(a, b):
    """dft::cmul on (re, im) pairs in their dtype."""
    return (a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0])


def _stockham(x, Ns0=1):
    """`dft::transform` in `x`'s dtype on (re, im) sequences (nseq, L),
    from the pass after the leading radices that multiply to Ns0 (the
    input then holds their result): each pass's butterflies as
    `stockham_pass` computes them, radix 4 and 2 by their formulas,
    3, 5 and 7 as sums of table-twiddle products."""
    re, im = x
    nseq, L = re.shape
    dt = re.dtype
    t = np.exp(2j * np.pi * np.arange(L) / L)
    tw = (t.real.astype(dt), t.imag.astype(dt))
    src = (re.copy(), im.copy())
    for R, Ns in radices(L):
        if Ns < Ns0:
            continue
        LR, tstep = L // R, L // (Ns * R)
        j = np.arange(LR)
        jm = j % Ns
        v = [(src[0][:, j], src[1][:, j])] + [
            _cmul((src[0][:, j + r * LR], src[1][:, j + r * LR]),
                  (tw[0][r * jm * tstep], tw[1][r * jm * tstep]))
            for r in range(1, R)]
        d = (j - jm) * R + jm
        dst = (np.zeros_like(re), np.zeros_like(im))
        if R == 2:
            ys = [(v[0][0] + v[1][0], v[0][1] + v[1][1]),
                  (v[0][0] - v[1][0], v[0][1] - v[1][1])]
        elif R == 4:
            s02 = (v[0][0] + v[2][0], v[0][1] + v[2][1])
            d02 = (v[0][0] - v[2][0], v[0][1] - v[2][1])
            s13 = (v[1][0] + v[3][0], v[1][1] + v[3][1])
            d13 = (v[1][0] - v[3][0], v[1][1] - v[3][1])
            ys = [(s02[0] + s13[0], s02[1] + s13[1]),
                  (d02[0] - d13[1], d02[1] + d13[0]),
                  (s02[0] - s13[0], s02[1] - s13[1]),
                  (d02[0] + d13[1], d02[1] - d13[0])]
        else:
            wt = [(tw[0][k * LR], tw[1][k * LR]) for k in range(R)]
            ys = []
            for k in range(R):
                acc = v[0]
                for r in range(1, R):
                    y = _cmul(v[r], wt[(r * k) % R])
                    acc = (acc[0] + y[0], acc[1] + y[1])
                ys.append(acc)
        for k, y in enumerate(ys):
            dst[0][:, d + k * Ns], dst[1][:, d + k * Ns] = y
        src = dst
    return src


def _mixed_skip(L, klim):
    """`bins_stage1`'s mixed-engine skip: the product Ns of the leading
    radices with klim <= L / Ns."""
    Ns = 1
    for R, n in radices(L):
        if klim * R > L // n:
            break
        Ns = n * R
    return Ns


@pytest.mark.parametrize('L', [400, 315, 75, 63, 30, 7])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_mixed_pass_skip_equals_the_unpruned_passes(L, dtype):
    """Inputs zero from column klim on, each column m1 < L / Ns copied to
    positions m1 Ns ... m1 Ns + Ns - 1 and run from the pass after the
    skipped ones, equal every pass on the full input bit for bit (but
    for the sign of a zero) at every skip the lengths of the mixed engine
    give (f1 = 400, 315, 75, 63, 30; 7 for n_up = 7), and the inverse
    DFT."""
    klims = sorted({1, 2, 3, L // 2 + 1}
                   | {L // Ns for _, Ns in radices(L)}
                   | {L // Ns + 1 for _, Ns in radices(L)})
    rng = np.random.default_rng(L)
    seen = set()
    for klim in (k for k in klims if 1 <= k <= L):
        x = tuple(rng.standard_normal((4, L)).astype(dtype)
                  for _ in range(2))
        for v in x:
            v[:, klim:] = 0
            v[:, 0] = -0.0
        Ns = _mixed_skip(L, klim)
        seen.add(Ns)
        col = np.arange(L) // Ns
        rep = tuple(np.where(col < klim, v[:, col], v.dtype.type(0))
                    for v in x)
        full, pruned = _stockham(x), _stockham(rep, Ns)
        for a, b in zip(full, pruned):            # +0 == -0, no NaN here
            assert np.array_equal(a, b), (klim, Ns)
        want = np.fft.ifft(x[0].astype(np.float64)
                           + 1j * x[1].astype(np.float64), axis=-1) * L
        tol = (2e-4 if dtype == 'float32' else 1e-11) * L
        np.testing.assert_allclose(pruned[0], want.real, atol=tol)
        np.testing.assert_allclose(pruned[1], want.imag, atol=tol)
    assert L in seen and 1 in seen                # no pass, and every pass


# ---- (d) a CPU model of the pruned four-step over a batch ---------------

def _model_cwt(xh, scales, wv, n_up, klims, dtype):
    """Wx (B, na, n_up) of the L1 CWT through a model of the kernel's
    radix-4 four-step, the closed-form GMW formed as the kernel forms it:
    row g = b * na + s takes klims[g % na]; stage 1 per column m2
    (`_stage1_passes`, pruned at the row's limit), the twiddle e^{2 pi i
    m2 k1 / n_up} / n_up, then the length-f2 DFT over m2 (numpy)."""
    f1, f2 = four_step(n_up)
    half = n_up // 2 + 1
    B, na = xh.shape[0], len(scales)
    tdt = getattr(torch, dtype)
    m = np.arange(half)
    out = np.zeros((B * na, n_up), complex)
    k1 = np.arange(f1)
    tw = np.exp(2j * np.pi * np.arange(f2)[:, None] * k1 / n_up) / n_up
    for g in range(B * na):
        b, s = divmod(g, na)
        psi = wv.fn(_kernel_w(scales[s], n_up, m, tdt), xp=torch).numpy()
        v = xh[b].copy()
        v[-1] *= 0.5                           # the Nyquist bin halved
        spec = np.zeros(n_up, np.complex64 if dtype == 'float32'
                        else np.complex128)
        spec[:half] = psi * v
        X = spec.reshape(f1, f2).T             # (m2, m1)
        y, _ = _stage1_passes((np.ascontiguousarray(X.real),
                               np.ascontiguousarray(X.imag)), f2, 1,
                              int(klims[g % na]))
        z = (y[0] + 1j * y[1]) * tw            # (m2, k1)
        out[g] = (np.fft.ifft(z, axis=0) * f2).ravel()   # n = k1 + f1 k2
    return out.reshape(B, na, n_up), psi.dtype


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_batched_rows_take_their_scales_limit(dtype, one_thread):
    n_up, N = 4096, 2500
    wv = resolve_wavelet(('gmw', {'dtype': dtype}), N=N)
    scales = np.asarray(tstq.process_scales('log-piecewise', N,
                                            wv)).ravel()[::6]
    klims = support_klims(wv, scales, n_up, dtype)
    assert len(set(klims.tolist())) > 3       # limits differ by scale
    rng = np.random.default_rng(3)
    cdt = np.complex64 if dtype == 'float32' else np.complex128
    xh = np.fft.rfft(rng.standard_normal((3, n_up))).astype(cdt)
    pruned, _ = _model_cwt(xh, scales, wv, n_up, klims, dtype)
    full, _ = _model_cwt(xh, scales, wv, n_up,
                         np.full_like(klims, stage1_rows(n_up)), dtype)
    assert np.array_equal(pruned, full)
    tdt = getattr(torch, dtype)
    Wx, _ = cwt_fused_plain(torch.as_tensor(xh),
                            torch.as_tensor(scales, dtype=tdt), wv, n_up, 0,
                            n_up, 1., False, True)
    err = np.abs(pruned - Wx.numpy()).max() / np.abs(Wx.numpy()).max()
    assert err < (1e-4 if dtype == 'float32' else 1e-10)
