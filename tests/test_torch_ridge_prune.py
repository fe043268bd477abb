# -*- coding: utf-8 -*-
"""The row-tiled ridge DP kernels of `csrc/ridge_dp.cu` on the CPU:
mirrors of `ridge_forward_tiled_kernel` (its tiles of 64 rows and of g,
the summaries it writes per column, the column's least, each row's upper
bound, the tile tests and which warp takes each kept tile) and of the
trace's prologue and walk (`ridge_trace_prologue_kernel`,
`ridge_trace_tiled_kernel`: the step records, the tile skip and the scan
from the high-f end), run on small inputs against the plain versions.
No card and no kernel run here.

  * pe bit-identical to `ridge_forward_plain` and the indices equal to
    `ridge_trace_plain`'s on planted-ridge noise, NaN cells in e, NaN in
    v, +-inf in e, +-0 ties, duplicate and unsorted v, pen 0, inf and
    negative, a subnormal v spacing, float32 and float64, F from 300 to
    4097;
  * the mirrors' counts (pairs and tile tests of the forward, tiles the
    walk scans) equal the torch replicas `ridge_forward_pairs` and
    `ridge_trace_tiles` (`tests/torch_ridge_tiled.py`, with the mirrors); without the bound (pen infinite, negative or
    NaN, a v not finite) every pair is evaluated; on a constant e with
    pen 0 the bound holds but keeps every pair, B (T - 1) F^2; on
    planted ridges at F = 4097 under 10% of them;
  * the prologue's records equal `_trace_records_plain`'s, and the
    mirrors' ridges equal the JAX package's `_fw_bw_jit` on its input.

The mirrors follow the kernels: change both together.
"""
import numpy as np
import pytest
import torch

import torch_ridge_tiled
from ssqueezepy_tpu_torch.ops.ridge_cuda import (
    _TILE, _WALK_RING, _WALK_SLOT, _WALK_TILE, _WALK_TILES, _SMEM_MAX,
    _trace_records_plain, ridge_forward_plain, ridge_plan,
    ridge_trace_plain)
from test_torch_past_ceiling import one_thread  # noqa: F401
from torch_jax_reference import xla_reference  # noqa: F401
from torch_ridge_tiled import (DT, forward_mirror, ridge_forward_pairs,
                               ridge_trace_tiles, trace_mirror)


# ---- inputs --------------------------------------------------------------------
def _planted(B, T, F, dtype, seed):
    """-log-normalized noise with two planted wandering ridges, time-major
    (B, T, F), and log-spaced v."""
    rng = np.random.default_rng(seed)
    E = rng.random((B, T, F)) * 0.05
    t = np.arange(T)
    for b in range(B):
        for amp, c, w, per in ((1., .3, .2, 40.), (.6, .7, .1, 25.)):
            r = (F * (c + w * np.sin(2 * np.pi * t / per + b))).astype(int)
            E[b, t, np.clip(r, 0, F - 1)] += amp
    e = -np.log(E / E.max(axis=-1, keepdims=True) + np.finfo(dtype).eps)
    v = np.log(np.geomspace(1., 300., F))
    return e.astype(dtype), v.astype(dtype)


def _case(name):
    """(e, v, penalty) of a named case, torch tensors on the CPU."""
    B, T, F, dtype, pen = 1, 24, 300, np.float32, 2.
    if name.startswith('planted'):
        F = int(name.split('-')[1])
        B, T = {300: (2, 40), 1100: (1, 32), 2100: (1, 24),
                4097: (1, 20)}[F]
        dtype = np.float64 if F == 1100 else np.float32
    if name == 'float64':
        B, F, dtype = 2, 700, np.float64
    if name in ('pen-inf', 'pen-neg', 'pen-nan', 'pen0', 'const-pen0'):
        F = 600 if name == 'pen0' else 450
        pen = {'pen-inf': np.inf, 'pen-neg': -1., 'pen-nan': np.nan}.get(
            name, 0.)
    e, v = _planted(B, T, F, dtype, F + T + len(name))
    if name == 'nan-e':
        F = e.shape[-1]
        e[0, 7, 100] = np.nan
        e[0, T - 1, ::13] = np.nan
    if name == 'nan-v':
        v[123] = np.nan
    if name == 'inf-e':
        e[0, 3, 40:90] = np.inf
        e[0, 5, 200] = -np.inf
        e[0, 9:, 250] = np.inf
    if name == 'zero-ties':
        e[:, ::3] = 0.
        e[:, 1::6, ::2] = -0.
    if name == 'dup-v':
        v = np.round(v, 1)[np.random.default_rng(3).permutation(F)]
    if name == 'subnormal-v':
        v = (np.arange(F) * np.finfo(dtype).smallest_subnormal * 3).astype(
            dtype)
    if name == 'const-pen0':
        e[:] = 1.5
    return torch.as_tensor(np.ascontiguousarray(e)), torch.as_tensor(v), pen


CASES = ['planted-300', 'planted-1100', 'planted-2100', 'planted-4097',
         'float64', 'nan-e', 'nan-v', 'inf-e', 'zero-ties', 'dup-v',
         'subnormal-v', 'pen0', 'pen-inf', 'pen-neg', 'pen-nan',
         'const-pen0']


def _same(a, b):
    """Bit for bit but for the sign of zeros; NaN where NaN."""
    nan = a.isnan()
    return torch.equal(nan, b.isnan()) and torch.equal(a[~nan], b[~nan])


@pytest.mark.parametrize('name', CASES)
def test_forward_mirror_vs_plain(one_thread, name):
    """The tiled forward's skip gives pe bit-identical to the plain loop,
    and its pairs and tests are the torch replica's."""
    e, v, pen = _case(name)
    B, T, F = e.shape
    pe, pairs, tests = forward_mirror(e, v, pen)
    ref = ridge_forward_plain(e, v, pen)
    assert _same(pe, ref)
    rp, rt = ridge_forward_pairs(ref, v, pen)
    assert np.array_equal(rp.numpy(), pairs)
    assert np.array_equal(rt.numpy(), tests)
    nT = -(-F // _TILE)
    assert pairs[0] == 0 and (tests[1:] == B * nT * nT).all()
    full = B * F * F
    if name in ('pen-inf', 'pen-neg', 'pen-nan', 'nan-v', 'const-pen0'):
        assert (pairs[1:] == full).all()           # nothing skipped
    if name == 'nan-e':                            # NaN from column 8
        assert (pairs[9:] == full).all() and (pairs[2:8] < full).all()
    if name.startswith('planted') or name in ('float64', 'pen0'):
        assert pairs[1:].sum() < .75 * (T - 1) * full


@pytest.mark.parametrize('signal', ['chirps', 'noise'])
def test_stft_share(one_thread, signal):
    """The main path's input scaled down: `extract_ridges`' energy of the
    port's `ssq_stft(n_fft=8192, hop_len=256)` (F = 4097, T = 40) of the
    two chirps of `chip_smoke.py` 12j (or white noise), penalty 2 on
    `ssq_freqs`: the tiled forward keeps under 10% of the pairs (about
    one tile of g per tile of rows), pe and the indices the plain ones."""
    import ssqueezepy_tpu_torch as stq
    from ssqueezepy_tpu_torch.models.ridge_extraction import _normalized
    N = 40 * 256
    if signal == 'chirps':
        ts = stq.TestSignals(N=N)
        x = ts.lchirp(N, .0125 * N, .075 * N)[0] + \
            ts.echirp(N, .125 * N, .375 * N)[0]
    else:
        x = np.random.default_rng(5).standard_normal(N)
    Tx, _, sf, _ = stq.ssq_stft(torch.as_tensor(x.astype(np.float32)),
                                n_fft=8192, hop_len=256, device='cpu')
    a = Tx.abs()
    eps = float(np.finfo(np.float32).eps)
    e = _normalized((a * a)[None], eps, torch.float32)
    v = torch.as_tensor(np.asarray(sf, np.float32))
    B, T, F = e.shape
    assert (F, T) == (4097, 40)
    pe, pairs, _ = forward_mirror(e, v, 2.)
    ref = ridge_forward_plain(e, v, 2.)
    assert _same(pe, ref)
    assert np.array_equal(ridge_forward_pairs(ref, v, 2.)[0].numpy(), pairs)
    assert pairs[1:].sum() < .1 * (T - 1) * F * F
    plan = ridge_plan(F, 4, tiled=True)
    got, scanned, _ = trace_mirror(pe, e, v, 2., eps, plan)
    r = ridge_trace_plain(ref, e, v, 2., eps)
    assert torch.equal(got, r)
    assert np.array_equal(ridge_trace_tiles(ref, e, v, 2., eps, r,
                                            plan).numpy(), scanned)


def test_forward_pairs_chunks(monkeypatch):
    """The replica's result does not depend on its column chunks (7
    columns a chunk under a lowered budget)."""
    e, v, pen = _case('planted-300')
    pe = ridge_forward_plain(e, v, pen)
    a = ridge_forward_pairs(pe, v, pen)
    monkeypatch.setattr(torch_ridge_tiled, '_BUDGET', 7 * 2 * 5 * 5)
    b = ridge_forward_pairs(pe, v, pen)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize('name', CASES)
def test_trace_mirror_vs_plain(one_thread, name):
    """The tiled trace's walk gives the plain version's indices, its
    scanned tiles are the torch replica's, and its prologue's records
    are `_trace_records_plain`'s."""
    e, v, pen = _case(name)
    B, T, F = e.shape
    eps = float(np.finfo(DT[e.element_size()]).eps)
    pe = ridge_forward_plain(e, v, pen)
    plan = ridge_plan(F, e.element_size(), tiled=True, batch=B)
    got, scanned, (mt, fval, fv, fw, lo, hi) = trace_mirror(
        pe, e, v, pen, eps, plan)
    ref = ridge_trace_plain(pe, e, v, pen, eps)
    assert torch.equal(got, ref)
    assert np.array_equal(ridge_trace_tiles(pe, e, v, pen, eps, ref,
                                            plan).numpy(), scanned)
    rec, vr = _trace_records_plain(pe, e, v, plan)
    nT = plan.trace_tiles
    assert _same(rec[..., :nT], torch.as_tensor(mt))
    assert _same(rec[..., nT], torch.as_tensor(fval))
    assert _same(rec[..., nT + 1], torch.as_tensor(fv))
    bits = torch.int32 if e.dtype == torch.float32 else torch.int64
    assert torch.equal(rec[..., nT + 2].contiguous().view(bits).long(),
                       torch.as_tensor(fw))
    assert _same(vr, torch.as_tensor(np.stack([lo, hi], -1)))
    if name == 'pen-neg':        # no bound: every tile down to the found
        assert scanned[:T - 1].sum() >= (T - 1)


@pytest.mark.parametrize('F,T', [(300, 6), (700, 5), (1100, 4)])
def test_constant_pen0_every_pair(one_thread, F, T):
    """A constant e with penalty 0: the bound holds (pen 0 is finite) but
    every tile's bound equals the rows' upper bounds, so nothing is
    skipped: B (T - 1) F^2 pairs, pe and the indices the plain ones."""
    e = torch.full((2, T, F), 1.5)
    v = torch.as_tensor(np.log(np.geomspace(1., 300., F)).astype(
        np.float32))
    pe, pairs, _ = forward_mirror(e, v, 0.)
    assert _same(pe, ridge_forward_plain(e, v, 0.))
    assert pairs[1:].sum() == 2 * (T - 1) * F * F
    assert int(ridge_forward_pairs(pe, v, 0.)[0].sum()) == pairs.sum()


@pytest.mark.parametrize('F', [64, 65, 129, 300])
def test_forward_mirror_edges(one_thread, F):
    """F at and past a tile's edge (64, 65: one row and g of the last
    tile), T = 1 and 2."""
    for T in (1, 2, 5):
        e, v = _planted(2, T, F, np.float32, F + T)
        e, v = torch.as_tensor(e), torch.as_tensor(v)
        pe, pairs, _ = forward_mirror(e, v, 2.)
        assert _same(pe, ridge_forward_plain(e, v, 2.))
        assert np.array_equal(ridge_forward_pairs(pe, v, 2.)[0].numpy(),
                              pairs)


def test_floor_input_keeps_own_tiles(one_thread):
    """e = 0 with pen 2 (the input the per-column floor is timed on): each
    tile of rows keeps only its own tile of g."""
    F, T = 700, 5
    e = torch.zeros((1, T, F))
    v = torch.linspace(0, .5, F)
    pe, pairs, _ = forward_mirror(e, v, 2.)
    assert _same(pe, ridge_forward_plain(e, v, 2.))
    sizes = np.minimum(_TILE, F - _TILE * np.arange(-(-F // _TILE)))
    assert (pairs[1:] == (sizes * sizes).sum()).all()


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_mirrors_vs_jax(xla_reference, dtype):
    """The mirrors' ridge against the JAX package's `_fw_bw_jit` on its
    own input form (e (F, T), P = pen * subtract.outer(v, v) ** 2)."""
    import jax
    from ssqueezepy_tpu.models.ridge_extraction import _fw_bw_jit
    F, T = 300, 40
    e, v = _planted(1, T, F, dtype, 11)
    eps = np.finfo(dtype).eps
    P = (np.asarray(2., dtype) * np.subtract.outer(v, v) ** 2).astype(dtype)
    want = np.asarray(jax.jit(lambda x: _fw_bw_jit(
        jax.numpy.asarray(P), x, np.dtype(dtype).type(eps)))(
            np.ascontiguousarray(e[0].T)))
    et, vt = torch.as_tensor(e), torch.as_tensor(v)
    pe, _, _ = forward_mirror(et, vt, 2.)
    plan = ridge_plan(F, et.element_size(), tiled=True)
    got, _, _ = trace_mirror(pe, et, vt, 2., float(eps), plan)
    assert np.array_equal(got[0].numpy(), want)


# ---- the plan --------------------------------------------------------------------
@pytest.mark.parametrize('isz', [4, 8])
def test_tiled_plan_layout(isz):
    """Every tiled plan up to F = 10^6: the forward's tiles of 64 cover F
    once; the trace's tiles, a multiple of 32 wide and at least 256, are
    at most 512 and cover F; the step record holds the tiles and three
    values in whole 16-byte pieces within a ring slot; both kernels'
    static shared bytes within 48 KB."""
    for F in list(range(1, 1200, 7)) + [16385, 131072, 131073, 262145,
                                        10 ** 6]:
        p = ridge_plan(F, isz, tiled=True)
        assert p.tiled and p.rows == _TILE and p.tiles == -(-F // _TILE)
        assert p.row_ranges[0][0] == 0 and p.row_ranges[-1][1] == F
        assert all(hi - lo == _TILE for lo, hi in p.row_ranges[:-1])
        G, n = p.trace_rows, p.trace_tiles
        assert G % 32 == 0 and G >= _WALK_TILE and n <= _WALK_TILES
        assert n * G >= F > (n - 1) * G
        assert G == _WALK_TILE or F > _WALK_TILE * _WALK_TILES
        stride = p.trace_slot // isz
        assert p.trace_slot % 16 == 0 and n + 3 <= stride <= _WALK_SLOT
        assert p.trace_depth == _WALK_RING
        assert p.forward_smem <= 48 * 1024 and p.trace_smem <= 48 * 1024
        assert p.forward_smem <= _SMEM_MAX
