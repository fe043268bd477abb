# -*- coding: utf-8 -*-
"""The ridge DP kernels of `csrc/ridge_dp.cu` on the CPU: their launch
plan (`ops/ridge_cuda.py::ridge_plan`) and mirrors of the kernels' index
work, run on small inputs against the plain versions. No card and no
kernel run here.

  * the plan: every CTA's row range, the shared bytes of both kernels
    against `_SMEM_MAX`, P resident at the main path's F = 293, the
    trace's ring at least two deep; F past `ridge_resident` taking the
    row-tiled mode, whose shared bytes do not grow with F, for every F up
    to 20000 and a sweep to 10^6;
  * the forward's map (`ridge_forward_kernel`): a cluster's CTAs, their
    warps' row pairs and the lanes' 16-byte pieces of g cover every
    (f, g) (once, but for the repeated last piece of the register mode),
    the e ring's slots hold each column when it is read, and the per-lane
    partial minima with the NaN rule, merged across the warp, give pe bit
    for bit;
  * the trace's rings (`load_span`, `ridge_trace_kernel`): each slot's
    aligned superset and tail copies hold its group of rows at the
    walker's offset,
    the full/empty mbarrier parities admit each row exactly when it has
    landed (a randomised interleaving of producer and walker), and the
    walker's lane split, last-qualifying max and argmin (where nothing
    qualifies) give the plain version's indices;
  * the row-tiled mode (`ridge_forward_tiled_kernel`,
    `ridge_trace_prologue_kernel`, `ridge_trace_tiled_kernel`) by the
    mirrors of `tests/torch_ridge_tiled.py`: the forward's tiles of 64
    rows, pe bit for bit with a NaN cell, its kept pairs the torch
    replica's; the trace's tiles (the plan's and narrow ones that split
    the rows into many) give the plain version's indices, NaN rows too.

The mirrors follow the kernels line for line: change both together.
"""
import random

import numpy as np
import pytest
import torch

from ssqueezepy_tpu_torch.ops import ridge_cuda
from ssqueezepy_tpu_torch.ops.ridge_cuda import (_E_RING, _SMEM_MAX, _TILE,
                                                 _span_slot,
                                                 ridge_forward_plain,
                                                 ridge_penalty, ridge_plan,
                                                 ridge_resident,
                                                 ridge_trace_plain)
from torch_ridge_tiled import (forward_mirror, ridge_forward_pairs,
                               ridge_trace_tiles, trace_mirror)

FS = (1, 5, 7, 8, 9, 40, 293, 1100, 5632, 11264)
CASES = [(F, isz) for F in FS for isz in (4, 8) if F * isz <= 11264 * 4]
DTYPE = {4: np.float32, 8: np.float64}


def _inputs(B, T, F, dtype, seed):
    """-log of noise with one planted ridge, time-major (B, T, F), and
    log-spaced row coordinates; a few exact ties (constant columns)."""
    rng = np.random.default_rng(seed)
    E = rng.random((B, T, F)) * 0.05
    t = np.arange(T)
    r = (F * (.5 + .3 * np.sin(2 * np.pi * t / 40.))).astype(int)
    E[:, t, np.clip(r, 0, F - 1)] += 1.
    E[:, ::7] = 0.5
    e = -np.log(E / E.max(axis=-1, keepdims=True) + np.finfo(dtype).eps)
    v = np.log(np.geomspace(1., 300., F))
    return torch.as_tensor(e.astype(dtype)), torch.as_tensor(v.astype(dtype))


@pytest.mark.parametrize('F,isz', CASES)
def test_plan_rows_and_bytes(F, isz):
    """Row ranges cover [0, F) once in order, none negative; C = min(8,
    F); both kernels within `_SMEM_MAX`; the trace ring at least two deep;
    each slot holds a row's 16-byte aligned superset."""
    p = ridge_plan(F, isz)
    assert p.clusters == min(8, F) and len(p.row_ranges) == p.clusters
    assert p.rows == -(-F // p.clusters)
    covered = []
    for lo, hi in p.row_ranges:
        assert 0 <= lo <= hi <= F and hi - lo <= p.rows
        covered += range(lo, hi)
    assert covered == list(range(F))
    assert p.forward_smem <= _SMEM_MAX and p.trace_smem <= _SMEM_MAX
    assert p.trace_depth >= 2 and p.trace_e_depth >= 1
    assert p.trace_slot % 16 == 0
    Q = 16 // isz
    for off in range(Q):                    # a span's start past an aligned
        for n in (F, p.trace_rows * F):     # address: an e slot, a group
            assert -(-(off + n) // Q) * Q * isz <= (
                p.trace_slot if n > F or p.trace_rows == 1 else
                _span_slot(F, isz))
    assert 1 <= p.trace_rows <= 16 and p.trace_rows * F * isz <= 16384 \
        or p.trace_rows == 1
    assert 32 * p.warps <= 1024 and 2 * 32 * p.warps >= p.rows
    assert p.resident == (F <= 384)         # one row pair per warp
    if p.resident:
        assert 2 * p.warps >= p.rows and p.warps <= 24
    if p.trace_e_depth < p.trace_depth:     # only where two pairs do not fit
        assert F * isz > 11200 * 4


@pytest.mark.parametrize('clusters', [2, 8, 16])
def test_plan_cluster_sizes(clusters):
    """The plan at other cluster sizes: C = min(clusters, F), the ranges
    cover F, a 16-CTA plan of the main path keeps P resident."""
    for F in (1, 9, 17, 293):
        p = ridge_plan(F, 4, clusters=clusters)
        assert p.clusters == min(clusters, F)
        assert [f for lo, hi in p.row_ranges for f in range(lo, hi)] == \
            list(range(F))
    assert ridge_plan(293, 4, clusters=16).resident
    with pytest.raises(ValueError):
        ridge_plan(293, 4, clusters=17)


@pytest.mark.parametrize('F,isz', [(11265, 4), (5633, 8), (11264, 8),
                                   (10 ** 6, 4), (10 ** 6, 8)])
def test_plan_past_rule_raises(F, isz):
    """F past `ridge_resident` builds the row-tiled plan (it raised C1b
    before that mode): static shared bytes within 48 KB whatever F, tiles
    of 64 rows covering [0, F) once, the trace's tiles covering it, the
    same plan at every batch size."""
    assert not ridge_resident(F, isz)
    for batch in (1, 3, 64):
        p = ridge_plan(F, isz, batch=batch)
        assert p.tiled and p.forward_smem <= 48 * 1024 <= _SMEM_MAX
        assert p.clusters is None and p.trace_smem <= 48 * 1024
        assert [f for lo, hi in p.row_ranges for f in range(lo, hi)] == \
            list(range(F)) if F < 10 ** 5 else p.row_ranges[-1][1] == F
        assert all(hi - lo <= _TILE for lo, hi in p.row_ranges)
        assert p.tiles == len(p.row_ranges) == -(-F // _TILE)
        assert p.trace_tiles * p.trace_rows >= F > \
            (p.trace_tiles - 1) * p.trace_rows
        assert p == ridge_plan(F, isz, batch=1)


@pytest.mark.parametrize('isz', [4, 8])
def test_plan_every_F(isz):
    """Every F up to 20000 (both modes' edges), then every 397th up to
    10^6 and 10^6 itself: a plan builds, the resident one exactly where
    `ridge_resident` admits F (11264 in float32, 5632 in float64), every
    plan's shared bytes within `_SMEM_MAX`; no F raises."""
    edge = 11264 * 4 // isz
    Fs = list(range(1, 20001)) + list(range(20001, 10 ** 6, 397)) + \
        [10 ** 6]
    for F in Fs:
        p = ridge_plan(F, isz)
        assert p.tiled == (F > edge) == (not ridge_resident(F, isz))
        assert p.forward_smem <= _SMEM_MAX and p.trace_smem <= _SMEM_MAX


# ---- the forward's map -------------------------------------------------
def _lane_min(cands, dtype):
    """A lane's partial min with torch's NaN rule (min.NaN.f32, or fmin
    and a flag), as (value, nan)."""
    nan = bool(np.isnan(cands).any())
    m = np.min(cands[~np.isnan(cands)]) if (~np.isnan(cands)).any() \
        else dtype(np.inf)
    return m, nan


def _forward_mirror(e, v, pen, plan):
    """`ridge_forward_kernel` per cluster, CTA, warp, lane: returns pe and
    counts how often each (t, f, g) candidate was taken."""
    B, T, F = e.shape
    dtype = DTYPE[e.element_size()]
    en, vn = e.numpy(), v.numpy()
    pen = dtype(pen)
    Fp = (F + 3) & ~3
    sv = np.zeros(Fp, dtype)
    sv[:F] = vn
    d = sv[:, None] - sv[None, :]
    P = pen * (d * d)                       # each op rounded to dtype
    pe = np.empty_like(en)
    seen = np.zeros((F, Fp), int)
    for b in range(B):
        prev = np.full(Fp, np.inf, dtype)
        prev[:F] = pe[b, 0] = en[b, 0]
        ring = {}                           # slot -> column of e it holds
        for col in range(1, _E_RING):
            ring[col % _E_RING] = col
        for t in range(1, T):
            assert ring[t % _E_RING] == t   # e's column t is in its slot
            nxt = np.full(Fp, np.inf, dtype)
            nw = plan.warps
            for lo, hi in plan.row_ranges:
                nr = hi - lo
                for w in range(nw):
                    for i0 in range(w, nr, 2 * nw):
                        i1 = i0 + nw if i0 + nw < nr else i0
                        for i in sorted({i0, i1}):
                            f = lo + i
                            parts = []
                            for lane in range(32):
                                # resident: three pieces, those past Fp
                                # repeat the last; else the loop to Fp
                                pieces = [min(4 * lane + 128 * j, Fp - 4)
                                          for j in range(3)] \
                                    if plan.resident else \
                                    range(4 * lane, Fp, 128)
                                g = np.array([gg + q for gg in pieces
                                              for q in range(4)], int)
                                if b == 0 and t == 1:
                                    seen[f, g] += 1
                                c = (prev[g] + P[f, g]).astype(dtype)
                                c[g >= F] = prev[g[g >= F]] + dtype(0)
                                parts.append(_lane_min(c, dtype))
                            # the xor shuffle tree, then the flag
                            vals = [m for m, _ in parts]
                            for o in (16, 8, 4, 2, 1):
                                vals = [np.fmin(vals[ln], vals[ln ^ o])
                                        for ln in range(32)]
                            m = dtype(np.nan) if any(n for _, n in parts) \
                                else vals[0]
                            nxt[f] = pe[b, t, f] = dtype(en[b, t, f] + m)
            if t + _E_RING - 1 < T:         # into the slot of column t - 1
                ring[(t + _E_RING - 1) % _E_RING] = t + _E_RING - 1
            prev = nxt
    return torch.as_tensor(pe), seen


@pytest.mark.parametrize('F,clusters', [(1, 8), (5, 8), (9, 8), (40, 8),
                                        (40, 16), (70, 8), (300, 8),
                                        (40, 2)])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_forward_mirror_vs_plain(F, clusters, dtype):
    """The forward's map covers every (f, g < Fp) once and its partial
    minima merged in the shuffle's order give the plain pe bit for bit,
    with NaN cells (a NaN in e spreads to every later column)."""
    e, v = _inputs(2, 9, F, dtype, F)
    e[1, 6, F // 2] = float('nan')
    plan = ridge_plan(F, e.element_size(), clusters=clusters)
    pe, seen = _forward_mirror(e, v, 2., plan)
    Fp = seen.shape[1]
    assert (seen[:, :Fp - 4] == 1).all() and (seen[:, Fp - 4:] >= 1).all()
    ref = ridge_forward_plain(e, v, 2.)
    assert torch.equal(pe.isnan(), ref.isnan())
    assert torch.equal(pe[~pe.isnan()], ref[~ref.isnan()])
    assert pe[1, 7:].isnan().all() and not pe[0].isnan().any()


# ---- the trace's rings ---------------------------------------------------
def _load_span(flat, g0, n, slot_elems, Q):
    """`load_span`: the aligned bulk part and the tail past the tensor's
    last whole 16 bytes; returns the slot and the span's offset in it."""
    total = flat.size
    a = g0 // Q * Q
    end = g0 + n
    a_end = min(-(-end // Q) * Q, total // Q * Q)
    bulk_end = max(a_end, a)
    assert a % Q == 0 and (bulk_end - a) % Q == 0 and bulk_end <= total
    assert end - a <= slot_elems
    slot = np.full(slot_elems, np.nan, flat.dtype)   # stale contents
    slot[:bulk_end - a] = flat[a:bulk_end]
    for g in range(bulk_end, end):
        slot[g - a] = flat[g]
    return slot, g0 - a


def _groups(T, G):
    """The trace's groups of rows, [lo, hi), from the last rows down."""
    return [(max(0, T - (q + 1) * G), T - q * G) for q in range(-(-T // G))]


@pytest.mark.parametrize('B,T,F', [(1, 5, 1), (3, 7, 3), (2, 9, 5),
                                   (2, 33, 13), (1, 40, 64), (3, 6, 293)])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_trace_rows_land_whole(B, T, F, dtype):
    """Every group of rows of a (B, T, F) tensor, loaded into a slot of the
    plan's size, reads back whole at the walker's offset, the last rows of
    the tensor through the tail copies."""
    isz = np.dtype(dtype).itemsize
    Q = 16 // isz
    plan = ridge_plan(F, isz)
    flat = np.arange(B * T * F, dtype=dtype)
    for b in range(B):
        for lo, hi in _groups(T, plan.trace_rows):
            g0, n = (b * T + lo) * F, (hi - lo) * F
            slot, off = _load_span(flat, g0, n, plan.trace_slot // isz, Q)
            assert off == g0 % Q
            assert np.array_equal(slot[off:off + n], flat[g0:g0 + n])


class _Mbar:
    """An mbarrier of arrival count 1: `phases` completed; a try_wait on
    parity p passes once the phase of that parity has completed."""
    def __init__(self):
        self.phases = 0

    def arrive(self):
        self.phases += 1

    def passes(self, parity):
        return (self.phases & 1) != parity


def _trace_mirror(pe, e, v, pen, eps, plan, seed):
    """`ridge_trace_kernel` for one batch row at a time: the producer and
    the walker as coroutines on the rings, interleaved at random."""
    B, T, F = pe.shape
    dtype = DTYPE[pe.element_size()]
    isz = pe.element_size()
    Q = 16 // isz
    dp, de, W = plan.trace_depth, plan.trace_e_depth, plan.trace_slot // isz
    fp, fe = pe.numpy().ravel(), e.numpy().ravel()
    sv = v.numpy()
    pen, eps = dtype(pen), dtype(eps)
    rng = random.Random(seed)
    out = np.empty((B, T), np.int64)
    for b in range(B):
        row0 = b * T
        ring_p, ring_e = [None] * dp, [None] * de
        full_p, empty_p = [_Mbar() for _ in range(dp)], \
            [_Mbar() for _ in range(dp)]
        full_e, empty_e = [_Mbar() for _ in range(de)], \
            [_Mbar() for _ in range(de)]
        landed = {}                          # slot -> row it holds

        groups = _groups(T, plan.trace_rows)

        def producer():
            for q, (lo, hi) in enumerate(groups):
                g0, n = (row0 + lo) * F, (hi - lo) * F
                sp, se = q % dp, q % de
                if q >= dp:
                    while not empty_p[sp].passes((q // dp - 1) & 1):
                        yield
                ring_p[sp] = _load_span(fp, g0, n, W, Q)[0]
                landed['p', sp] = lo
                yield                        # the copy in flight
                full_p[sp].arrive()
                if q >= de:
                    while not empty_e[se].passes((q // de - 1) & 1):
                        yield
                ring_e[se] = _load_span(fe, g0, n, W, Q)[0]
                landed['e', se] = lo
                yield
                full_e[se].arrive()

        def walker():
            val = vn = dtype(0)
            for q, (lo, hi) in enumerate(groups):
                g0 = (row0 + lo) * F
                off = g0 % Q
                sp, se = q % dp, q % de
                while not full_p[sp].passes((q // dp) & 1):
                    yield
                assert landed['p', sp] == lo
                for t in range(hi - 1, lo - 1, -1):
                    row = ring_p[sp][off + (t - lo) * F:off + (t - lo + 1) * F]
                    last = -1
                    if t < T - 1:
                        for lane in range(32):   # each lane's last, then max
                            f = np.arange(lane, F, 32)
                            d = (vn - sv[f]).astype(dtype)
                            s = (row[f] + (pen * (d * d)).astype(
                                dtype)).astype(dtype)
                            ok = np.abs((val - s).astype(dtype)) < eps
                            if ok.any():
                                last = max(last, int(f[ok][-1]))
                    if last >= 0:
                        idx = last
                    elif np.isnan(row).any():    # argmin: the first NaN,
                        idx = int(np.argmax(np.isnan(row)))
                    else:                        # else the first least
                        idx = int(np.argmin(row))
                    if t == hi - 1:
                        while not full_e[se].passes((q // de) & 1):
                            yield
                        assert landed['e', se] == lo
                    erow = ring_e[se][off + (t - lo) * F:
                                      off + (t - lo + 1) * F]
                    val = dtype(row[idx] - erow[idx])
                    vn = sv[idx]
                    out[b, t] = idx
                empty_p[sp].arrive()
                empty_e[se].arrive()
                yield

        live = [producer(), walker()]
        while live:
            co = rng.choice(live)
            try:
                next(co)
            except StopIteration:
                live.remove(co)
    return torch.as_tensor(out)


@pytest.mark.parametrize('B,T,F', [(1, 1, 5), (2, 2, 9), (2, 40, 13),
                                   (3, 25, 40), (1, 60, 293)])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_trace_mirror_vs_plain(B, T, F, dtype):
    """The trace's rings, parities and walker give the plain version's
    indices, at the plan's depths and at the rule's edge depths (two pe
    slots, one e slot), under random interleavings."""
    e, v = _inputs(B, T, F, dtype, T + F)
    eps = float(np.finfo(dtype).eps)
    pe = ridge_forward_plain(e, v, 2.)
    ref = ridge_trace_plain(pe, e, v, 2., eps)
    plan = ridge_plan(F, e.element_size())
    edge = plan._replace(trace_rows=1, trace_depth=2, trace_e_depth=1,
                         trace_slot=_span_slot(F, e.element_size()))
    for p in (plan, edge, plan._replace(trace_rows=3)):
        assert torch.equal(_trace_mirror(pe, e, v, 2., eps, p, F), ref)


def test_trace_mirror_nan_and_ties():
    """NaN rows (argmin takes the first NaN; nothing qualifies against a
    NaN val) and exact ties (the last qualifying f, the first argmin)."""
    e, v = _inputs(2, 30, 16, 'float32', 3)
    e[:, 20:23, 3] = float('nan')
    e[:, 10] = 1.
    pe = ridge_forward_plain(e, v, 2.)
    assert pe.isnan().any()
    eps = float(np.finfo(np.float32).eps)
    ref = ridge_trace_plain(pe, e, v, 2., eps)
    plan = ridge_plan(16, 4)
    assert torch.equal(_trace_mirror(pe, e, v, 2., eps, plan, 1), ref)
    P = ridge_penalty(v, 2.)
    assert P.shape == (16, 16)


# ---- the row-tiled mode ---------------------------------------------------
@pytest.mark.parametrize('B,T,F', [(2, 6, 1100), (1, 4, 2100), (3, 4, 40),
                                   (1, 1, 600), (2, 2, 513)])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_tiled_forward_mirror_vs_plain(B, T, F, dtype):
    """The tiled forward (tiles of 64 rows and of g) gives pe equal to the
    plain version bit for bit with NaN cells (a NaN in e spreads to every
    later column, whose pairs are then all kept), its kept pairs and tests
    the torch replica's (F = 1100: 18 tiles; 513: one row in the last)."""
    e, v = _inputs(B, T, F, dtype, F + T)
    if T > 3:
        e[-1, 2, F // 3] = float('nan')
    ref = ridge_forward_plain(e, v, 2.)
    pe, pairs, tests = forward_mirror(e, v, 2.)
    assert torch.equal(pe.isnan(), ref.isnan())
    assert torch.equal(pe[~pe.isnan()], ref[~ref.isnan()])
    rp, rt = ridge_forward_pairs(ref, v, 2.)
    assert np.array_equal(rp.numpy(), pairs)
    assert np.array_equal(rt.numpy(), tests)
    assert (pairs[1:] <= B * F * F).all()
    if T > 3:                            # the NaN row keeps every pair
        assert (pairs[3:] >= F * F).all()
    plan = ridge_plan(F, e.element_size(), tiled=True, batch=B)
    if F == 1100:
        assert len(plan.row_ranges) == plan.tiles == 18


@pytest.mark.parametrize('B,T,F,W', [(2, 30, 293, None),
                                     (1, 6, 12300, None), (2, 25, 300, 64),
                                     (1, 20, 1000, 96)])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_tiled_trace_mirror_vs_plain(B, T, F, W, dtype):
    """The tiled trace's walk gives the plain version's indices at the
    plan's tiles (256 f: F = 12300 takes 49) and at narrow tiles (64, 96
    f) that split the rows into many; its scanned tiles are the torch
    replica's."""
    e, v = _inputs(B, T, F, dtype, T + F)
    e[:, ::5] = 0.5                          # constant columns: ties
    eps = float(np.finfo(dtype).eps)
    pe = ridge_forward_plain(e, v, 2.)
    ref = ridge_trace_plain(pe, e, v, 2., eps)
    plan = ridge_plan(F, e.element_size(), tiled=True, batch=B)
    if W is not None:
        n = -(-F // W)
        plan = plan._replace(trace_rows=W, trace_tiles=n, trace_slot=-(-(
            n + 3) * e.element_size() // 16) * 16)
    got, scanned, _ = trace_mirror(pe, e, v, 2., eps, plan)
    assert torch.equal(got, ref)
    assert np.array_equal(ridge_trace_tiles(pe, e, v, 2., eps, ref,
                                            plan).numpy(), scanned)
    assert scanned[:T - 1].sum() >= 1


def test_tiled_trace_mirror_nan():
    """NaN rows in the tiled trace: the argmin takes the first NaN, and
    nothing qualifies against a NaN val (no tile scanned there)."""
    e, v = _inputs(2, 30, 200, 'float32', 5)
    e[:, 20:23, 3] = float('nan')
    pe = ridge_forward_plain(e, v, 2.)
    assert pe.isnan().any()
    eps = float(np.finfo(np.float32).eps)
    plan = ridge_plan(200, 4, tiled=True, batch=2)
    plan = plan._replace(trace_rows=64, trace_tiles=4, trace_slot=16)
    got, scanned, _ = trace_mirror(pe, e, v, 2., eps, plan)
    assert torch.equal(got, ridge_trace_plain(pe, e, v, 2., eps))
    assert scanned[20:28].sum() == 0


def test_tiled_plan_forced_and_lowered_limit(monkeypatch):
    """`tiled=True` at the main path's F = 293 (5 tiles of 64 rows, the
    last of 37; trace tiles of 256: two); the resident plan's limit
    lowered takes F = 300 to the tiled mode."""
    p = ridge_plan(293, 4, tiled=True)
    assert p.tiled and p.tiles == 5 and p.row_ranges[-1] == (256, 293)
    assert (p.trace_rows, p.trace_tiles) == (256, 2)
    assert not ridge_plan(293, 4).tiled
    monkeypatch.setattr(ridge_cuda, '_SMEM_MAX', 1024)
    assert ridge_plan(300, 8).tiled and not ridge_resident(300, 8)
