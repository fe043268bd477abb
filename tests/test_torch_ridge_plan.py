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
    `ridge_trace_tiled_kernel`): the work items (batch row, row tile,
    chunk of g) cover every (f, g) once per column, the partial minima
    in their two parities and the combination into pe[t-1] give pe bit
    for bit, each column written once; the trace's tiles from the high-f
    end, the stop at the first tile that qualifies and the block argmin
    give the plain version's indices.

The mirrors follow the kernels line for line: change both together.
"""
import random

import numpy as np
import pytest
import torch

from ssqueezepy_tpu_torch.ops import ridge_cuda
from ssqueezepy_tpu_torch.ops.ridge_cuda import (_E_RING, _SMEM_MAX,
                                                 _TILE_G, _TILE_ROWS,
                                                 _TILE_THREADS,
                                                 _TRACE_SCAN,
                                                 _TRACE_THREADS, _span_slot,
                                                 ridge_forward_plain,
                                                 ridge_penalty, ridge_plan,
                                                 ridge_resident,
                                                 ridge_trace_plain)

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
    before that mode): shared bytes within `_SMEM_MAX` and independent of
    F, row tiles covering [0, F) once, S chunks of g covering it with no
    empty chunk, at every batch size."""
    assert not ridge_resident(F, isz)
    for batch in (1, 3, 64):
        p = ridge_plan(F, isz, batch=batch)
        assert p.tiled and p.forward_smem == 2 * _TILE_G * isz <= _SMEM_MAX
        assert p.trace_smem == 0 and p.clusters is None
        assert [f for lo, hi in p.row_ranges for f in range(lo, hi)] == \
            list(range(F)) if F < 10 ** 5 else p.row_ranges[-1][1] == F
        assert all(hi - lo <= _TILE_ROWS for lo, hi in p.row_ranges)
        assert p.chunks * p.chunk >= F > (p.chunks - 1) * p.chunk
        assert 1 <= p.chunks <= -(-F // _TILE_G)


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
def _tiled_forward_mirror(e, v, pen, plan):
    """`ridge_forward_tiled_kernel`: per column, every work item (b, row
    tile i, chunk s) in the grid's order, its partial minima over the
    chunk into part[t % 2][b][s], the items of tile 0 writing pe[t-1] as
    they combine it; returns pe, how often each (f, g) candidate of
    column 1 was taken and each column's count of candidates, and how
    often each pe cell was written."""
    B, T, F = e.shape
    dtype = DTYPE[e.element_size()]
    en, vn = e.numpy(), v.numpy()
    pen = dtype(pen)
    S, chunk = plan.chunks, plan.chunk
    nf = len(plan.row_ranges)
    part = np.full((2, B, S, F), np.nan, dtype)   # stale contents
    pe = np.full_like(en, np.nan)
    written = np.zeros(en.shape, int)
    seen = np.zeros((F, F), np.uint8)
    taken = np.zeros(T, np.int64)
    pe[:, 0] = en[:, 0]
    written[:, 0] += 1

    def combine(parts, col):
        m = parts.min(axis=0) if not np.isnan(parts).any(axis=0).any() \
            else np.where(np.isnan(parts).any(axis=0), dtype(np.nan),
                          np.nanmin(np.where(np.isnan(parts), np.inf,
                                             parts), axis=0))
        return (col + m).astype(dtype)

    for t in range(1, T):
        pin, pout = part[(t - 1) & 1], part[t & 1]
        for it in range(B * nf * S):
            s, r = it % S, it // S
            i, b = r % nf, r // nf
            g0, g1 = s * chunk, min(F, s * chunk + chunk)
            fa = i * _TILE_ROWS + np.arange(_TILE_THREADS)
            rows = np.concatenate([fa, fa + _TILE_THREADS])
            vf = vn[np.minimum(rows, F - 1)]
            acc = np.full(len(rows), np.inf, dtype)
            nan = np.zeros(len(rows), bool)
            for gt in range(g0, g1, _TILE_G):
                n = min(_TILE_G, g1 - gt)
                g = gt + np.arange(n)
                if t == 1:
                    x = en[b, 0, g]
                else:
                    x = combine(pin[b, :, g].T, en[b, t - 1, g])
                    if i == 0:
                        pe[b, t - 1, g] = x
                        written[b, t - 1, g] += 1
                d = (vf[:, None] - vn[g][None, :]).astype(dtype)
                c = (x[None, :] + (pen * (d * d)).astype(dtype)).astype(
                    dtype)
                nan |= np.isnan(c).any(axis=1)
                acc = np.minimum(acc, np.where(np.isnan(c), np.inf,
                                               c).min(axis=1))
                ok = rows < F
                taken[t] += ok.sum() * n
                if b == 0 and t == 1:
                    seen[np.ix_(rows[ok], g)] += 1
            val = np.where(nan, dtype(np.nan), acc).astype(dtype)
            ok = rows < F
            pout[b, s, rows[ok]] = val[ok]
    if T > 1:
        pin = part[(T - 1) & 1]
        for b in range(B):
            pe[b, T - 1] = combine(pin[b], en[b, T - 1])
            written[b, T - 1] += 1
    return torch.as_tensor(pe), seen, taken, written


@pytest.mark.parametrize('B,T,F', [(2, 6, 1100), (1, 4, 2100), (3, 4, 40),
                                   (1, 1, 600), (2, 2, 513)])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_tiled_forward_mirror_vs_plain(B, T, F, dtype):
    """The tiled forward's items cover every (f, g) once per column, each
    pe cell is written once, and pe equals the plain version bit for bit
    with NaN cells (a NaN in e spreads to every later column), at the
    plan's chunks (F = 1100: 3 row tiles by 2 chunks; 2100: 5 by 3) and
    at one chunk."""
    e, v = _inputs(B, T, F, dtype, F + T)
    if T > 3:
        e[-1, 2, F // 3] = float('nan')
    ref = ridge_forward_plain(e, v, 2.)
    plan = ridge_plan(F, e.element_size(), tiled=True, batch=B)
    for p in (plan, plan._replace(chunks=1, chunk=F)):
        pe, seen, taken, written = _tiled_forward_mirror(e, v, 2., p)
        assert (seen == 1).all() if T > 1 else True
        assert (taken[1:] == B * F * F).all() and (written == 1).all()
        assert torch.equal(pe.isnan(), ref.isnan())
        assert torch.equal(pe[~pe.isnan()], ref[~ref.isnan()])
    if F == 1100:
        assert (len(plan.row_ranges), plan.chunks) == (3, 2)


def _tiled_trace_mirror(pe, e, v, pen, eps, W=_TRACE_THREADS * _TRACE_SCAN):
    """`ridge_trace_tiled_kernel`: per step the tiles [max(0, hi - W), hi)
    from hi = F down, each thread's last qualifying f of its kScan, the
    block's max, the stop at the first tile with one; the block argmin
    where none qualifies. Returns the indices and the tiles scanned."""
    B, T, F = pe.shape
    dtype = DTYPE[pe.element_size()]
    p, en, vn = pe.numpy(), e.numpy(), v.numpy()
    pen, eps = dtype(pen), dtype(eps)
    out = np.empty((B, T), np.int64)
    tiles = 0

    def argmin(row):
        if np.isnan(row).any():
            return int(np.argmax(np.isnan(row)))
        return int(np.argmin(row))
    for b in range(B):
        r = argmin(p[b, T - 1])
        out[b, T - 1] = r
        for t in range(T - 2, -1, -1):
            val = dtype(p[b, t + 1, r] - en[b, t + 1, r])
            vr = vn[r]
            last, hi = -1, F
            while hi > 0 and last < 0:
                lo = max(0, hi - W)
                tiles += 1
                # thread tid's f: lo + tid + 512 j, j < kScan (W = 6144);
                # a narrower W keeps the first W // 512 of them
                f = lo + np.arange(_TRACE_THREADS)[:, None] + \
                    _TRACE_THREADS * np.arange(-(-W // _TRACE_THREADS))
                fc = np.minimum(f, hi - 1)
                d = (vr - vn[fc]).astype(dtype)
                s = (p[b, t, fc] + (pen * (d * d)).astype(dtype)).astype(
                    dtype)
                ok = (np.abs((val - s).astype(dtype)) < eps) & (f < hi) & \
                    (f < lo + W)
                mine = np.where(ok, f, -1).max(axis=1)   # each thread's
                last = int(mine.max())                   # the block's max
                hi -= W
            r = last if last >= 0 else argmin(p[b, t])
            out[b, t] = r
    return torch.as_tensor(out), tiles


@pytest.mark.parametrize('B,T,F,W', [(2, 30, 293, None),
                                     (1, 6, 12300, None), (2, 25, 300, 64),
                                     (1, 20, 1000, 96)])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_tiled_trace_mirror_vs_plain(B, T, F, W, dtype):
    """The tiled trace's scan from the high-f end gives the plain
    version's indices, at the kernel's tile (6144 f: F = 12300 takes three
    tiles where the ridge is low) and at narrow tiles that split the rows
    into many."""
    e, v = _inputs(B, T, F, dtype, T + F)
    e[:, ::5] = 0.5                          # constant columns: ties
    eps = float(np.finfo(dtype).eps)
    pe = ridge_forward_plain(e, v, 2.)
    ref = ridge_trace_plain(pe, e, v, 2., eps)
    got, tiles = _tiled_trace_mirror(pe, e, v, 2., eps,
                                     *(() if W is None else (W,)))
    assert torch.equal(got, ref)
    assert tiles >= B * (T - 1)


def test_tiled_trace_mirror_nan():
    """NaN rows in the tiled trace: the argmin takes the first NaN, and
    nothing qualifies against a NaN val."""
    e, v = _inputs(2, 30, 200, 'float32', 5)
    e[:, 20:23, 3] = float('nan')
    pe = ridge_forward_plain(e, v, 2.)
    assert pe.isnan().any()
    eps = float(np.finfo(np.float32).eps)
    got, _ = _tiled_trace_mirror(pe, e, v, 2., eps, 64)
    assert torch.equal(got, ridge_trace_plain(pe, e, v, 2., eps))


def test_tiled_plan_forced_and_lowered_limit(monkeypatch):
    """`tiled=True` at the main path's F = 293 (one row tile, one chunk);
    the resident plan's limit lowered takes F = 300 to the tiled mode."""
    p = ridge_plan(293, 4, tiled=True)
    assert p.tiled and p.row_ranges == ((0, 293),) and p.chunks == 1
    assert not ridge_plan(293, 4).tiled
    monkeypatch.setattr(ridge_cuda, '_SMEM_MAX', 1024)
    assert ridge_plan(300, 8).tiled and not ridge_resident(300, 8)
