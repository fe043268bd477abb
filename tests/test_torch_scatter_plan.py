# -*- coding: utf-8 -*-
"""The reassignment kernels of `csrc/scatter_kv.cu` on the CPU: the
scatters B2 (`scatter_kv`) and B5 (`shift_scatter`) and the fused
reassignment B4 (`ssq_fused`). Their launch plan (`ops/ssq_cuda.py::
scatter_plan`, on a model of the kernel's shared memory and of the
H100's), a mirror of the kernel's loops (`ring_scatter`: which
ring stage holds row i, when it is copied and summed, the wait depth, the
ragged last block, B5's mask word, B4's bins from the landed cells, a
chunk's rows forwarded to later rows of the same bin) run on small
float64 inputs, and the shared-memory wavefronts of the ring and the
accumulator. No card and no kernel run here; the mirror follows
`ring_scatter` line for line, so change both together.

Bank model: shared memory serves 128 bytes per wavefront, so a warp's
4-byte accesses are served per warp, 8-byte ones per half-warp of 16
threads and 16-byte ones per quarter-warp of 8; element `a` of such a
group lies on bank group `a mod (128 / width)`, and a group is free of
conflicts when no two threads read different elements of one bank group.
"""
from collections import deque

import numpy as np
import pytest
import torch

from ssqueezepy_tpu_torch.ops.phase import phase_transform_w
from ssqueezepy_tpu_torch.ops.ssq_cuda import (ScatterPlan, scatter_kv_plain,
                                               scatter_plan,
                                               shift_scatter_plain,
                                               ssq_fused_plain)
from ssqueezepy_tpu_torch.ops.ssq_kernels import compute_bins, ssq_bin_params

ITEMSIZE = {'float32': 8, 'float64': 16}
MAX_NBINS = {'float32': 25600, 'float64': 12800}
HEADLINE = [293, 300]          # ssq_cwt's bins, ssq_stft's rows (n_fft 598)
ROWS = 8                       # the kernel's kRows


def _cell(itemsize, has_valid, has_const=True):
    """Bytes of one cell in B2/B5's ring: value, const, k, mask word."""
    return (itemsize + (itemsize // 2 if has_const else 0) + 4
            + (4 if has_valid else 0))


def _smem(nbins, itemsize, has_valid, has_const, sfs, columns, stages):
    """`smem_bytes`: the accumulator and the ring; B4 (`sfs` not None)
    rings values and derivatives per cell, the const (and Sfs) per row,
    and holds one stage's bins."""
    acc = (nbins + 1) * itemsize * columns
    if sfs is None:
        return acc + stages * ROWS * columns * _cell(itemsize, has_valid,
                                                     has_const)
    return (acc + stages * ROWS * columns * 2 * itemsize
            + stages * ROWS * itemsize // 2 * (2 if sfs else 1)
            + ROWS * columns * 4)


def _occupancy(nbins, itemsize, has_valid, has_const, sfs=None):
    """A model of the card's `scatter_occupancy` for one kernel:
    (columns, stages) -> the block's shared bytes (`smem_bytes`) and the
    blocks per SM shared memory and threads allow on an H100 (227 KB per
    block, 228 KB per SM, 1 KB per resident block kept by the runtime,
    128-byte granules, at most 32 blocks and 2048 threads per SM; 0 where
    the block does not fit, has more than the kernel's 16 stages or more
    than 256 threads: B4 runs one per cell of a stage). Registers are not
    modelled: the card test holds the plans the runtime gives."""
    threads = ROWS if sfs is not None else 1

    def occupancy(columns, stages):
        smem = _smem(nbins, itemsize, has_valid, has_const, sfs, columns,
                     stages)
        if smem > 232448 or stages > 16 or threads * columns > 256:
            return smem, 0
        per_block = -(-smem // 128) * 128 + 1024
        return smem, min(32, 2048 // (threads * columns),
                         233472 // per_block)
    return occupancy


def _plan(nbins, itemsize, has_valid=False, has_const=True, sfs=None):
    return scatter_plan(nbins, itemsize, _occupancy(nbins, itemsize,
                                                    has_valid, has_const,
                                                    sfs))


# ---- the plan --------------------------------------------------------------

# (mask, const, Sfs): B2 and B5 with both; B5 mask only, neither (Sfs
# None); B4 without and with Sfs (its const always)
PLANES = [pytest.param(v, c, None, id='%s-%s' % (v, c)) for v, c in (
    (False, True), (True, True), (True, False), (False, False))] + [
    pytest.param(False, True, sfs, id='b4-sfs' if sfs else 'b4')
    for sfs in (False, True)]
KINDS = [p.values for p in PLANES]


@pytest.mark.parametrize('has_valid,has_const,sfs', PLANES)
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
@pytest.mark.parametrize('nbins', [1, 2, 31, 293, 300, 598, 4096, 'max'])
def test_plan_fits_the_card(nbins, dtype, has_valid, has_const, sfs):
    """Per block at most 227 KB; per SM the resident blocks with their
    128-byte granules and the runtime's 1 KB each within 228 KB; at most
    32 blocks and 2048 threads per SM; the smem the ring and accumulator
    need; the in-flight figure as the plan defines it; and at the
    headline at least 16 KB in flight per SM."""
    nbins = MAX_NBINS[dtype] if nbins == 'max' else nbins
    it = ITEMSIZE[dtype]
    p = _plan(nbins, it, has_valid, has_const, sfs)
    assert 1 <= p.columns <= 128 // it and 2 <= p.stages <= 16
    args = (nbins, it, has_valid, has_const, sfs, p.columns)
    stage = _smem(*args, 3) - _smem(*args, 2)
    assert p.smem == _smem(*args, p.stages)
    assert p.smem <= 232448
    granted = -(-p.smem // 128) * 128 + 1024
    assert 1 <= p.blocks_per_sm <= 32
    assert p.blocks_per_sm * p.columns * (1 if sfs is None else ROWS) \
        <= 2048
    assert p.blocks_per_sm * granted <= 233472
    assert p.inflight == (p.stages - 1) * stage * p.blocks_per_sm
    if nbins in HEADLINE:
        assert p.inflight >= 16 * 1024


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_plan_accepts_what_the_parent_accepted(dtype):
    """Every nbins the column plans before the ring took (one column's
    accumulator within 200 KB: 25600 bins in complex64, 12800 in
    complex128, B4's bound until it moved onto the ring) is taken by
    every kernel, B4 with and without Sfs included; past it all raise."""
    it = ITEMSIZE[dtype]
    top = MAX_NBINS[dtype]
    assert top * it == 200 * 1024
    for nbins in sorted(set(np.r_[1:70, 280:310, 590:610, 4090:4100,
                                  top - 40:top + 1].tolist())):
        for hv, hc, sfs in KINDS:
            assert _plan(nbins, it, hv, hc, sfs).columns >= 1
    for nbins in (top + 1, top + 7, 2 * top):
        for hv, hc, sfs in KINDS:
            with pytest.raises(NotImplementedError):
                _plan(nbins, it, hv, hc, sfs)


def test_plan_at_the_headline():
    """ssq_cwt's 293 bins: one 128-byte line of values per row (16
    columns in complex64, 8 in complex128), five blocks per SM, a
    three-stage ring of 8 rows (the H100 sweep's best; four stages for
    B5 with neither mask nor const, whose stages are smaller), the
    accumulator (294 bins with the spare) 37632 bytes."""
    for itemsize, columns in ((8, 16), (16, 8)):
        p = _plan(293, itemsize)
        assert (p.columns, p.stages, p.blocks_per_sm) == (columns, 3, 5)
        assert p.smem - p.stages * ROWS * _cell(itemsize, False) \
            * columns == 37632
    assert _plan(293, 8, False, False)[:3] == (16, 4, 43776)


def test_fused_plan_at_the_headline():
    """B4 at ssq_cwt's 293 bins and ssq_stft's 300 (with Sfs): one 128-byte
    line of values per row, 8 x 16 = 128 threads per block in complex64
    (8 x 8 in complex128), five blocks per SM and a three-stage ring, the
    H100 sweep's best; the accumulator with its spare bin 37632 or 38528
    bytes, a stage's bins 512 bytes."""
    for nbins, sfs, itemsize, columns in ((293, False, 8, 16),
                                          (293, False, 16, 8),
                                          (300, True, 8, 16),
                                          (293, True, 8, 16)):
        p = _plan(nbins, itemsize, sfs=sfs)
        assert (p.columns, p.stages, p.blocks_per_sm) == (columns, 3, 5)
        assert p.inflight >= 16 * 1024
        lay = _layout(p, nbins, itemsize, False, True, sfs)
        assert lay['v'] == (nbins + 1) * columns * itemsize
        assert lay['end'] - lay['kb'] == 8 * columns * 4
    assert _plan(293, 8, sfs=False).smem == 44384


# ---- the kernel's loops, mirrored ------------------------------------------

def _layout(plan, nbins, itemsize, has_valid, has_const, sfs=None):
    """Byte offsets of the accumulator and the ring's planes in dynamic
    shared memory, and its end, as `ring_scatter` carves them: acc
    (nbins + 1, TC) complex (the spare bin last), then per plane (S, R,
    TC): values, consts, k, mask words. B4 (`sfs` not None), as
    `ring_fused` carves them: acc, then values and derivatives (S, R, TC),
    consts and Sfs (S, R), one stage's bins (R, TC) int32."""
    TC, R, S = plan.columns, ROWS, plan.stages
    ring = S * R * TC
    acc = 0
    v = acc + (nbins + 1) * TC * itemsize
    if sfs is not None:
        d = v + ring * itemsize
        c = d + ring * itemsize
        s = c + S * R * itemsize // 2
        kb = s + (S * R * itemsize // 2 if sfs else 0)
        return dict(acc=acc, v=v, d=d, c=c, s=s, kb=kb, end=kb + R * TC * 4)
    c = v + ring * itemsize
    k = c + (ring * itemsize // 2 if has_const else 0)
    m = k + ring * 4
    end = m + (ring * 4 if has_valid else 0)
    return dict(acc=acc, v=v, c=c, k=k, m=m, end=end)


def ring_mirror(vr, vi, k, valid, cst, nbins, plan, wrap, land, base=0,
                depth=None, fused=None):
    """`ring_scatter` for every block and signal at once (every thread
    runs one schedule): out (B, nbins, N) real and imaginary parts.

    vr, vi, k (B, na, N); valid (B, na, N) bool or None; cst (na,) or
    None. `land`: 'late' lands a group's copies only when the wait makes
    it complete (a wrong wait depth then reads stale slots), 'early' at
    once (a stage copied over before it was summed then shows). `base`:
    the low bits of the mask plane's address (any alignment). `depth`:
    the groups left pending by the wait (the kernel's S - 1). `fused`
    (B4, `ring_fused`; k None): dict of the derivative's parts `dr`, `di`
    (B, na, N), `sfs` (na,) or None and `kfun(vr, vi, dr, di, sfs)`, the
    bins of cells from their landed values (-1 where gated). B4 waits
    (S - 2 groups pending) and crosses the block's barrier before it
    issues the next chunk: each of its threads copies one cell of a
    chunk, and after the barrier the block sees the chunk whole, as every
    thread here does."""
    B, na, N = vr.shape
    TC, R, S = plan.columns, ROWS, plan.stages
    nblk = -(-N // TC)
    # the grid: blockIdx.x * TC + threadIdx.x; threads past N return
    j_all = (np.arange(nblk)[:, None] * TC + np.arange(TC)[None]).ravel()
    live = j_all < N
    j = j_all[live]
    assert np.array_equal(np.sort(j), np.arange(N))
    bb = np.repeat(np.arange(B), j.size)
    jj = np.tile(j, B)
    # the mask plane in device memory: bytes from `base`, read as the
    # aligned little-endian word that holds each cell's byte
    mem = np.zeros(base + B * na * N + 8, np.uint8)
    if valid is not None:
        mem[base:base + B * na * N] = valid.ravel()
    m0 = base + bb * na * N + jj          # the kernel's m0, per thread

    rv = np.zeros((S, R, bb.size))
    ri = np.zeros((S, R, bb.size))
    rc = np.zeros((S, R, bb.size))
    rk = np.zeros((S, R, bb.size), np.int64)
    rm = np.zeros((S, R, bb.size), np.uint32)
    rd = np.zeros((S, R, bb.size))
    rdi = np.zeros((S, R, bb.size))
    rs = np.zeros((S, R, bb.size))
    owner = [None] * S                    # chunk a stage holds
    landed, summed = set(), set()
    pending = deque()

    def copy(s, r, i):
        rv[s, r], ri[s, r] = vr[bb, i, jj], vi[bb, i, jj]
        if cst is not None:
            rc[s, r] = cst[i]
        if fused is not None:
            rd[s, r] = fused['dr'][bb, i, jj]
            rdi[s, r] = fused['di'][bb, i, jj]
            if fused['sfs'] is not None:
                rs[s, r] = fused['sfs'][i]
            return
        rk[s, r] = k[bb, i, jj]
        a = m0 + i * N
        w = a & ~3
        rm[s, r] = (mem[w].astype(np.uint32) | mem[w + 1].astype(np.uint32)
                    << 8 | mem[w + 2].astype(np.uint32) << 16
                    | mem[w + 3].astype(np.uint32) << 24)

    def issue(c, s):
        rows = [(s, r, c * R + r) for r in range(R) if c * R + r < na]
        if rows:
            assert owner[s] is None or owner[s] in summed, (
                "stage %d copied over before chunk %s was summed"
                % (s, owner[s]))
            owner[s] = c
        if land == 'early':
            for cell in rows:
                copy(*cell)
            landed.add(c)
        pending.append((c, rows))

    def wait(n):                          # cp.async.wait_group n
        while len(pending) > n:
            c, rows = pending.popleft()
            if land == 'late':
                for cell in rows:
                    copy(*cell)
                landed.add(c)

    for c in range(S - 1):
        issue(c, c)
    acc_r = np.zeros((B, nbins + 1, N))    # the spare bin last
    acc_i = np.zeros((B, nbins + 1, N))
    chunks = -(-na // R)
    si, sc = S - 1, 0
    for c in range(chunks):
        if fused is None:
            issue(c + S - 1, si)
            si = 0 if si + 1 == S else si + 1
            wait(S - 1 if depth is None else depth)
        else:
            # B4: the pair's wait and barrier first, then the next copies
            # into the stage both lanes summed one iteration ago
            wait(S - 2 if depth is None else depth)
            issue(c + S - 1, si)
            si = 0 if si + 1 == S else si + 1
        assert owner[sc] == c and c in landed
        # the chunk's R rows to their bins (dropped cells and stale slots
        # past na to the spare bin nbins), every accumulator cell read,
        # then forwarded from an earlier row of the same bin, summed, and
        # written back in row order
        kk = np.empty((R, bb.size), np.int64)
        for r in range(R):
            i = c * R + r
            if fused is not None:
                b = fused['kfun'](rv[sc, r], ri[sc, r], rd[sc, r], rdi[sc, r],
                                  None if fused['sfs'] is None
                                  else rs[sc, r])
            else:
                b = rk[sc, r].copy()
            if wrap:
                b = np.where(b < 0, b + nbins, b)
            ok = (i < na) & (b >= 0) & (b < nbins)
            if valid is not None:
                sh = (((m0 + i * N) & 3) * 8).astype(np.uint32)
                ok &= ((rm[sc, r] >> sh) & 0xff) != 0
            kk[r] = np.where(ok, b, nbins)
        s_r = [acc_r[bb, kk[r], jj] for r in range(R)]
        s_i = [acc_i[bb, kk[r], jj] for r in range(R)]
        for r in range(R):
            for q in range(r):
                same = kk[q] == kk[r]
                s_r[r] = np.where(same, s_r[q], s_r[r])
                s_i[r] = np.where(same, s_i[q], s_i[r])
            if cst is None:
                s_r[r] = s_r[r] + rv[sc, r]
                s_i[r] = s_i[r] + ri[sc, r]
            else:
                s_r[r] = s_r[r] + rv[sc, r] * rc[sc, r]
                s_i[r] = s_i[r] + ri[sc, r] * rc[sc, r]
        for r in range(R):
            acc_r[bb, kk[r], jj] = s_r[r]
            acc_i[bb, kk[r], jj] = s_i[r]
        summed.add(c)
        sc = 0 if sc + 1 == S else sc + 1
    assert summed == set(range(chunks))
    return acc_r[:, :nbins], acc_i[:, :nbins]


def column_loop(vr, vi, k, valid, cst, nbins, wrap):
    """The function, one column at a time, rows ascending."""
    B, na, N = k.shape
    out_r = np.zeros((B, nbins, N))
    out_i = np.zeros((B, nbins, N))
    for b in range(B):
        for j in range(N):
            for i in range(na):
                kk = int(k[b, i, j])
                if wrap and kk < 0:
                    kk += nbins
                if valid is not None and not valid[b, i, j]:
                    continue
                if 0 <= kk < nbins:
                    if cst is None:
                        out_r[b, kk, j] += vr[b, i, j]
                        out_i[b, kk, j] += vi[b, i, j]
                    else:
                        out_r[b, kk, j] += vr[b, i, j] * cst[i]
                        out_i[b, kk, j] += vi[b, i, j] * cst[i]
    return out_r, out_i


def _inputs(B, na, N, nbins, seed):
    rng = np.random.default_rng(seed)
    vr = rng.standard_normal((B, na, N))
    vi = rng.standard_normal((B, na, N))
    k = rng.integers(-2 * nbins - 2, 2 * nbins + 2, (B, na, N))
    k[..., 0, :min(N, 4)] = [-1, -nbins, -nbins - 1, nbins][:min(N, 4)]
    valid = rng.random((B, na, N)) > .2
    cst = rng.random(na) + .5
    return vr, vi, k, valid, cst


# (B, na, N, nbins, (columns, stages) or None for the plan's own): odd N
# and a ragged last block, na below one stage, na not a multiple of R, na
# over the whole ring, a batch of 3
MIRROR_CASES = [
    (1, 13, 37, 7, None),
    (3, 5, 31, 4, None),
    (3, 17, 33, 9, (8, 3)),
    (1, 1, 1, 1, (32, 2)),
    (2, 29, 19, 6, (4, 5)),
    (3, 40, 11, 5, (8, 2)),
    (1, 9, 70, 3, (32, 4)),
]
MODES = ['b2', 'b5 valid const', 'b5 valid', 'b5 const', 'b5']


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('case', MIRROR_CASES)
def test_ring_mirror_equals_column_loop(case, mode):
    """The mirror of the kernel's loops, landing each stage as late and as
    early as the hardware may, equals the plain per-column loop bit for
    bit and the port's plain version within 1e-12, for B2 and the four
    instantiations of B5; the mask read at every alignment."""
    B, na, N, nbins, shape = case
    vr, vi, k, valid, cst = _inputs(B, na, N, nbins, seed=na * N + nbins)
    wrap = mode != 'b2'
    valid = valid if 'valid' in mode else None
    cst = cst if mode == 'b2' or 'const' in mode else None
    itemsize = 16
    plan = _plan(nbins, itemsize, valid is not None, cst is not None)
    if shape is not None:
        plan = plan._replace(columns=shape[0], stages=shape[1])
    ref_r, ref_i = column_loop(vr, vi, k, valid, cst, nbins, wrap)
    for land in ('late', 'early'):
        for base in ((0, 1, 2, 3) if valid is not None else (0,)):
            out_r, out_i = ring_mirror(vr, vi, k, valid, cst, nbins, plan,
                                       wrap, land, base)
            assert np.array_equal(out_r, ref_r)
            assert np.array_equal(out_i, ref_i)
    v = torch.from_numpy(vr + 1j * vi)
    kt = torch.from_numpy(k.astype(np.int32))
    ct = None if cst is None else torch.from_numpy(cst)
    if mode == 'b2':
        plain = scatter_kv_plain(v, kt, ct, nbins)
    else:
        plain = shift_scatter_plain(
            v, kt, None if valid is None else torch.from_numpy(valid),
            nbins, ct)
    plain = plain.numpy()
    err = max(np.abs(plain.real - ref_r).max(),
              np.abs(plain.imag - ref_i).max())
    assert err <= 1e-12 * max(np.abs(plain).max(), 1.)


def test_ring_mirror_catches_a_wrong_wait():
    """The mirror is strict: with one group more left pending than the
    kernel's S - 1, a chunk is summed before its copies landed."""
    vr, vi, k, _, cst = _inputs(1, 30, 9, 4, seed=0)
    plan = ScatterPlan(columns=4, stages=3, smem=0, blocks_per_sm=1,
                       inflight=0)
    ring_mirror(vr, vi, k, None, cst, 4, plan, False, 'late')
    with pytest.raises(AssertionError):
        ring_mirror(vr, vi, k, None, cst, 4, plan, False, 'late',
                    depth=plan.stages)


# ---- B4: the bins from the landed cells ------------------------------------

def _grid(mode, n):
    """An ssq frequency grid of each bin-map mode, n bins."""
    if mode == 'lin':
        return np.linspace(0.008, 0.5, n)
    if mode == 'log':
        return 2 ** np.linspace(np.log2(1 / 2048), np.log2(0.5), n)
    n0 = n // 2
    lo, mid = np.log2(1 / 2048), np.log2(1 / 64)
    seg0 = 2 ** (lo + (mid - lo) / n0 * np.arange(n0 + 1))
    seg1 = seg0[-1] * 2 ** ((mid - lo) / n0 / 4 * np.arange(1, n - n0))
    return np.concatenate([seg0, seg1])


def _fused_inputs(B, na, N, seed):
    """Wx, dWx parts (B, na, N), const and Sfs (na,); |Wx| under gamma =
    0.3 on ~4% of cells, one row-0 cell of Wx zero (w not finite)."""
    rng = np.random.default_rng(seed)
    vr, vi, dr, di = rng.standard_normal((4, B, na, N))
    vr[0, 0, 0] = vi[0, 0, 0] = 0.
    cst = rng.random(na) + .5
    sfs = np.linspace(0, .5, na)
    return vr, vi, dr, di, cst, sfs


def _kfun(params, gamma, flipud):
    """B4's bin of each cell from its values, as the plain version
    (`ssq_fused_plain`) bins them: -1 where gated or w is not finite."""
    def kfun(vr, vi, dr, di, sfs):
        shape = vr.shape
        W = torch.from_numpy(vr + 1j * vi).reshape(-1, 1)
        dW = torch.from_numpy(dr + 1j * di).reshape(-1, 1)
        S = None if sfs is None else torch.from_numpy(
            np.broadcast_to(sfs, shape).ravel().copy())
        k, valid = compute_bins(phase_transform_w(W, dW, gamma, S), params,
                                flipud)
        return torch.where(valid, k, -1).numpy().reshape(shape)
    return kfun


# (B, na, N, nbins, (columns, stages) or None for the plan's own): odd N
# and a ragged last block, na below one stage, na over the whole ring, a
# batch of 3
FUSED_CASES = [
    (1, 13, 37, 7, None),
    (3, 5, 31, 9, None),
    (3, 17, 33, 9, (8, 3)),
    (2, 29, 19, 6, (4, 5)),
]


@pytest.mark.parametrize('with_sfs', [False, True])
@pytest.mark.parametrize('flipud', [False, True])
@pytest.mark.parametrize('mode', ['lin', 'log', 'log-piecewise'])
@pytest.mark.parametrize('case', FUSED_CASES)
def test_fused_ring_mirror_equals_column_loop(case, mode, flipud, with_sfs):
    """B4: the mirror of the kernel's loops, each stage's bins computed
    from its landed cells (Wx, dWx, Sfs) and landing as late and as early
    as the hardware may, equals the plain per-column loop on the plain
    version's bins (gated cells dropped) bit for bit, and
    `ssq_fused_plain` within 1e-12, for every bin map, flipud and Sfs."""
    B, na, N, nbins, shape = case
    gamma = .3
    params = ssq_bin_params(_grid(mode, nbins), mode != 'lin')
    assert params['mode'] == mode
    vr, vi, dr, di, cst, sfs = _fused_inputs(B, na, N, seed=na * N + nbins)
    sfs = sfs if with_sfs else None
    kfun = _kfun(params, gamma, flipud)
    k = kfun(vr, vi, dr, di, None if sfs is None
             else np.broadcast_to(sfs[:, None], (B, na, N)))
    assert (k == -1).any() and (k >= 0).any()
    plan = _plan(nbins, 16, sfs=sfs is not None)
    if shape is not None:
        plan = plan._replace(columns=shape[0], stages=shape[1])
    ref_r, ref_i = column_loop(vr, vi, k, None, cst, nbins, False)
    fused = dict(dr=dr, di=di, sfs=sfs, kfun=kfun)
    for land in ('late', 'early'):
        out_r, out_i = ring_mirror(vr, vi, None, None, cst, nbins, plan,
                                   False, land, fused=fused)
        assert np.array_equal(out_r, ref_r)
        assert np.array_equal(out_i, ref_i)
    plain = ssq_fused_plain(
        torch.from_numpy(vr + 1j * vi), torch.from_numpy(dr + 1j * di),
        torch.from_numpy(cst), params, gamma, flipud,
        None if sfs is None else torch.from_numpy(sfs)).numpy()
    err = max(np.abs(plain.real - ref_r).max(),
              np.abs(plain.imag - ref_i).max())
    assert err <= 1e-12 * max(np.abs(plain).max(), 1.)


def test_fused_ring_mirror_catches_a_wrong_wait():
    """B4's mirror is as strict: one group more left pending than S - 1
    bins a chunk from slots its copies have not reached."""
    vr, vi, dr, di, cst, sfs = _fused_inputs(1, 30, 9, seed=0)
    params = ssq_bin_params(_grid('log', 5), True)
    fused = dict(dr=dr, di=di, sfs=sfs, kfun=_kfun(params, .3, True))
    plan = ScatterPlan(columns=4, stages=3, smem=0, blocks_per_sm=1,
                       inflight=0)
    ring_mirror(vr, vi, None, None, cst, 5, plan, False, 'late',
                fused=fused)
    with pytest.raises(AssertionError):
        ring_mirror(vr, vi, None, None, cst, 5, plan, False, 'late',
                    depth=plan.stages, fused=fused)


# ---- shared-memory wavefronts ----------------------------------------------

def _wavefronts(addr, width):
    """Wavefronts of one warp's access: byte addresses of its 32 threads
    (or fewer), `width` bytes each."""
    g = 128 // width
    addr = np.asarray(addr)
    total = 0
    for grp in np.array_split(addr, -(-addr.size // g)):
        el = np.unique(grp // width)
        total += np.bincount(el % g).max()
    return total


@pytest.mark.parametrize('has_valid,has_const,sfs', PLANES)
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
@pytest.mark.parametrize('nbins', HEADLINE)
def test_ring_and_accumulator_conflict_free(nbins, dtype, has_valid,
                                            has_const, sfs):
    """At the headline plans every warp-row of the ring (the copies'
    writes and the sums' reads: value, k, mask word) takes the fewest
    wavefronts its bytes need, in every stage and row; so does the
    accumulator's read-modify-write for any bins the threads hold
    (element kk * TC + t: TC a multiple of 128 / width puts thread t on
    bank group t); and the planes end where the plan's shared memory
    does. B4 (`ring_fused`): each warp's copies and reads of its cells
    (value, derivative, the rows' const and Sfs) and its bins, the sum
    lanes' reads of their part of every row's values and bins, and the
    accumulator's floats [bin][part][column] in the sums and the
    write-out."""
    it = ITEMSIZE[dtype]
    p = _plan(nbins, it, has_valid, has_const, sfs)
    lay = _layout(p, nbins, it, has_valid, has_const, sfs)
    assert lay['end'] == p.smem
    TC, R, S = p.columns, ROWS, p.stages
    assert TC * it == 128                    # one line of values per row
    rng = np.random.default_rng(nbins)
    if sfs is not None:
        # each warp of ring_fused: thread t holds cell (t / TC, t % TC) of a
        # stage; the sum lanes q < 2 TC their column and part
        it2 = it // 2
        for w0 in range(0, ROWS * TC, 32):
            t = np.arange(w0, min(w0 + 32, ROWS * TC))
            row, cc = t // TC, t % TC
            for st in range(S):
                for name, w in (('v', it), ('d', it)):   # copies, bins
                    addr = lay[name] + ((st * R + row) * TC + cc) * w
                    assert _wavefronts(addr, w) == -(-t.size * w // 128)
                for name in ('c', 's')[:1 + bool(sfs)]:   # broadcasts
                    addr = lay[name] + (st * R + row) * it2
                    assert _wavefronts(addr, it2) == -(-t.size * it2 // 128)
            assert _wavefronts(lay['kb'] + t * 4, 4) == 1
        H = min(TC, 16)
        q = np.arange(min(2 * TC, 32))
        col, part = q // (2 * H) * H + q % H, q // H & 1
        for st in range(S):
            for r in range(R):
                e = (st * R + r) * TC + col
                addr = lay['v'] + e * it + part * it2
                assert _wavefronts(addr, it2) == -(-q.size * it2 // 128)
                assert _wavefronts(lay['kb'] + (r * TC + col) * 4, 4) == 1
        for _ in range(64):
            kk = rng.integers(0, nbins + 1, TC)[col]   # the spare bin too
            addr = lay['acc'] + ((kk * 2 + part) * TC + col) * it2
            assert _wavefronts(addr, it2) == -(-q.size * it2 // 128)
        # the write-out: 2 TC threads per bin
        for b0 in range(0, 8):
            addr = lay['acc'] + ((b0 * 2 + part) * TC + col) * it2
            assert _wavefronts(addr, it2) == -(-q.size * it2 // 128)
        return
    t = np.arange(TC)
    planes = ([('v', it), ('k', 4)] + ([('c', it // 2)] if has_const
                                       else [])
              + ([('m', 4)] if has_valid else []))
    for s in range(S):
        for r in range(R):
            for name, w in planes:
                addr = lay[name] + ((s * R + r) * TC + t) * w
                assert addr.min() % w == 0
                assert _wavefronts(addr, w) == -(-TC * w // 128)
    for _ in range(64):
        kk = rng.integers(0, nbins + 1, TC)       # the spare bin too
        addr = lay['acc'] + (kk * TC + t) * it
        assert _wavefronts(addr, it) == -(-TC * it // 128)
