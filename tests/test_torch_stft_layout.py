# -*- coding: utf-8 -*-
"""The DFT engine of the STFT table kernel (`csrc/stft_conv.cu` on
`csrc/dft_mixed.cuh`: B6 in its modes 0 Sx, 1 Sx + dSx, 2 Sx + bins, and
B7, mode 3) on the CPU: its launch plan, its shared-memory access
patterns and the index arithmetic of its mixed-radix passes. No card and
no kernel run here; the thread maps below mirror the kernel's loops
(`stft_stage1`, `stft_stage2`, `dft::stockham_pass`) and use the
wrapper's own `launch_plan` (whose `direct` says whether the first pass
reads device memory), `radices`, `smem_index` and `swz`; stage 1's
products of a banded table row (the band plan) through the kernel's
addresses. The
engine the kernel ran before (`stockham`, `stage1`, `stage2`: sequences
at stride L, the position fastest in the passes) is kept here as a
frozen model that the counts compare with.

Bank model: shared memory serves 128 bytes per wavefront, so a warp's
8-byte (complex64) accesses are served per half-warp of 16 threads and
16-byte (complex128) ones per quarter-warp of 8; element `a` of such a
group lies on bank group `a mod 16` (or `a mod 8`), and a group needs as
many wavefronts as the most distinct elements it reads or writes in one
bank group.
"""
import functools
import os
import re

import numpy as np
import pytest

from ssqueezepy_tpu_torch.ops import stft_cuda
from ssqueezepy_tpu_torch.ops.cwt_cuda import smem_index, swz
from ssqueezepy_tpu_torch.ops.stft_cuda import (launch_plan, radices,
                                                split_fft_len)

BENCH_N = 160000               # the ssq_stft / ssq_stft2 headline
BENCH_NP2 = 163840             # next_fft_len(160000 + 598 - 1) = 320 x 512
ITEMSIZE = {'float32': 8, 'float64': 16}
# mode: planes the DFT carries, planes the stage-2 epilogue reads
MODES = {0: (1, 1), 1: (2, 2), 2: (2, 2), 3: (5, 5)}
THREADS = 256


def _wavefronts(addr, active, itemsize):
    """Wavefronts each thread group needs for one instruction: `addr`
    holds one element index per thread id e (e = tid + 256 * iteration,
    so aligned runs of the group size share a wavefront), `active` masks
    the threads that access."""
    g = 128 // itemsize
    n = -(-len(addr) // g) * g
    a = np.full(n, -1, np.int64)
    a[:len(addr)] = np.where(active, addr, -1)
    return np.array([np.bincount(grp[grp >= 0] % g).max()
                     if (grp >= 0).any() else 0
                     for grp in map(np.unique, a.reshape(-1, g))])


def _all(n):
    return np.ones(n, bool)


def _stockham(L, nseq, stride, bufs, seq_fastest):
    """The passes of a Stockham transform of `nseq` length-L sequences at
    `stride`: pass k reads the buffer at bufs[k] and writes the one at
    bufs[k + 1] (element counts from the start of dynamic shared memory,
    whose first L elements are the twiddle table); bufs[0] None: the
    first pass reads device memory, and its `src` holds the positions
    smem_index(q, i, stride). One butterfly per thread id e: the engine
    puts the sequence fastest (q = e mod nseq, j = e div nseq), the
    parent the position (s = e div L/R, j = e mod L/R). Per pass:
    dict(R, Ns, LR, tstep, src (R arrays), tw (R - 1 arrays of twiddle
    elements, r >= 1), dst (R arrays)), and the base of the buffer
    holding the result."""
    out = []
    for k, (R, Ns) in enumerate(radices(L)):
        LR, tstep = L // R, L // (Ns * R)
        e = np.arange(nseq * LR)
        if seq_fastest:
            q, j = e % nseq, e // nseq
        else:
            q, j = e // LR, e % LR
        jm = j % Ns
        a = bufs[k] or 0
        src = [a + smem_index(q, j + r * LR, stride) for r in range(R)]
        tw = [r * jm * tstep for r in range(1, R)]
        dst = [bufs[k + 1] + smem_index(q, (j - jm) * R + jm + k_ * Ns,
                                        stride) for k_ in range(R)]
        out.append(dict(R=R, Ns=Ns, LR=LR, tstep=tstep, src=src, tw=tw,
                        dst=dst))
    return out, bufs[len(out)]


def _ping_pong(a, b, n, first_in_memory):
    """Buffer bases the passes read and write in turn: a, b, a, ... (the
    parent: its gather filled a), or None, a, b, ... (the engine: the
    first pass reads device memory)."""
    head = [None] if first_in_memory else []
    return head + [(a, b)[i % 2] for i in range(n + 1)]


def _parent_patterns(L, P, stage, N, f1, planes, read_planes):
    """{pattern: [(addresses, active), ...]} of one block of the parent's
    `stage1` / `stage2` (k1_0 = 0 in stage 2), one entry per load or store
    instruction: sequence plane * P + p at (plane * P + p) * L + i; the
    gathers and the stage-2 epilogue put the column p fastest and the
    position next, the stage-1 epilogue the position fastest."""
    nseq, e = planes * P, np.arange(P * L)
    pats = {'twiddle table fill': [(np.arange(L), _all(L))]}
    p, pos = e % P, e // P
    pats['gather store'] = [(L + (q * P + p) * L + pos, _all(e.size))
                            for q in range(planes)]
    passes, res = _stockham(L, nseq, L, _ping_pong(L, L + nseq * L, L,
                                                    False), False)
    pats['radix passes'] = []
    for ps in passes:
        n = ps['src'][0].size
        pats['radix passes'] += [(ps['src'][0], _all(n))]
        for s_, t_ in zip(ps['src'][1:], ps['tw']):
            pats['radix passes'] += [(s_, _all(n)), (t_, _all(n))]
        if ps['R'] in (3, 5):
            # each output k sums R - 1 table twiddles (one address each)
            for k in range(ps['R']):
                pats['radix passes'] += [
                    (np.full(n, ((r * k) % ps['R']) * ps['LR']), _all(n))
                    for r in range(1, ps['R'])]
                pats['radix passes'] += [(ps['dst'][k], _all(n))]
        else:
            pats['radix passes'] += [(d, _all(n)) for d in ps['dst']]
    if stage == 1:
        k1, p = e % L, e // L
        pats['epilogue'] = [(res + (q * P + p) * L + k1, _all(e.size))
                            for q in range(planes)]
    else:
        k2hi = -(-N // f1)
        e = np.arange(P * k2hi)
        p, k2 = e % P, e // P
        act = p + f1 * k2 < N
        pats['epilogue'] = [(res + (q * P + p) * L + k2, act)
                            for q in range(read_planes)]
    return pats


def _engine_bufs(L, nseq, S, n, direct):
    """Buffer bases the engine's passes read and write in turn: device
    memory, a, b, a, ... (direct), or b (the gather's), a, b, ..."""
    a, b = L, L + nseq * S
    return _ping_pong(a, b, n, True) if direct else _ping_pong(b, a, n, False)


def _engine_patterns(plan, stage, N, planes, read_planes):
    """{pattern: [(addresses, active), ...]} of one block of the engine's
    `stft_stage1` / `stft_stage2` (k1_0 = 0 in stage 2): sequence
    plane * P + p at smem_index(plane * P + p, i, S); the passes put the
    sequence fastest, with one or two planes the first one reading device
    memory (no shared-memory load), with five a gather storing first,
    the column p fastest and positions walked through swz (a thread
    group's 16 / P positions lie P apart); the stage-2 epilogue walks k2
    the same way, the stage-1 epilogue puts the position k1 fastest."""
    L, P, S, sw = ((plan.f1, plan.P1, plan.S1, plan.sw1) if stage == 1
                   else (plan.f2, plan.P2, plan.S2, plan.sw2))
    nseq, e = planes * P, np.arange(P * L)
    lgP = P.bit_length() - 1
    direct = plan.direct
    bufs = _engine_bufs(L, nseq, S, L, direct)
    pats = {'twiddle table fill': [(np.arange(L), _all(L))]}
    if not direct:
        p, pos = e % P, swz(e >> lgP, sw)
        pats['gather store'] = [(bufs[0] + smem_index(q * P + p, pos, S),
                                 _all(e.size)) for q in range(planes)]
    passes, res = _stockham(L, nseq, S, bufs, True)
    pats['radix passes'] = []
    for i, ps in enumerate(passes):
        n = ps['src'][0].size
        if ps['R'] in (3, 5):
            # the R - 1 table twiddles, one load per thread per pass
            pats['radix passes'] += [
                (np.full(THREADS, t * ps['LR']), _all(THREADS))
                for t in range(1, ps['R'])]
        if bufs[i] is not None:
            pats['radix passes'] += [(s_, _all(n)) for s_ in ps['src']]
        pats['radix passes'] += [(t_, _all(n)) for t_ in ps['tw']]
        pats['radix passes'] += [(d, _all(n)) for d in ps['dst']]
    if stage == 1:
        k1, p = e % L, e // L
        pats['epilogue'] = [(res + smem_index(q * P + p, k1, S),
                             _all(e.size)) for q in range(planes)]
    else:
        k2hi = -(-N // plan.f1)
        nk = -(-k2hi // (1 << sw)) << sw
        e = np.arange(P * nk)
        p, k2 = e % P, swz(e >> lgP, sw)
        act = (k2 < k2hi) & (p + plan.f1 * k2 < N)
        pats['epilogue'] = [(res + smem_index(q * P + p, k2, S), act)
                            for q in range(read_planes)]
    return pats


def _parent_columns(L, other, itemsize, planes):
    """The parent's columns per block: the largest power of two <= 8
    dividing `other` whose L twiddles and two buffers of planes * P
    sequences at stride L fit 96 KB."""
    P = 8
    while P > 1 and (other % P or
                     L * (1 + 2 * planes * P) * itemsize > 96 * 1024):
        P //= 2
    return P


def _count(pats, itemsize):
    """{pattern: (wavefronts per block, worst ways of one instruction)}"""
    out = {}
    for name, insts in pats.items():
        w = [_wavefronts(a, m, itemsize) for a, m in insts]
        out[name] = (int(sum(x.sum() for x in w)),
                     int(max(x.max() for x in w)))
    return out


@functools.lru_cache(maxsize=None)
def _both(mode, dtype):
    """At the headline, per stage: the parent's counts at its plan, the
    engine's at the same columns per block and the engine's at its own
    plan, and
    the blocks of one row for each: {stage: (parent, engine at the
    parent's columns, engine)}, {stage: (parent blocks, engine blocks)}."""
    planes, reads = MODES[mode]
    itemsize = ITEMSIZE[dtype]
    plan = launch_plan(BENCH_NP2, itemsize, planes)
    f1, f2 = plan.f1, plan.f2
    P1 = _parent_columns(f1, f2, itemsize, planes)
    P2 = _parent_columns(f2, f1, itemsize, planes)
    same = plan._replace(P1=P1, P2=P2)
    got = {}
    for stage, L, P in ((1, f1, P1), (2, f2, P2)):
        old = _parent_patterns(L, P, stage, BENCH_N, f1, planes, reads)
        got[stage] = tuple(_count(pats, itemsize) for pats in (
            old, _engine_patterns(same, stage, BENCH_N, planes, reads),
            _engine_patterns(plan, stage, BENCH_N, planes, reads)))
    blocks = {1: (f2 // P1, f2 // plan.P1), 2: (f1 // P2, f1 // plan.P2)}
    return got, blocks


@pytest.mark.parametrize('odd', [1, 3, 5, 9, 15])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
@pytest.mark.parametrize('planes', [1, 2, 5])
def test_stft_plan_fits_and_divides(odd, dtype, planes):
    """The launch plan of every transform length 2^a * odd in [4, 2^22]:
    shared memory within the target (one column up to the card's limit),
    columns dividing the grid, strides odd, swizzles a bijection on
    [0, L); where no column fits, the plan raises."""
    itemsize = ITEMSIZE[dtype]
    for lg in range(23):
        n = odd << lg
        if not 4 <= n <= 1 << 22:
            continue
        f1, f2 = split_fft_len(n)
        if any((L * (1 + 2 * planes) + 2 * planes) * itemsize
               > stft_cuda._SMEM_MAX for L in (f1, f2)):
            with pytest.raises(NotImplementedError, match='shared memory'):
                launch_plan(n, itemsize, planes)
            continue
        plan = launch_plan(n, itemsize, planes)
        assert (plan.f1, plan.f2) == (f1, f2)
        for L, other, P, S, sw, sm in (
                (f1, f2, plan.P1, plan.S1, plan.sw1, plan.smem1),
                (f2, f1, plan.P2, plan.S2, plan.sw2, plan.smem2)):
            assert P >= 1 and P & (P - 1) == 0 and other % P == 0
            assert P <= stft_cuda._MAX_COLUMNS
            assert S == L | 1
            assert L % (1 << sw) == 0 and sw <= 4
            assert sm == (L + 2 * planes * P * S) * itemsize
            assert sm <= (stft_cuda._SMEM_TARGET if P > 1
                          else stft_cuda._SMEM_MAX)
            # the fewest columns giving 8 sequences and 32-byte runs,
            # unless `other` or the target forced fewer
            want = next(w for w in (1, 2, 4, 8) if w == 8 or (
                planes * w >= 8 and w * itemsize >= 32))
            assert P <= want
            if P < want:
                assert other % (2 * P) or (L + 4 * planes * P * S) \
                    * itemsize > stft_cuda._SMEM_TARGET


@pytest.mark.parametrize('Np2', [12, 48, 160, 240, 576, 2304, 12288, 163840])
@pytest.mark.parametrize('planes', [1, 2, 5])
def test_patterns_cover_each_element_once(Np2, planes):
    """Each gather store and each pass (its loads, from device memory in
    the first where there is no gather, and its stores) touches every
    element of every sequence exactly once (the swizzled walks are
    bijections on [0, L)), and the stage-2 epilogue visits each output
    column of its block once."""
    plan = launch_plan(Np2, 8, planes)
    N = Np2 * 5 // 8 + 1
    for stage in (1, 2):
        L, P, S = ((plan.f1, plan.P1, plan.S1) if stage == 1
                   else (plan.f2, plan.P2, plan.S2))
        nseq = planes * P
        want = np.sort(np.add.outer(np.arange(nseq) * S,
                                    np.arange(L)).ravel())
        bufs = _engine_bufs(L, nseq, S, L, plan.direct)
        if not plan.direct:
            got = _engine_patterns(plan, stage, N, planes, 1)['gather store']
            assert np.array_equal(np.sort(np.concatenate([a for a, _ in got])),
                                  want + bufs[0])
        passes, res = _stockham(L, nseq, S, bufs, True)
        for i, ps in enumerate(passes):
            assert np.array_equal(np.sort(np.concatenate(ps['src'])),
                                  want + (bufs[i] or 0))
            assert np.array_equal(np.sort(np.concatenate(ps['dst'])),
                                  want + bufs[i + 1])
        if stage == 2:
            (a, act), = _engine_patterns(plan, stage, N, planes,
                                         1)['epilogue']
            p = np.arange(a.size) % P
            k2 = a - res - p * S
            assert ((k2 >= 0) & (k2 < L)).all()
            cols = (p + plan.f1 * k2)[act]
            assert np.array_equal(np.sort(cols),
                                  np.arange(N)[np.arange(N) % plan.f1 < P])


# (mode, dtype): columns per block (stage 1, stage 2) at the headline
# plan; then per pattern and stage the most wavefronts one instruction
# needs (parent, engine at the parent's columns, engine)
HEADLINE = {
    (0, 'float32'): (8, 8),
    (2, 'float32'): (4, 4),
    (3, 'float32'): (4, 2),
    (0, 'float64'): (8, 4),
    (2, 'float64'): (4, 2),
    (3, 'float64'): (2, 1),
}
WORST = {
    (0, 'float32'): {
        'twiddle table fill': {1: (1, 1, 1), 2: (1, 1, 1)},
        'gather store': {1: (8, None, None), 2: (8, None, None)},
        'radix passes': {1: (4, 2, 2), 2: (16, 2, 2)},
        'epilogue': {1: (1, 1, 1), 2: (8, 1, 1)},
    },
    (2, 'float32'): {
        'twiddle table fill': {1: (1, 1, 1), 2: (1, 1, 1)},
        'gather store': {1: (8, None, None), 2: (4, None, None)},
        'radix passes': {1: (4, 1, 2), 2: (16, 2, 2)},
        'epilogue': {1: (1, 1, 1), 2: (4, 1, 1)},
    },
    (3, 'float32'): {
        'twiddle table fill': {1: (1, 1, 1), 2: (1, 1, 1)},
        'gather store': {1: (2, 1, 1), 2: (2, 1, 1)},
        'radix passes': {1: (4, 3, 2), 2: (16, 3, 3)},
        'epilogue': {1: (1, 1, 1), 2: (2, 1, 1)},
    },
    (0, 'float64'): {
        'twiddle table fill': {1: (1, 1, 1), 2: (1, 1, 1)},
        'gather store': {1: (8, None, None), 2: (4, None, None)},
        'radix passes': {1: (4, 1, 1), 2: (8, 2, 2)},
        'epilogue': {1: (1, 1, 1), 2: (4, 1, 1)},
    },
    (2, 'float64'): {
        'twiddle table fill': {1: (1, 1, 1), 2: (1, 1, 1)},
        'gather store': {1: (4, None, None), 2: (2, None, None)},
        'radix passes': {1: (4, 1, 1), 2: (8, 2, 2)},
        'epilogue': {1: (1, 1, 1), 2: (2, 1, 1)},
    },
    (3, 'float64'): {
        'twiddle table fill': {1: (1, 1, 1), 2: (1, 1, 1)},
        'gather store': {1: (1, 1, 1), 2: (1, 1, 1)},
        'radix passes': {1: (4, 3, 2), 2: (8, 3, 3)},
        'epilogue': {1: (1, 1, 1), 2: (1, 1, 1)},
    },
}
# wavefronts per block: {(mode, dtype): {stage: (parent, engine at the
# parent's columns, engine)}}
WAVEFRONTS = {
    (0, 'float32'): {1: (5036, 2972, 2972), 2: (11824, 6044, 6044)},
    (2, 'float32'): {1: (10052, 3620, 2972), 2: (9800, 6048, 6048)},
    (3, 'float32'): {1: (5090, 4394, 6984), 2: (10982, 8832, 8832)},
    (0, 'float64'): {1: (9752, 3704, 3704), 2: (8808, 5948, 5948)},
    (2, 'float64'): {1: (8472, 3704, 3704), 2: (7796, 5948, 5948)},
    (3, 'float64'): {1: (4710, 4464, 7368), 2: (9099, 8859, 8859)},
}


@pytest.mark.parametrize('mode,dtype', list(HEADLINE))
def test_headline_plan(mode, dtype):
    """The plan at the ssq_stft / ssq_stft2 headline: Np2 = 163840 =
    320 x 512, columns per block as pinned (the fastest of
    scripts/torch_stft_plan_sweep.py in float32), the first pass reading
    device memory with one or two planes and a gather first with five."""
    planes, _ = MODES[mode]
    plan = launch_plan(BENCH_NP2, ITEMSIZE[dtype], planes)
    assert (plan.f1, plan.f2, plan.direct) == (320, 512, planes < 5)
    assert (plan.P1, plan.P2) == HEADLINE[mode, dtype]


@pytest.mark.parametrize('planes', [1, 2, 5])
def test_direct_rule_matches_the_kernel(planes):
    """The plan's `direct`, which the patterns and the passes here
    model, is the kernel's compile-time `Direct<planes>`: both read their
    plane limit from one number, `_DIRECT_MAX_PLANES` in the wrapper and
    `kDirectMaxPlanes` in csrc/stft_conv.cu."""
    src = os.path.join(os.path.dirname(stft_cuda.__file__), os.pardir,
                       'csrc', 'stft_conv.cu')
    with open(src) as f:
        kernel, = re.findall(r'constexpr int kDirectMaxPlanes = (\d+);',
                             f.read())
    assert int(kernel) == stft_cuda._DIRECT_MAX_PLANES
    for Np2 in (12, 12288, BENCH_NP2):
        assert launch_plan(Np2, 8, planes).direct == (
            planes <= int(kernel))


@pytest.mark.parametrize('pattern', ['twiddle table fill', 'gather store',
                                     'radix passes', 'epilogue'])
@pytest.mark.parametrize('mode,dtype', list(HEADLINE))
def test_worst_ways_at_the_headline(mode, dtype, pattern):
    """The most wavefronts one instruction of each pattern needs, per
    stage, for the parent at its plan and for the engine at the same
    columns and at its own plan, at the headline (None: with one or two
    planes the engine has no gather store, its first pass reads device
    memory)."""
    got, _ = _both(mode, dtype)
    ways = {stage: tuple(c[pattern][1] if pattern in c else None
                         for c in got[stage]) for stage in (1, 2)}
    assert ways == WORST[mode, dtype][pattern], ways


@pytest.mark.parametrize('mode,dtype', list(HEADLINE))
def test_wavefronts_per_block_below_the_parent(mode, dtype):
    """Shared-memory wavefronts one block of each launch needs at the
    headline, loads and stores counted: the parent's at its plan, the
    engine's at the same columns per block and at its own plan, pinned;
    the engine's lower per block at the same columns, and per row (all
    blocks of a row) at its own plan, in both stages."""
    got, blocks = _both(mode, dtype)
    tot = {stage: tuple(sum(v[0] for v in c.values()) for c in got[stage])
           for stage in (1, 2)}
    assert tot == WAVEFRONTS[mode, dtype], tot
    for stage in (1, 2):
        old, same, new = tot[stage]
        assert same < old
        assert new * blocks[stage][1] < old * blocks[stage][0]


def _run_passes(x, S, direct):
    """The engine's passes on a shared-memory image: the first pass reads
    `x` (nseq, L) at its positions (direct: the kernel's loads from
    device memory) or from the gather's buffer, every butterfly of
    `_stockham` reads and writes through its own addresses (radix 2 and 4
    as the kernel computes them, radix 3 and 5 as sums over the table
    twiddles e^{2 pi i ((r k) mod R) / R}) after the L twiddles. Returns
    the sequences read back from the result buffer."""
    nseq, L = x.shape
    mem = np.zeros(L + 2 * nseq * S, complex)
    mem[:L] = np.exp(2j * np.pi * np.arange(L) / L)
    pos = smem_index(np.arange(nseq)[:, None], np.arange(L), S)
    bufs = _engine_bufs(L, nseq, S, L, direct)
    xmem = np.zeros(nseq * S, complex)
    xmem[pos] = x
    if not direct:
        mem[bufs[0] + pos] = x
    passes, res = _stockham(L, nseq, S, bufs, True)
    if not passes:                     # L = 1: the kernel copies x
        return x
    for i, ps in enumerate(passes):
        R, LR = ps['R'], ps['LR']
        src = xmem if bufs[i] is None else mem
        v = [src[ps['src'][0]]] + [src[s_] * mem[t_] for s_, t_ in
                                    zip(ps['src'][1:], ps['tw'])]
        for k in range(R):
            mem[ps['dst'][k]] = sum(v[r] * mem[((r * k) % R) * LR]
                                    for r in range(R))
    return mem[res + pos]


@pytest.mark.parametrize('L', [1, 2, 3, 4, 5, 6, 9, 15, 12, 20, 36, 60,
                               96, 120, 128, 144, 240, 320, 512, 7, 14, 49,
                               63, 210, 315, 400])
@pytest.mark.parametrize('nseq', [1, 8, 10, 16, 20])
@pytest.mark.parametrize('direct', [True, False])
def test_passes_compute_the_inverse_dft(L, nseq, direct):
    """The passes' index arithmetic (radices 4, 2, 3, 5, 7 in the kernel's
    order; the sequence fastest, over 1 to 20 sequences; the first pass
    reading device memory or the gather's buffer) is an unnormalized
    inverse DFT of every sequence, for the headline factors 320 and 512,
    the N = 10000 plan's 96 and 128, lengths with each odd factor 3, 5, 9
    and 15, and the factors of the CWT kernel's mixed path (7, 49, 63,
    210, 315, 400: radix 7 after 4, 2, 3 and 5)."""
    rng = np.random.default_rng(L * 100 + nseq)
    x = rng.standard_normal((nseq, L)) + 1j * rng.standard_normal((nseq, L))
    y = _run_passes(x, L | 1, direct)
    np.testing.assert_allclose(y, np.fft.ifft(x, axis=-1) * L,
                               rtol=0, atol=1e-10 * L)


@pytest.mark.parametrize('Np2', [12, 15, 60, 144, 240, 576, 2304, 12288])
def test_four_step_through_the_engine(Np2):
    """Both launches simulated block by block through the engine's own
    addresses (the products into the first pass, the passes, the stage-1
    twiddle into the scratch plane's layout, the scratch into the first
    pass, the epilogue walk): one row of table x spectrum comes out as
    ifft(H * xh)[:N]."""
    N = Np2 - 3
    rng = np.random.default_rng(Np2)
    prod = rng.standard_normal(Np2) + 1j * rng.standard_normal(Np2)
    np.testing.assert_allclose(_four_step(prod, N), np.fft.ifft(prod)[:N],
                               rtol=0, atol=1e-12 * np.abs(prod).max())


def _band_products(t, xh, r0, f1, f2):
    """Stage 1's products of one banded table row, through the kernel's
    addresses (`Products::band_row`, `operator()`, `all` in
    csrc/stft_conv.cu): position m1, column m2 reads the packed row at
    r f2 + m2, r = m1 - r0 (plus f1 where negative), and xh at m1 f2 + m2;
    zero where r >= br, reading neither. Returns the products at m."""
    br = len(t) // f2
    m1, m2 = np.arange(f1)[:, None], np.arange(f2)[None]
    r = m1 - r0
    r = np.where(r < 0, r + f1, r)
    inside = np.broadcast_to(r < br, (f1, f2))
    prod = np.zeros((f1, f2), complex)
    prod[inside] = (t[(r * f2 + m2)[inside]]
                    * xh[(m1 * f2 + m2)[inside]])
    return prod.ravel()


@pytest.mark.parametrize('Np2,br,r0', [(576, 8, 16), (2304, 16, 32),
                                       (12288, 24, 88), (12288, 24, 0),
                                       (4608, 16, 64), (163840, 40, 312),
                                       (2304, 36, 0)])
def test_banded_products_through_the_engine(Np2, br, r0):
    """A banded table row (br of f1 rows from r0, wrapping mod f1) read
    through the kernel's addresses, then both launches: ifft of the
    zero-filled full row times xh, as `BandedTable.expand` builds it; the
    band br = f1, r0 = 0 reads every address of the full row, so its
    products are the full table's bit for bit."""
    plan = launch_plan(Np2, 8, 1)
    f1, f2 = plan.f1, plan.f2
    assert r0 < f1 and br <= f1
    rng = np.random.default_rng(Np2 + br)
    t = rng.standard_normal(br * f2) + 1j * rng.standard_normal(br * f2)
    xh = rng.standard_normal(Np2) + 1j * rng.standard_normal(Np2)
    full = np.zeros((f1, f2), complex)
    full[(r0 + np.arange(br)) % f1] = t.reshape(br, f2)
    prod = _band_products(t, xh, r0, f1, f2)
    assert np.array_equal(prod, full.ravel() * xh)
    N = Np2 - 5
    np.testing.assert_allclose(_four_step(prod, N),
                               np.fft.ifft(full.ravel() * xh)[:N], rtol=0,
                               atol=1e-12 * np.abs(prod).max())
    H = rng.standard_normal(Np2) + 1j * rng.standard_normal(Np2)
    assert np.array_equal(_band_products(H, xh, 0, f1, f2), H * xh)


def _four_step(prod, N):
    """Both launches of one row of products (Np2,), block by block."""
    Np2 = len(prod)
    plan = launch_plan(Np2, 8, 1)
    f1, f2 = plan.f1, plan.f2
    scratch = np.zeros(Np2, complex)
    for blk in range(f2 // plan.P1):              # stage 1
        P, L, S = plan.P1, f1, plan.S1
        e = np.arange(P * L)
        p, m1 = np.arange(P)[:, None], np.arange(L)
        y = _run_passes(prod[m1 * f2 + blk * P + p], S, plan.direct)
        k1, p = e % L, e // L
        m2 = blk * P + p
        scratch[m2 * f1 + k1] = y[p, k1] * np.exp(
            2j * np.pi * m2 * k1 / Np2) / Np2
    out = np.full(N, np.nan, complex)
    for blk in range(f1 // plan.P2):              # stage 2
        P, L, S = plan.P2, f2, plan.S2
        p, m2 = np.arange(P)[:, None], np.arange(L)
        y = _run_passes(scratch[m2 * f1 + blk * P + p], S, plan.direct)
        k2hi = -(-N // f1)
        nk = -(-k2hi // (1 << plan.sw2)) << plan.sw2
        e = np.arange(P * nk)
        p, k2 = e % P, swz(e >> (P.bit_length() - 1), plan.sw2)
        n = blk * P + p + f1 * k2
        keep = (k2 < k2hi) & (n < N)
        assert np.isnan(out[n[keep]]).all()
        out[n[keep]] = y[p[keep], k2[keep]]
    return out
