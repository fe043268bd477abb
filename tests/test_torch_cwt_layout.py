# -*- coding: utf-8 -*-
"""The DFT engine of the CWT kernel (`csrc/cwt_bins.cu`: bins mode B1 and
B3b, Wx-only and derivative mode B3, order-2 mode B8) on the CPU: its
launch plan, its shared-memory access patterns and the index arithmetic
of its radix-4 passes, for each plane count (1: Wx only; 2: bins or Wx
and dWx; 5: order 2). No card and no kernel run here; the thread maps
below mirror the kernel's loops (`bins_stage1`, `bins_stage2`,
`block_fft4`) and use the wrapper's own `bins_plan`, `smem_index` and
`swz`.

Bank model: shared memory serves 128 bytes per wavefront, so a warp's
8-byte (complex64) accesses are served per half-warp of 16 threads and
16-byte (complex128) ones per quarter-warp of 8; element `a` of such a
group lies on bank group `a mod 16` (or `a mod 8`), and a group is free
of conflicts when no two threads read different elements of one bank
group.
"""
import numpy as np
import pytest

from ssqueezepy_tpu_torch.ops import cwt_cuda
from ssqueezepy_tpu_torch.ops.cwt_cuda import bins_plan, smem_index, swz
from ssqueezepy_tpu_torch.ops.pad import pad_params
from ssqueezepy_tpu_torch.ops.stft_cuda import radices

BENCH_N = 160000               # the main path's signal length
ITEMSIZE = {'float32': 8, 'float64': 16}
PLANES = [1, 2, 5]             # Wx only; bins or Wx + dWx; order 2


def _wavefronts(addr, active, itemsize):
    """Wavefronts each thread group needs for one instruction: `addr`
    holds one element index per thread id e (e = tid + 256 * iteration,
    256 threads per block, so aligned runs of the group size share a
    wavefront), `active` masks the threads that access."""
    g = 128 // itemsize
    n = -(-len(addr) // g) * g
    a = np.full(n, -1, np.int64)
    a[:len(addr)] = np.where(active, addr, -1)
    return np.array([np.bincount(grp[grp >= 0] % g).max()
                     if (grp >= 0).any() else 0
                     for grp in map(np.unique, a.reshape(-1, g))])


def _passes(L, P, S, s0, planes):
    """`block_fft4`'s passes from level s0 over the planes * P sequences
    of length L: per pass, (the data addresses, one array per element a
    butterfly touches, each loaded and then stored; the twiddle
    addresses), one entry per butterfly b -> sequence b mod (planes * P),
    index b // (planes * P)."""
    lg, nseq, tw0 = L.bit_length() - 1, planes * P, L // 2
    b = np.arange(nseq * L // 4)
    q, j = b % nseq, b // nseq
    s, out = s0, []
    while s < lg:                              # radix 4: levels s, s + 1
        hl = 1 << (s - 1)
        pos = j & (hl - 1)
        base = tw0 + smem_index(q, ((j >> (s - 1)) << (s + 1)) + pos, S)
        out.append(([base + m * hl for m in range(4)],
                    [pos * (L >> s), pos * (L >> (s + 1)),
                     (pos + hl) * (L >> (s + 1))]))
        s += 2
    if s == lg:                                # odd lg: radix 2, level lg
        b = np.arange(nseq * L // 2)
        q, j = b % nseq, b // nseq
        base = tw0 + smem_index(q, j, S)
        out.append(([base, base + L // 2], [j]))
    return out


def _stage_patterns(plan, stage, n1, N, planes):
    """{pattern: [(addresses, active), ...]} of one launch, one entry per
    load or store instruction; addresses count elements from the start of
    dynamic shared memory (the twiddle table, then the sequences)."""
    L = plan.f1 if stage == 1 else plan.f2
    P, S, sw = ((plan.P1, plan.S1, plan.sw1) if stage == 1
                else (plan.P2, plan.S2, plan.sw2))
    tw0 = L // 2
    pats = {}
    e = np.arange(P * L)
    ones = np.ones(e.size, bool)
    pats['twiddle table fill'] = [(np.arange(L // 2), np.ones(L // 2, bool))]
    # into bit-reversed positions: stage 1 the spectra by position pairs
    # (2u, 2u + 1) after the first level, stage 2 the scratch
    if stage == 1:
        u = np.arange(P * L // 2)
        i = 2 * swz(u // P, sw - 1)
        pats['bit-reversed store'] = [
            (tw0 + smem_index(q * P + u % P, i + d, S),
             np.ones(u.size, bool)) for q in range(planes) for d in (0, 1)]
    else:
        pats['bit-reversed store'] = [
            (tw0 + smem_index(q * P + e % P, swz(e // P, sw), S), ones)
            for q in range(planes)]
    # every load, twiddle read and store of the passes
    pats['radix passes'] = [(a, np.ones(a.size, bool))
                            for data, tws in _passes(L, P, S, 3 - stage,
                                                     planes)
                            for a in data + tws + data]
    if stage == 1:
        k1, p = e % L, e // L
        pats['twiddle epilogue'] = [
            (tw0 + smem_index(qq * P + p, k1, S), ones)
            for qq in range(planes)]
    else:
        # the mode's epilogue reads every plane at k2 (Wx; Wx and dW for
        # the bins or the dWx output; the five order-2 planes)
        k2lo, k2hi = n1 // plan.f1, -(-(n1 + N) // plan.f1)
        nk = -(-(k2hi - k2lo) // (1 << sw)) << sw
        e = np.arange(P * nk)
        p, k2 = e % P, k2lo + swz(e // P, sw)
        jj = (e % P) + plan.f1 * k2 - n1      # block k1_0 = 0
        act = (k2 < k2hi) & (jj >= 0) & (jj < N)
        pats['phase/bin epilogue'] = [
            (tw0 + smem_index(qq * P + p, k2, S), act)
            for qq in range(planes)]
    return pats


@pytest.mark.parametrize('lg', range(2, 30))
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
@pytest.mark.parametrize('planes', PLANES)
def test_bins_plan_fits_and_divides(lg, dtype, planes):
    """The launch plan of every power-of-two n_up from 4 to 2^29: shared
    memory within budget (one column up to the card's limit), columns
    dividing the grid, strides odd; where not even one column fits, the
    plan raises naming C1b."""
    n_up, itemsize = 1 << lg, ITEMSIZE[dtype]
    f1, _ = cwt_cuda.four_step(n_up)
    if (f1 // 2 + planes * (f1 + 1)) * itemsize > cwt_cuda._SMEM_MAX:
        # not even one column fits (order 2 in float64 from n_up = 2^23)
        with pytest.raises(NotImplementedError,
                           match="shared memory.*queue C, C1b"):
            bins_plan(n_up, itemsize, planes)
        return
    plan = bins_plan(n_up, itemsize, planes)
    assert plan.f1 * plan.f2 == n_up
    for L, other, P, S, sw, sm in (
            (plan.f1, plan.f2, plan.P1, plan.S1, plan.sw1, plan.smem1),
            (plan.f2, plan.f1, plan.P2, plan.S2, plan.sw2, plan.smem2)):
        assert P >= 1 and P & (P - 1) == 0 and other % P == 0
        assert S >= L and S % 2 == 1
        assert 1 <= sw <= L.bit_length() - 1
        assert sm == (L // 2 + planes * P * S) * itemsize
        assert sm <= cwt_cuda._SMEM_BUDGET or (
            P == 1 and sm <= cwt_cuda._SMEM_MAX)
        # a wider block would no longer fit, unless P is already at its
        # cap or `other`
        if P < min(cwt_cuda._MAX_COLUMNS, other):
            assert (L // 2 + 2 * planes * P * S) * itemsize \
                > cwt_cuda._SMEM_BUDGET


@pytest.mark.parametrize('lg', [2, 3, 5, 11, 18, 22])
@pytest.mark.parametrize('planes', PLANES)
def test_bins_patterns_cover_each_element_once(lg, planes):
    """Each store pattern and each radix pass touches every element of
    every sequence exactly once (the swizzled walks are bijections), and
    the stage-2 epilogue visits each output column of its block once."""
    n_up, N = 1 << lg, (1 << lg) * 5 // 8 + 1
    _, n1, _ = pad_params(N, 'reflect', padlength=n_up)
    plan = bins_plan(n_up, 8, planes)
    for stage in (1, 2):
        L = plan.f1 if stage == 1 else plan.f2
        P, S = (plan.P1, plan.S1) if stage == 1 else (plan.P2, plan.S2)
        want = np.sort(np.add.outer(np.arange(planes * P) * S,
                                    np.arange(L)).ravel() + L // 2)
        pats = _stage_patterns(plan, stage, n1, N, planes)
        got = np.sort(np.concatenate([a for a, _ in
                                      pats['bit-reversed store']]))
        assert np.array_equal(got, want)
        for data, _ in _passes(L, P, S, 3 - stage, planes):
            assert np.array_equal(np.sort(np.concatenate(data)), want)
        if stage == 2:
            a, act = pats['phase/bin epilogue'][0]
            k2 = a[act] - L // 2 - (np.arange(a.size) % P)[act] * S
            cols = (np.arange(a.size) % P)[act] + plan.f1 * k2 - n1
            assert np.array_equal(np.sort(cols),
                                  np.arange(N)[(np.arange(N) + n1)
                                               % plan.f1 < P])


# (planes, dtype): columns per block at the main path's plan, and the
# patterns that are not conflict-free with their most wavefronts per
# thread group: the passes walk planes * P sequences, so fewer than a
# group's 16 (float32) or 8 (float64) threads, or 20, put two indices j in
# one group
MAIN_PLAN = {
    (1, 'float32'): (8, {'radix passes': 2}),
    (2, 'float32'): (8, {}),
    (5, 'float32'): (4, {'radix passes': 2}),
    (1, 'float64'): (8, {}),
    (2, 'float64'): (4, {}),
    (5, 'float64'): (2, {'radix passes': 2}),
}


@pytest.mark.parametrize('pattern', ['twiddle table fill',
                                     'bit-reversed store', 'radix passes',
                                     'twiddle epilogue',
                                     'phase/bin epilogue'])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
@pytest.mark.parametrize('planes', PLANES)
def test_bins_engine_free_of_bank_conflicts(pattern, dtype, planes):
    """At the main path's plan (n_up = 2^18, f1 = f2 = 512) every shared-
    memory access of both launches is served in one wavefront per
    half-warp (float32) or quarter-warp (float64), except the passes
    where the plan walks 8 (one plane, float32: 8 columns time best) or
    10 and 20 sequences (order 2): 2-way at most there."""
    n_up, n1, _ = pad_params(BENCH_N, 'reflect')
    itemsize = ITEMSIZE[dtype]
    plan = bins_plan(n_up, itemsize, planes)
    assert (plan.f1, plan.f2) == (512, 512)
    P, ways = MAIN_PLAN[planes, dtype]
    assert (plan.P1, plan.P2) == (P, P)
    worst = {}
    for stage in (1, 2):
        for addr, act in _stage_patterns(plan, stage, n1, BENCH_N,
                                         planes).get(pattern, []):
            worst[stage] = max(worst.get(stage, 0),
                               _wavefronts(addr, act, itemsize).max())
    assert worst and set(worst.values()) == {ways.get(pattern, 1)}, worst


def _radix2_engine_patterns(L, P, stage, n1, N, planes):
    """The radix-2 engine the kernel ran before this one (stage1 / stage2
    / block_fft; removed from `csrc/cwt_bins.cu`, kept here as the model
    that the counts below compare with): sequence s = plane * P + p at
    buf[s * L + i], the column p fastest with m1 (m2) next in the
    bit-reversed store, and radix-2 passes with butterfly b -> sequence
    b >> (lg - 1), r = b mod L/2."""
    lg, tw0 = L.bit_length() - 1, L // 2
    e = np.arange(P * L)
    ones = np.ones(e.size, bool)
    pats = [(np.arange(L // 2), np.ones(L // 2, bool))]       # twiddles
    pats += [(tw0 + (q * P + e % P) * L + swz(e // P, lg), ones)
             for q in range(planes)]
    b = np.arange(planes * P * L // 2)
    q, r = b >> (lg - 1), b & (L // 2 - 1)
    for s in range(1, lg + 1):
        hl = 1 << (s - 1)
        pos = r & (hl - 1)
        i0 = tw0 + q * L + ((r >> (s - 1)) << s) + pos
        act = np.ones(b.size, bool)
        pats += [(i0, act), (i0 + hl, act)] * 2 + [(pos * (L >> s), act)]
    if stage == 1:
        pats += [(tw0 + (q * P + e // L) * L + e % L, ones)
                 for q in range(planes)]
    else:
        k2lo, k2hi = n1 // L, -(-(n1 + N) // L)
        e = np.arange(P * (k2hi - k2lo))
        k2, j = k2lo + e // P, e % P + L * (k2lo + e // P) - n1
        pats += [(tw0 + (q * P + e % P) * L + k2, (j >= 0) & (j < N))
                 for q in range(planes)]
    return pats


# wavefronts per block at the main path's plan (float32, f1 = f2 = 512):
# {stage: (radix-2 engine, this engine, this engine's passes alone)}; both
# engines run P = 8 columns for 1 and 2 planes and 4 for 5
WAVEFRONTS = {
    1: {1: (16912, 5776, 5248), 2: (17912, 6704, 6272)},
    2: {1: (33808, 6672, 5632), 2: (35808, 7760, 6912)},
    5: {1: (42256, 11984, 10688), 2: (43196, 13152, 12096)},
}


@pytest.mark.parametrize('planes', PLANES)
def test_wavefronts_per_block_against_the_radix2_engine(planes):
    """Shared-memory wavefronts one block of each launch needs at the main
    path's plan (float32, f1 = f2 = 512), loads and stores counted: the
    radix-2 engine's conflicts (16-way bit-reversed stores, 2-way data at
    levels 1-4, up to 16-way twiddle reads at level 5) against this
    engine's; with one plane its passes walk 8 sequences and with 5
    planes 20, 2-way where a half-warp straddles two indices j."""
    n_up, n1, _ = pad_params(BENCH_N, 'reflect')
    plan = bins_plan(n_up, 8, planes)
    got = {}
    for stage in (1, 2):
        old = _radix2_engine_patterns(512, plan.P1, stage, n1, BENCH_N,
                                      planes)
        pats = _stage_patterns(plan, stage, n1, BENCH_N, planes)
        new = [am for pat in pats.values() for am in pat]
        got[stage] = tuple(sum(_wavefronts(a, m, 8).sum() for a, m in pl)
                           for pl in (old, new, pats['radix passes']))
    assert got == WAVEFRONTS[planes]


def _run_passes(x, P, planes, s0):
    """The engine's passes on a shared-memory image: `x` (planes * P, L)
    is stored bit-reversed at smem_index(s, i, L + 1) after the L/2
    twiddles; level 1 runs first in pairs (2u, 2u + 1) when s0 = 2, as
    `bins_stage1` does; then every butterfly of `_passes` reads and
    writes through its own addresses. Returns the sequences read back."""
    nseq, L = x.shape
    lg, S, tw0 = L.bit_length() - 1, L + 1, L // 2
    mem = np.zeros(tw0 + nseq * S, complex)
    mem[:tw0] = np.exp(2j * np.pi * np.arange(tw0) / L)
    at = tw0 + smem_index(np.arange(nseq)[:, None], np.arange(L), S)
    mem[at] = x[:, swz(np.arange(L), lg)]
    if s0 == 2:
        a0, a1 = at[:, 0::2], at[:, 1::2]
        mem[a0], mem[a1] = mem[a0] + mem[a1], mem[a0] - mem[a1]
    for data, tws in _passes(L, P, S, s0, planes):
        v, w = [mem[a] for a in data], [mem[t] for t in tws]
        if len(v) == 4:
            v[0], v[1] = v[0] + w[0] * v[1], v[0] - w[0] * v[1]
            v[2], v[3] = v[2] + w[0] * v[3], v[2] - w[0] * v[3]
            v[0], v[2] = v[0] + w[1] * v[2], v[0] - w[1] * v[2]
            v[1], v[3] = v[1] + w[2] * v[3], v[1] - w[2] * v[3]
        else:
            v[0], v[1] = v[0] + w[0] * v[1], v[0] - w[0] * v[1]
        for a, y in zip(data, v):
            mem[a] = y
    return mem[at]


@pytest.mark.parametrize('lg', range(1, 12))
@pytest.mark.parametrize('s0', [1, 2])
@pytest.mark.parametrize('planes', PLANES)
def test_radix4_passes_compute_the_inverse_dft(lg, s0, planes):
    """The passes' index arithmetic, with its sequence map over planes * 4
    sequences (20 for order 2: not a power of two), from level 1 (stage
    2) or after the first level in registers (stage 1), is an
    unnormalized inverse DFT of every sequence for every length 2^1 ..
    2^11, odd log2 L included (the last radix-2 pass)."""
    L, P = 1 << lg, 4
    rng = np.random.default_rng(lg)
    x = (rng.standard_normal((planes * P, L))
         + 1j * rng.standard_normal((planes * P, L)))
    y = _run_passes(x, P, planes, s0)
    np.testing.assert_allclose(y, np.fft.ifft(x, axis=-1) * L,
                               rtol=0, atol=1e-10 * L)


# ---- the mixed engine (n_up 7-smooth, not a power of two) ---------------

def _smooth7(hi):
    """Every n in [4, hi] whose prime factors are at most 7, powers of two
    excepted (those take the radix-4 engine)."""
    out = {1}
    for p in (2, 3, 5, 7):
        grow = set(out)
        for n in out:
            while n * p <= hi:
                n *= p
                grow.add(n)
        out = grow
    return sorted(n for n in out if n >= 4 and n & (n - 1))


def _divisors(n):
    """Every divisor of a 7-smooth n, from its exponents."""
    out = [1]
    for p in (2, 3, 5, 7):
        e = 0
        while n % p ** (e + 1) == 0:
            e += 1
        out = [d * p ** k for d in out for k in range(e + 1)]
    return out


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
@pytest.mark.parametrize('planes', PLANES)
def test_mixed_plan_fits_and_divides(dtype, planes):
    """The launch plan of every 7-smooth n_up in [4, 2^22] that is not a
    power of two: the split whose larger factor is smallest (f1 the least
    divisor >= sqrt(n_up)); per stage P a power of two <= 8 that covers at
    most the next power of two of the partner factor (the kernel guards
    the last block's columns, so P need not divide it), the stride odd,
    the swizzle a bijection on [0, L), two buffers and L twiddles within
    the budget, or one column within the card's limit; where not even one
    column fits, the plan raises."""
    itemsize = ITEMSIZE[dtype]
    lens = _smooth7(1 << 22)
    assert len(lens) > 1000 and 160000 in lens and 99225 in lens
    for n_up in lens:
        f1, f2 = cwt_cuda.four_step(n_up)
        assert f1 * f2 == n_up and f1 >= f2
        assert f1 == min(d for d in _divisors(n_up) if d * d >= n_up)
        if (f1 + 2 * planes * (f1 | 1)) * itemsize > cwt_cuda._SMEM_MAX:
            with pytest.raises(NotImplementedError, match='shared memory'):
                bins_plan(n_up, itemsize, planes)
            continue
        plan = bins_plan(n_up, itemsize, planes)
        assert plan.engine == cwt_cuda._ENGINE_MIXED
        for L, other, P, S, sw, sm in (
                (plan.f1, plan.f2, plan.P1, plan.S1, plan.sw1, plan.smem1),
                (plan.f2, plan.f1, plan.P2, plan.S2, plan.sw2, plan.smem2)):
            assert P & (P - 1) == 0 and 1 <= P <= cwt_cuda._MAX_COLUMNS
            assert P == 1 or P < 2 * other
            assert S in (L, L + 1) and S % 2 == 1
            assert L % (1 << sw) == 0 and (1 << sw) <= 128 // itemsize
            assert sm == (L + 2 * planes * P * S) * itemsize
            assert sm <= cwt_cuda._SMEM_BUDGET or (
                P == 1 and sm <= cwt_cuda._SMEM_MAX)


def test_length_rule():
    """`four_step` is the kernel's one length rule: n_up >= 4 with no
    prime factor above 7 (`kernel_length`), every other length raises
    naming the general path that the public calls take for it."""
    for n_up in (4, 5, 6, 7, 49, 3 * 1024, 160000, 99225, 1 << 22):
        f1, f2 = cwt_cuda.four_step(n_up)
        assert f1 * f2 == n_up
    for n_up in (1, 2, 3, 11, 11 * 1024, 13 * 49, 2002, 160000 * 11):
        assert not cwt_cuda.kernel_length(n_up)
        with pytest.raises(NotImplementedError, match='general path'):
            cwt_cuda.four_step(n_up)


def _mixed_transform(mem, a, b, nseq, S, L):
    """`dft::transform` over `nseq` sequences of length L on a shared-
    memory image whose first L elements are the twiddles: the first pass
    reads buffer `b` (the gather's), the passes ping-pong between a and b
    (radices of `radices`, butterfly e -> sequence e mod nseq, index e div
    nseq; every radix as a sum over the table twiddles, which is the
    kernel's radix-4 and radix-2 arithmetic in exact arithmetic); returns
    the base of the buffer holding the result."""
    if L == 1:
        q = np.arange(nseq)
        mem[a + q * S] = mem[b + q * S]
        return a
    src, dst = b, a
    for R, Ns in radices(L):
        LR, tstep = L // R, L // (Ns * R)
        e = np.arange(nseq * LR)
        q, j = e % nseq, e // nseq
        jm = j % Ns
        v = [mem[src + q * S + j + r * LR] * mem[r * jm * tstep]
             for r in range(R)]
        d = dst + q * S + (j - jm) * R + jm
        for k in range(R):
            mem[d + k * Ns] = sum(v[r] * mem[((r * k) % R) * LR]
                                  for r in range(R))
        src, dst = dst, src
    return src


@pytest.mark.parametrize('n_up', [160000, 99225, 44100, 4725, 30])
@pytest.mark.parametrize('planes', PLANES)
def test_mixed_four_step_through_the_engine(n_up, planes):
    """Both launches of the mixed engine simulated block by block through
    its own index maps (`bins_stage1`/`bins_stage2` with ENG_MIXED): the
    gather of every plane's spectrum column m1 = swz(.) of the block's
    columns (zero beyond the last), the Stockham passes, the four-step
    twiddle into the scratch layout (columns beyond the last not written),
    the scratch gather, the passes, and the epilogue's k2 walk over
    [n1, n1 + N): each plane comes out as np.fft.ifft of its half
    spectrum, every output column written once."""
    plan = bins_plan(n_up, 8, planes)
    f1, f2 = plan.f1, plan.f2
    half = n_up // 2 + 1
    n1, N = n_up // 7, n_up - n_up // 7 - 3
    rng = np.random.default_rng(n_up + planes)
    spec = np.zeros((planes, n_up), complex)
    spec[:, :half] = (rng.standard_normal((planes, half))
                      + 1j * rng.standard_normal((planes, half)))
    scratch = np.full((planes, n_up), np.nan, complex)
    for stage, L, other, P, S, sw in (
            (1, f1, f2, plan.P1, plan.S1, plan.sw1),
            (2, f2, f1, plan.P2, plan.S2, plan.sw2)):
        nseq = planes * P
        lgP = P.bit_length() - 1
        out = np.full((planes, N), np.nan, complex)
        for blk in range(-(-other // P)):
            c0 = blk * P
            mem = np.zeros(L + 2 * nseq * S, complex)
            mem[:L] = np.exp(2j * np.pi * np.arange(L) / L)
            bufa, bufb = L, L + nseq * S
            e = np.arange(P * L)
            p, i = e & (P - 1), swz(e >> lgP, sw)
            col = c0 + p
            inside = col < other
            for q in range(planes):
                if stage == 1:        # spectra at m = m1 f2 + m2
                    v = spec[q, np.minimum(i * f2 + col, n_up - 1)]
                else:                 # scratch at (m2, k1)
                    v = scratch[q, np.minimum(i * f1 + col, n_up - 1)]
                mem[bufb + (q * P + p) * S + i] = np.where(inside, v, 0)
            res = _mixed_transform(mem, bufa, bufb, nseq, S, L)
            if stage == 1:
                k1, p = e % L, e // L
                m2 = c0 + p
                keep = m2 < f2
                for q in range(planes):
                    y = mem[res + (q * P + p) * S + k1] * np.exp(
                        2j * np.pi * m2 * k1 / n_up) / n_up
                    assert np.isnan(scratch[q, (m2 * f1 + k1)[keep]]).all()
                    scratch[q, (m2 * f1 + k1)[keep]] = y[keep]
            else:
                k2lo, k2hi = n1 // f1, -(-(n1 + N) // f1)
                nk = -(-(k2hi - k2lo) >> sw) << sw
                e = np.arange(P * nk)
                p, k2 = e & (P - 1), k2lo + swz(e >> lgP, sw)
                j = c0 + p + f1 * k2 - n1
                keep = ((k2 < k2hi) & (j >= 0) & (j < N)
                        & (c0 + p < f1))
                for q in range(planes):
                    assert np.isnan(out[q, j[keep]]).all()
                    out[q, j[keep]] = mem[res + (q * P + p[keep]) * S
                                          + k2[keep]]
        if stage == 1:
            assert not np.isnan(scratch).any()
    want = np.fft.ifft(spec, axis=-1)[:, n1:n1 + N]
    np.testing.assert_allclose(out, want, rtol=0,
                               atol=1e-12 * np.abs(spec).max())
