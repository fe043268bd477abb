#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Smoke run of the PyTorch port (`ssqueezepy_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths at the bench shapes (N = 160000, white
noise from a seed, float32): `ssq_cwt` with the bench's 293-row
log-piecewise plan and `issq_cwt` back; `ssq_stft` and `stft` (hop 1)
with n_fft = 598 and `issq_stft`/`istft` back; `cwt` with the same 293
scales and `icwt` back; the second-order `ssq_cwt2` (the 293 scales, no
ssq_freqs, as the bench calls it) and `ssq_stft2` (n_fft = 598), inverted
by `issq_cwt`/`issq_stft`; `ssq_cwt` on a (4, 160000) batch (the bench's
`ssq_cwt_b4` call) and with `get_dWx=True`, and `ssq_stft` at hop 8;
`stft`, `ssq_stft` (hop 1, hop 8, hop 8 'abs'), `ssq_stft2` and
`ssq_cwt2` on the same (4, 160000) batch; the unpadded calls
(`padtype=None`, n_up = N = 160000 = 400 x 400, the CWT kernel's mixed
engine) `ssq_cwt`, `cwt`, `ssq_cwt2` and the (4, 160000) `ssq_cwt`,
`cwt(rpadded=True)` (the whole padded window) and `ssq_cwt(difftype=
'numeric', get_w=True)`; `ssq_cwt2(get_w=True)` (padded and unpadded)
and `ssq_stft2(get_w=True)` (one signal and the (4, 160000) batch), which
return the chirp-corrected frequency w2;
and every squeezing option on those routes: `ssq_cwt(get_w=True)` and
`ssq_cwt(get_dWx=True, squeezing='lebesgue')` (the derivative CWT, the
phase transform, the generic scatter), `ssq_stft(hop_len=8,
squeezing='abs')`, `ssqueeze` from a precomputed w, and 'lebesgue' /
'abs' `ssq_stft`, `ssq_cwt2` and `ssq_stft2` (their kernels' bins, then
the scatter from bins); the streaming plans chunk by chunk (section 12c);
the sharded plans over ranks (section 12e); `padtype=None` at lengths
with a prime factor above 7 (section 10b); and the analysis layer,
`extract_ridges` on a two-chirp `TestSignals` signal and
`experimental.phase_ssqueeze` (section 12f). It:

  1. prints the card's name and power limit (nvidia-smi);
  2. builds every CUDA kernel from `ssqueezepy_tpu_torch/csrc/` (one nvcc
     per source, in parallel, with `-Xptxas -v`), prints the build time and
     the compiler's report (registers, spills) of every instantiation of
     the CWT kernel's DFT engine (`bins_stage1` per plane count,
     `bins_stage2` per output mode), of the STFT kernel's
     (`stft_stage1` per plane count, `stft_stage2` per mode) and of the
     reassignment kernels (`scatter_kv_kernel`, `shift_scatter_kernel`
     per mask/const mode, `ssq_fused_kernel` without and with Sfs), float
     and double, and their launch plans at the headline (columns, stages
     and shared memory per block, the blocks per SM the runtime grants
     it, the bytes of copies in flight per SM);
  3. holds the fused CWT + bins kernel (B1) against its plain PyTorch
     version at the headline shape, float32 and float64, checks two runs
     are bit-identical and that the Wx of the plain/derivative mode (B3),
     with one plane and with two, is bit-identical to B1's;
  4. holds the reassignment scatter (B2) against its plain version on the
     same planes, and checks two runs are bit-identical;
  5. holds the STFT table kernel (B6) in its three modes (Sx; Sx + dSx;
     Sx + bins) against its plain version at the ssq_stft headline
     (Np2 = 163840 = 5 x 2^15) and at N = 10000 (Np2 = 12288 = 3 x 2^12),
     float32 and float64, checks that its Sx is bit-identical across the
     three modes and, at the headline in float32, that each mode repeats
     bit for bit;
  6. holds the plain/derivative CWT kernel (B3) against its plain version
     at cwt@160k (with and without dWx) and on a (16, 10000) batch,
     float32 and float64;
  7. holds the WSST2 kernel (B8, the order-2 mode of the CWT kernel) and
     the FSST2 table kernel (B7) against their plain versions at the
     ssq_cwt2 / ssq_stft2 headline (float32) and at N = 10000 (float64),
     and checks that B8's W is bit-identical to B1's Wx at the headline
     (L1 norm, the same spectrum and scales), that B7's V is bit-identical
     to B6's Sx (Sx mode) with the bank's first table as H, and that B7
     repeats bit for bit;
  8. holds the batched bins mode of the CWT kernel (B3b) against its plain
     version on a (4, 160000) float32 and a (3, 10000) float64 batch, each
     row bit-identical to B1 on its signal; the batched scatter (B2) on
     those planes, bit-identical to per-signal launches and from run to
     run; and the fused phase + bins + scatter kernel (B4) on the
     derivative CWT planes at 160k, on the STFT's (Sx, dSx) planes at 160k
     with Sfs, on the hop-8 STFT's planes with Sfs (as `ssq_stft(hop_len=
     8)` runs it), and at N = 10000 in float64 over the lin, log and
     log-piecewise grids with both flipud;
  9. holds the generic scatter (B5) against its plain version on the
     headline planes with planted wrapped (k < 0), dropped (k < -nbins,
     k >= nbins) and invalid cells, and at N = 10000 in float64, and
     checks two runs are bit-identical;
 9b. holds the STFT table kernel over a batch of spectra (B6 in its three
     modes, B7) and the WSST2 kernel over a batch (B8) against their
     plain versions on a (4, 160000) float32 and a (3, 10000) float64
     batch, each row bit-identical to its spectrum launched alone, each
     launch on the batched counter only;
 9c. holds the CWT kernel's mixed engine (n_up 7-smooth, not a power of
     two) in every mode (B1; B3 with one plane and with two; B8; B3b on a
     batch of two) against its plain versions at n_up = 160000 (float32,
     the bench's 293 scales) and 99225 = 315 x 315 (float64, odd), each
     launch on the mixed counters only, Wx bit-identical across the
     modes, two runs bit-identical, the batched row bit-identical to its
     one-signal launch;
 9d. holds the w2 modes of B8 (`cwt_w2`, both engines: n_up = 262144 and
     160000, the 293 scales) and B7 (`fsst2_w`, the ssq_stft2 headline,
     one signal and the (4, 160000) batch) against their plain versions
     (`wsst2_rows`, `fsst2_rows`), float32: W/V within 2e-5 of max, the
     same inf cells of w2 but on at most 0.1% of cells, Tx of B5 on the
     bins of w2 by the bins criterion; W/V bit-identical to the bins
     modes' launch and the bins of w2 equal to its k (the count of cells
     that differ is printed; the criterion is none); batched rows
     bit-identical to their one-signal launches;
 10. runs each public entry point (`ssq_cwt`, `ssq_stft`, `stft`, `cwt`,
     `ssq_cwt2`, `ssq_stft2`, the batched `ssq_cwt`, `ssq_cwt(get_dWx=
     True)`, `ssq_stft(hop_len=8)`, `ssqueeze` from (Wx, dWx), the
     squeezing calls above at 160k and the batched STFT-family and
     `ssq_cwt2` calls, which must launch the batched counters and no
     one-signal counter of B6, B7 or B8)
     with every launch counter set to 0 just before, reads the counters
     just after (each kernel of the path must have launched; the `get_w`
     call must launch neither bins kernel), and checks the outputs against
     the plain path on the card;
 10b. (`prime_length_section`) runs `ssq_cwt` (and with `get_w`, with
     `get_dWx`), `cwt`, `ssq_cwt2` (and with `get_w`) with
     `padtype=None` at N = 2002 = 2 7 11 13 (and `ssq_cwt` on a (4, 2002)
     batch) and at N = 160001 (a prime), each with the counters zeroed
     just before: the general route (`cwt_general`, or `wsst2_general` for
     order 2) once and then exactly B4 or B5, no CWT kernel; at 2002
     against the same call on the CPU (Wx within 1e-5 of max, Tx by the
     bins criterion), at 160001 by a chirp's round trip (`issq_cwt`,
     `icwt`; mad_rms < 0.1), each timed beside the same call padded at
     N = 160000 (the kernel route); then checks that each kernel
     wrapper called just past its rule (the CWT kernel's for two and five
     planes in float64, the STFT kernel's past 2^22 and for five planes
     in float64, the scatters' 25600 bins) raises the same error naming
     ROADMAP.md queue C, C1b on the card and on the CPU, launching
     nothing (the public calls take their general routes there, 12i);
     runs the radix-4 engine at its
     largest lengths through the public calls: `cwt(padtype=None)` at
     n_up = 2^28 (three scales, one plane) and `ssq_cwt2(padtype=None)`
     at n_up = 2^24 (eight scales, five planes), against the plain path
     on the card;
 11. round-trips a chirp through `ssq_cwt`/`issq_cwt`,
     `ssq_cwt(padtype=None)`/`issq_cwt` (N = 19600 = 2^4 5^2 7^2),
     `ssq_stft`/`issq_stft`, `cwt`/`icwt`, `ssq_cwt2`/`issq_cwt` and
     `ssq_stft2`/`issq_stft` and `ssq_cwt(get_w=True)`/`issq_cwt`, and a
     (4, N) chirp batch through the batched
     `ssq_cwt`/`issq_cwt` (mad_rms < 0.1, each row), and white noise
     through `stft`/`istft` in float64 at hop 1 and hop 8, one signal and
     a (4, 160000) batch (MAE < 1e-12);
 12. times each kernel, its plain version and a library yardstick with
     CUDA events after warm-up (B2 also on the (4, 160000) batch, B4 also
     on the hop-8 STFT's planes, B6 (bins and Sx modes), B7 and B8 also
     on the (4, 160000) batch, the CWT kernel's mixed engine in each mode
     at n_up = 160000, the w2 modes of B8 on both engines and of B7 on one
     signal and the batch), computes each kernel's bound from this
     run's shapes (and, for B2, B4 and B5, the bytes/s achieved and the
     share of the bound), and times each public call with its peak
     memory;
 12b. (`wavelet_section`) the other wavelets: holds every table mode of
     the CWT kernel (B1 with cmhat, B3 with hhhat and with an order-1 GMW
     and two planes, B8 with morlet and its w2 mode with cmhat, B3b with
     a bump on the (4, 160000) batch, hhhat unpadded), each at its
     wavelet's own scales, against its plain version on both engines
     (n_up = 262144 and 160000), two runs bit-identical, with the
     launch's peak; the order-0 GMW read from a memoized table against
     its closed form, with both times; then 16 public calls (the GMW as
     a reference; `ssq_cwt` with cmhat, an order-1 GMW, morlet through
     `cwt_general`, `order=(0, 1)`, a bump on the batch; `cwt` with hhhat
     and a user's function; `ssq_cwt2` with morlet and cmhat `get_w`;
     four of them unpadded), each on exactly its route's counters (the
     `table_*` ones, `cwt_general.calls`, a `trigdiff` shim, no plain
     version), against the same call with the models' kernel wrappers
     swapped for their plain versions, timed with its peak above what
     the script holds;
 12c. (`streaming_section`) the streaming plans (`ssqueezepy_tpu_torch/
     streaming.py`, `streaming_multirate.py`) at chunk 4096 on white
     noise: `StreamingSSQCWT` with 97 scales (n_up 8192, B1 + B2; and on
     a (4, 4096) batch, B3b + B2) and with 181 wide scales (n_up 20480,
     the mixed engine), `StreamingMultirateSSQCWT` with the 181 (B3 per
     octave block + B5), `StreamingSSQSTFT` (n_fft 512: B6 bins + B2),
     `StreamingCWT` (B3), `StreamingSTFT` (B6 Sx mode),
     `StreamingSSQCWT2` (B8 + B2) and `StreamingSSQSTFT2` (B7 + B2).
     Each plan: one `process` with the counters zeroed launches exactly
     its route's kernels and no plain version; 40 chunks and `finalize`
     against the same plan with the kernel wrappers swapped for their
     plain versions (each multirate octave's B3 against its plain
     version on its own); the STFT streams against the offline
     `ssq_stft`/`stft`/`ssq_stft2` of the record; the carry state after
     chunk 20, resumed in a fresh plan, continues bit for bit; ms per
     chunk over 50 chunks on the card, the real-time factor at 48 kHz
     and the peak. Then a 160000-sample chirp through `stream_ssq_cwt(x,
     10000, 'gmw', N=160000)` (mixed B1 + B2) and `issq_cwt` back
     (mad_rms < 0.1), its Tx column sums against the offline `ssq_cwt`
     of the same plan one context from each edge, and its ms per record;
 12d. (`grad_section`) gradients through the kernels' autograd
     Functions at the 160k shapes: `ssq_cwt` (one signal, the (4, N)
     batch, `get_dWx`, `get_w`), `cwt`, `ssq_cwt2`, `ssq_stft` (hop 1 and
     8), `ssq_stft2`, `stft` and `ssqueeze(Wx, dWx=...)` from the signal.
     Per route the forward launches exactly its kernels and the backward
     none; x.grad through the kernels against x.grad through the plain
     versions on the card (autograd through torch ops): for a
     reconstruction loss through the route's inverse (`issq_cwt`, `icwt`,
     `issq_stft`, `istft`) within 1e-4 of max, for sum |out|^2 within
     2e-3 of max at the kernel route's bins and Tx (its difference on
     the plain versions' own bins, and the count of cells whose bins
     differ, printed); forward and forward + backward ms (host clock)
     with the peak. Then the framed STFT at hop 8 on the (4, 160000)
     batch, each row bit-identical to its one-signal call;
 12e. (`parallel_section`) the multi-rank layer
     (`ssqueezepy_tpu_torch/parallel/`): (a) a world of one under NCCL on
     this card at the headline, `ShardedSSQCWT` (the 293 scales),
     `ShardedSSQSTFT` and `ShardedSSQSTFT2` (n_fft = 598),
     `ShardedSSQCWT2`, `sharded_cwt` and `TimeShardedSSQCWT` on the
     (4, 160000) batch, each with the counters zeroed just before it and
     on exactly its kernels, each output bit-identical to the one-device
     call on the same batch (the time plan, whose window differs, within
     5e-3 of max on interior columns), then `sharded_icwt` and
     `sharded_issq_cwt` on the shards (1e-5 of max, no kernel); each timed
     beside its one-device call (CUDA events, in turns) with its peak, and
     the all_reduce of Tx alone; (b) worlds of 2 and 4 ranks spawned on
     this card under gloo with CUDA tensors (`_parallel_rank`): the mesh
     shapes (1, 2), (2, 1), (2, 2), the time meshes (1, 2) and (1, 4), the
     STFT rows on (1, 2) and the three-axis (1, 2, 2) at N = 32768, each
     held against the one-device call with the CPU tests' tolerances, and
     a heartbeat. Every kernel is built before the ranks are spawned;
     (a)'s launches are added to the `kernels` line's counts;
 12f. (`analysis_section`) `extract_ridges(Tx, scales, penalty=2,
     n_ridges=2)` on the bench plan's `ssq_cwt` of a linear plus an
     exponential chirp from `TestSignals(N=160000)`: exactly 2 forward +
     2 trace launches of the ridge kernels (`csrc/ridge_dp.cu`), the
     median relative error of `ssq_freqs[ridge]` against the two known
     frequency laws on the interior 80% of columns < 10%; the kernels
     against their plain versions on the first 8192 columns and at the
     full 160000 (pe bit-identical, the indices equal), each timed at
     160000 (CUDA events, 3 after one warm-up) with its plain version
     (one run) and its bound, and the public call (host clock, 3); the
     launch plan (`ridge_plan`: the forward's cluster of 8 CTAs, P in
     registers, the clusters that fit the card at once; the trace's
     rings), the forward at 16 CTAs (bit-identical, timed) and its
     per-column floor at (1, 160000, 8), beside its bound; then
     `experimental.phase_ssqueeze` from `ssq_cwt(get_dWx=True)`'s Wx and
     dWx (`get_w=True`): B5 alone, against `ssq_cwt(get_w=True)`'s Tx by
     the bins criterion, timed;
 12g. (`band_section`) the band plan of B6/B7 at the headline (n_fft =
     598: the pair's band br = 40 and the bank's 48 of f1 = 320) and on
     the (4, 160000) batch: the tables' MB banded and full; every mode
     (B6 Sx, Sx + dSx, bins; B7 FSST2 and w2) on the banded tables that
     the public calls take, against its banded plain version (2e-5 of
     max, bins by the criteria above), the batch's rows bit-identical to
     one-signal launches, B7's V bit-identical to B6's Sx on the bank's
     band; each mode timed banded and full in turns (CUDA events) and
     its two launches under the profiler (stage 1, stage 2); the peaks
     and host ms of `stft`, `ssq_stft` and `ssq_stft2` with the band on
     and off. Section 10's float32 hop-1 STFT calls (and 12c-12e's) must
     launch B6/B7 on banded tables only (the `*_banded` counters);
 12h. (`prune_section`) stage-1 support pruning of the CWT kernel at the
     headline: the support plan on both engines (rows kept, klim
     quantiles, the radix-4 stage-1 levels per row), then B1, B3 with one
     and two planes, B3b on the (4, 160000) batch, B8 and its w2 mode
     (n_up = 262144), B1 and B8 unpadded (the mixed engine, n_up =
     160000) and B1 with cmhat from its table, each pruned (the public
     calls' launch) against the same launch with stage 1 unpruned through
     the private hook `klims` (rows0 in every row): bit-identical but for
     the sign of zero cells (their count printed), timed in turns (CUDA
     events) with its two launches under the profiler (`bins_stage1`,
     `bins_stage2`). Every CWT-kernel call of the other sections runs
     pruned, and the CWT kernels' bounds count the DFT levels the pruned
     rows need (`stage1_levels`);
 12i. (`past_ceiling_section`, after 12f) the public calls past the
     kernels' rules (ROADMAP.md queue C, C1b) on their general routes:
     (a) `stft` and `ssq_stft` at N = 4194304 (float32, hop 1, n_fft =
     598: Np2 = 4718592), `ssq_stft2` at N = 1200000 (float64), `ssq_cwt2`
     at N = 3000000 (float64, reflect, 300 log-piecewise scales: n_up =
     2^23), `ssq_cwt(padtype=None)` at N = 10^7 (float64, 8 scales) and
     `ssq_stft` at N = 4096 with n_fft = 51200 (25601 bins), each with
     the counters zeroed just before: exactly its general functions
     (`stft_general`, `fsst2_general`, `wsst2_general`, `cwt_general`,
     `scatter_general`) and B4 or B5, no launch of a CWT or STFT kernel
     (any counter), finite outputs, `istft` of the `stft` back (MAE <
     1e-5), each call's host ms and peak GB (lines `past ceiling: ...`);
     (b) at N = 160000 with the three predicates answering False
     in-process (`general_only`), `stft`, `ssq_stft`, `ssq_stft2`, `cwt`,
     `ssq_cwt` and `ssq_cwt2` on their general routes against the kernel
     routes: Sx/Wx within 2e-5 of max, Tx by the bins criterion, both
     timed (lines `general route at N=160000: ...`); (c) the helpers of
     the top level (`replace_*`, `zero_denormals`, `S`, `Q`, `mad`,
     `est_riskshrink_thresh`, `unbuffer`, `FFT_GLOBAL`, `asnumpy`,
     `visuals._np`) on CUDA tensors: outputs on the card, equal to the
     CPU's; (a)'s launches are added to the `kernels` line's counts;
 13. prints one `{"kernels": [...]}` line (the band plan's six rows, the
     table modes' nine, then the ridge kernels' two, last), then, as the
     last line,
     `{"ok": true, "device": {...}}`.

Any failed check exits non-zero before those lines. Without a CUDA
device, or without the package beside this script, it exits non-zero.
The port's plan memo on disk is kept under `build/plan_cache` beside this
script.
"""
import json
import os
import re
import subprocess
import sys
import time
import types

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks from NVIDIA's data sheet: HBM bytes/s,
# float32 FLOP/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12


def fail(msg):
    print("chip_smoke FAILED: " + msg, file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok, msg):
    if not ok:
        fail(msg)
    print("  ok: " + msg, flush=True)


def cuda_ms(fn, reps=10, warm=2):
    """Mean milliseconds of `fn()` over `reps` launches, CUDA events,
    after `warm` warm-up calls."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def host_ms(fn, reps=10, warm=2):
    """(mean host-clock ms per call ending in a synchronize, peak device
    GB allocated over the timed calls, plan constants included). Each
    call's outputs are dropped before the next call starts."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / reps * 1e3
    return ms, torch.cuda.max_memory_allocated() / 1e9


def rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max())


def bins_criterion(Tx_k, Tx_p, what):
    m = float(Tx_p.abs().max())
    col = float((Tx_k.sum(-2) - Tx_p.sum(-2)).abs().max())
    e_k, e_p = float(Tx_k.abs().sum()), float(Tx_p.abs().sum())
    check(col < 1e-4 * m and abs(e_k - e_p) / e_p < 5e-3,
          "%s: Tx column sums %.3g of max, energy %.3g (bins criterion "
          "1e-4 / 5e-3)" % (what, col / m, abs(e_k - e_p) / e_p))


def bound(nbytes, flops):
    """(bound ms, 'bytes' or 'operations') on the H100 peaks above."""
    tb, tf = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOP_S
    return max(tb, tf) * 1e3, ('operations' if tf > tb else 'bytes')


def ptxas_report(log, key):
    """One line per kernel whose mangled name holds `key`, from an
    `nvcc -Xptxas -v` log: its registers, barriers, stack and spills. A
    kernel template `name<float|double, int|bool, ...>` is named so."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function '" in line:
            name = line.split("'")[1]
            out[name] = []
        elif name is not None and ('Used' in line or 'spill' in line):
            out[name].append(line.split(' : ')[-1].strip())

    def readable(n):
        m = re.search(r'\d+(%s\w*?)I((?:[fd]|L[ib]\d+E)+)E' % key, n)
        if m is None:
            return n
        args = [{'f': 'float', 'd': 'double'}[f] if f else
                ('true' if val == '1' else 'false') if kind == 'b' else val
                for f, kind, val in re.findall(r'([fd])|L([ib])(\d+)E',
                                               m.group(2))]
        return '%s<%s>' % (m.group(1), ', '.join(args))
    return ['%s: %s' % (readable(n), '; '.join(v)) for n, v in out.items()
            if key in n]


def launches_of(counters, fn):
    """Set every counter (name, wrapper, attribute) to 0, run `fn`
    (synchronized), read the counters: (fn's result, {name: count})."""
    import torch
    for _, w, attr in counters:
        setattr(w, attr, 0)
    out = fn()
    torch.cuda.synchronize()
    return out, {name: getattr(w, attr) for name, w, attr in counters}


def wavelet_section(stq, dev, card, x_np, xb_np):
    """Section 12b: the CWT kernel's table modes (every wavelet but the
    order-0 GMW read from a table) and the public calls with the other
    wavelets. Returns (kernel rows, {call: (e2e ms, peak GB)})."""
    import torch
    from ssqueezepy_tpu_torch.models import (cwt as cwt_mod,
                                             ssq_cwt as ssq_mod,
                                             ssq_cwt2 as ssq2_mod)
    from ssqueezepy_tpu_torch.models.cwt import resolve_wavelet
    from ssqueezepy_tpu_torch.models.ssq_cwt import _ssq_cwt_plan
    from ssqueezepy_tpu_torch.ops import cwt_cuda, ssq_cuda
    from ssqueezepy_tpu_torch.ops.cwt_cuda import (
        cwt_bins, cwt_bins_plain, cwt_bins2, cwt_bins2_plain, cwt_fused,
        cwt_fused_plain, cwt_w2, four_step)
    from ssqueezepy_tpu_torch.ops.ssq_cuda import (
        scatter_kv, scatter_kv_plain, shift_scatter, shift_scatter_plain,
        ssq_fused, ssq_fused_plain)
    from ssqueezepy_tpu_torch.ops.ssq_kernels import compute_bins
    from ssqueezepy_tpu_torch.ops.fft import rfft
    from ssqueezepy_tpu_torch.ops.pad import padsignal, pad_params

    N, B = len(x_np), len(xb_np)
    cb, rb = 8, 4                       # complex64, float32 bytes
    nr4, n1 = pad_params(N, 'reflect')[:2]
    gamma = 10 * float(np.finfo(np.float32).eps)
    rows, e2e = [], {}
    # every plain version (and `trigdiff`) behind a counting shim: the
    # public calls below must reach none of them on the card
    shims = {}
    for mod, name in ((cwt_cuda, 'cwt_bins_plain'),
                      (cwt_cuda, 'cwt_fused_plain'),
                      (cwt_cuda, 'cwt_bins2_plain'), (cwt_cuda, 'wsst2_rows'),
                      (cwt_mod, 'cwt_core'), (ssq_cuda, 'scatter_kv_plain'),
                      (ssq_cuda, 'ssq_fused_plain'),
                      (ssq_cuda, 'shift_scatter_plain'),
                      (ssq_mod, 'trigdiff')):
        orig = getattr(mod, name)

        def shim(*a, _orig=orig, _name=name, **k):
            shims[_name][3].calls += 1
            return _orig(*a, **k)
        shim.calls = 0
        shims[name] = (mod, name, orig, shim)
        setattr(mod, name, shim)
    counters = [('%s.%s' % (w.__name__, a), w, a)
                for w in (cwt_bins, cwt_fused, cwt_bins2, cwt_w2)
                for a in dir(w) if a.endswith('launches')] + [
        ('%s.launches' % w.__name__, w, 'launches')
        for w in (scatter_kv, ssq_fused, shift_scatter)] + [
        ('cwt_general', cwt_mod.cwt_general, 'calls')] + [
        (name if name == 'trigdiff' else 'plain ' + name, v[3], 'calls')
        for name, v in shims.items()]

    def plain_route(fn):
        """fn() with every kernel wrapper the models call replaced by its
        plain version (on the card's tensors)."""
        swaps = [(cwt_mod, 'cwt_fused', cwt_fused_plain),
                 (ssq_mod, 'cwt_bins', cwt_bins_plain),
                 (ssq_mod, 'cwt_fused', cwt_fused_plain),
                 (ssq_mod, 'scatter_kv', scatter_kv_plain),
                 (ssq_mod, 'ssq_fused', ssq_fused_plain),
                 (ssq2_mod, 'cwt_bins2', cwt_bins2_plain),
                 (ssq2_mod, 'cwt_w2', shims['wsst2_rows'][2]),
                 (ssq2_mod, 'scatter_kv', scatter_kv_plain),
                 (ssq_cuda, 'shift_scatter', shift_scatter_plain)]
        saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
        try:
            for m, n, f in swaps:
                setattr(m, n, f)
            return fn()
        finally:
            for m, n, f in saved:
                setattr(m, n, f)

    def gauss4(w):
        """A user's wavelet: a real Gaussian bump at w = 4."""
        return torch.exp(-(w - 4.) ** 2) * (w > 0)

    def own_scales(spec):
        wv = resolve_wavelet(spec, N=N)
        return wv, stq.process_scales('log-piecewise', N, wv)[:300]

    # ---- each table mode against its plain version, both engines ---------
    modes = {'bins': ('cmhat', 2), 'wx': ('hhhat', 1),
             'wx_dwx': (('gmw', {'order': 1}), 2), 'bins2': ('morlet', 5),
             'w2': ('cmhat', 5), 'batched': ('bump', 2)}
    x_t = torch.as_tensor(x_np, device=dev)
    xb_t = torch.as_tensor(xb_np, device=dev)
    spectra = {'radix-4': (rfft(padsignal(x_t, 'reflect')).contiguous(),
                           rfft(padsignal(xb_t, 'reflect')).contiguous(),
                           nr4, n1),
               'mixed': (rfft(x_t).contiguous(), rfft(xb_t).contiguous(), N,
                         0)}
    km = {}
    for engine, (xh1, xhb, n_up, n1e) in spectra.items():
        half = n_up // 2 + 1
        for mode, (spec, planes) in modes.items():
            if engine == 'mixed' and spec == 'bump':
                # the bump's unpadded piecewise ssq grid has no knee at
                # this N (in the JAX package too)
                spec = 'hhhat'
            wv, sc_np = own_scales(spec)
            pl, _ = _ssq_cwt_plan(wv, N, sc_np, None, None, 'peak',
                                  engine == 'radix-4', 1.)
            na = len(sc_np)
            sc = torch.as_tensor(sc_np.ravel(), dtype=torch.float32,
                                 device=dev)
            c = torch.as_tensor(np.broadcast_to(np.ravel(pl.const),
                                                (na,)).copy(),
                                dtype=torch.float32, device=dev)
            nb = pl.params['omax'] + 1
            xh = xhb if mode == 'batched' else xh1
            if mode in ('bins', 'batched'):
                a = (xh, sc, wv, n_up, n1e, N, 1., True, pl.params, gamma,
                     True)
                k_fn, p_fn = cwt_bins, cwt_bins_plain
            elif mode in ('wx', 'wx_dwx'):
                a = (xh, sc, wv, n_up, n1e, N, 1., mode == 'wx_dwx', True)
                k_fn, p_fn = cwt_fused, cwt_fused_plain
            elif mode == 'bins2':
                a = (xh, sc, wv, n_up, n1e, N, 1., pl.params, gamma, True)
                k_fn, p_fn = cwt_bins2, cwt_bins2_plain
            else:
                a = (xh, sc, wv, n_up, n1e, N, 1., gamma)
                k_fn, p_fn = cwt_w2, shims['wsst2_rows'][2]
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            outk = k_fn(*a)
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 1e9
            outp = p_fn(*a)
            what = "%s table mode %s (%s) at n_up=%d=%dx%d, %d scales" % (
                (engine, mode, wv.name, n_up) + four_step(n_up) + (na,))
            if mode == 'batched':
                what += ", batch of %d" % B
            err = float((outk[0] - outp[0]).abs().max())
            m = float(outp[0].abs().max())
            check(bool(torch.isfinite(torch.view_as_real(outk[0])).all())
                  and err <= 2e-5 * m,
                  "%s: Wx %.3g of max vs plain (limit 2e-5); the launch's "
                  "peak %.3f GB above what was live, its table and scratch "
                  "included" % (what, err / m, peak))
            if mode in ('bins', 'batched', 'bins2'):
                flips = float((outk[1] != outp[1]).double().mean())
                check(flips <= 0.01, "%s: k differs on %.4f%% of cells "
                      "(limit 1%%)" % (what, 100 * flips))
                bins_criterion(scatter_kv_plain(outk[0], outk[1], c, nb),
                               scatter_kv_plain(outp[0], outp[1], c, nb),
                               what)
            elif mode == 'wx_dwx':
                check(rel_err(outk[1], outp[1]) <= 2e-5, "%s: dWx %.3g of "
                      "max vs plain" % (what, rel_err(outk[1], outp[1])))
            elif mode == 'w2':
                gd = float((torch.isinf(outk[1]) != torch.isinf(outp[1]))
                           .double().mean())
                check(gd <= 1e-3, "%s: w2 gated alike but on %.4f%% of "
                      "cells (limit 0.1%%)" % (what, 100 * gd))
                bins_criterion(
                    shift_scatter_plain(outk[0], *compute_bins(
                        outk[1], pl.params, True), nb, c),
                    shift_scatter_plain(outp[0], *compute_bins(
                        outp[1], pl.params, True), nb, c), what + " Tx")
            again = k_fn(*a)
            check(all(torch.equal(u, v) for u, v in zip(outk, again)
                      if u is not None), "%s: repeat bit-identical" % what)
            del outk, outp, again
            torch.cuda.empty_cache()
            tab_bytes = (3 if planes == 5 else 1) * na * half * rb
            # the table's build outside the memo, beside the kernel's time
            # and not in its bound: the TPU kernel computes psih in its body
            tab_ms = cuda_ms(lambda: cwt_cuda.wavelet_table(
                wv, sc, n_up, planes == 5), reps=2, warm=0)
            ms = cuda_ms(lambda: k_fn(*a), reps=5)
            plain_ms = cuda_ms(lambda: p_fn(*a), reps=2, warm=1)
            n_rows = na * (B if mode == 'batched' else 1)
            spec_lib = torch.zeros((planes * n_rows, n_up),
                                   dtype=torch.complex64, device=dev)
            spec_lib[:, :half] = 1.
            lib_ms = cuda_ms(lambda: torch.fft.ifft(spec_lib, dim=-1),
                             reps=3)
            del spec_lib
            torch.cuda.empty_cache()
            # inputs read once (the half spectra, the scales; not the
            # table, which the function does not need), outputs written once
            # (Wx; k, w2 or dWx); `planes` inverse DFTs per row at
            # 5 n FLOP per level, over the levels the table's pruned rows
            # need (`stage1_levels`)
            out_b = n_rows * N * (cb + {'wx': 0, 'wx_dwx': cb,
                                        'w2': rb}.get(mode, 4))
            nbytes = xh.numel() * cb + na * rb + out_b
            kl = cwt_cuda.table_klims(cwt_cuda.wavelet_table(
                wv, sc, n_up, planes == 5), n_up).cpu().numpy()
            lv = (n_rows // na) * float((stage1_levels(kl, n_up) + np.log2(
                four_step(n_up)[1])).sum())
            flops = planes * 5 * n_up * lv
            bms, by = bound(nbytes, flops)
            km[(engine, mode)] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                      bound_ms=bms, bound_by=by,
                                      library_ms=lib_ms)
            print("%s: %.3f ms from the memoized table (plain %.3f, "
                  "torch.fft.ifft DFT core %.3f, bound %.3f by %s: %.3g B, "
                  "%.3g FLOP); the table %.3g B, built in %.3f ms; card: %s"
                  % (what, ms, plain_ms, lib_ms, bms, by, nbytes, flops,
                     tab_bytes, tab_ms, card), flush=True)
            del a, xh
            cwt_cuda._TABLES.clear()
            torch.cuda.empty_cache()

    # ---- the order-0 GMW through the table against its closed form -------
    gmw = resolve_wavelet(('gmw', {'dtype': 'float32'}), N=N)
    gfn = gmw.fn

    def twin_fn(w, xp=torch):
        """The order-0 GMW with neither its kernel parameters nor its
        closed-form derivatives: a named wavelet, so its table is
        memoized as any other's (derivatives by autograd)."""
        return gfn(w, xp=xp)
    twin_fn.config, twin_fn.qualname = {}, 'gmw_table_twin'
    twin = resolve_wavelet(stq.Wavelet(twin_fn, dtype='float32'))
    sc_np = stq.process_scales('log-piecewise', N, gmw)[:300]
    for engine, (xh1, _, n_up, n1e) in spectra.items():
        pl, _ = _ssq_cwt_plan(gmw, N, sc_np, None, None, 'peak',
                              engine == 'radix-4', 1.)
        sc = torch.as_tensor(sc_np.ravel(), dtype=torch.float32, device=dev)
        for mode, fn, a in (
                ('bins', cwt_bins, (n_up, n1e, N, 1., True, pl.params,
                                    gamma, True)),
                ('wx', cwt_fused, (n_up, n1e, N, 1., False, True)),
                ('bins2', cwt_bins2, (n_up, n1e, N, 1., pl.params, gamma,
                                      True))):
            ref = fn(xh1, sc, gmw, *a)
            got = fn(xh1, sc, twin, *a)
            torch.cuda.synchronize()
            err = rel_err(got[0], ref[0])
            nk = int((got[1] != ref[1]).sum()) if mode != 'wx' else 0
            ms_c = cuda_ms(lambda: fn(xh1, sc, gmw, *a), reps=5)
            ms_t = cuda_ms(lambda: fn(xh1, sc, twin, *a), reps=5)
            check(err <= 2e-5, "%s %s: GMW read from its table (derivatives "
                  "by autograd) vs synthesized: W %.3g of max (limit 2e-5), "
                  "%d of %d k cells differ; %.3f ms from the memoized table "
                  "vs %.3f ms synthesized (stage 2 is the same code); card: "
                  "%s"
                  % (engine, mode, err, nk, ref[0].numel(), ms_t, ms_c,
                     card))
            del ref, got
        cwt_cuda._TABLES.clear()
        torch.cuda.empty_cache()
    del spectra, xh1

    # ---- the public calls, counters zeroed just before, read just after --
    wsc = {name: own_scales(spec)[1] for name, spec in (
        ('cmhat', 'cmhat'), ('gmw1', ('gmw', {'order': 1})),
        ('morlet', 'morlet'), ('hhhat', 'hhhat'), ('bump', 'bump'))}
    calls = {
        # the order-0 GMW at its own 293 scales: the closed form, measured
        # as the calls below are
        'ssq_cwt_gmw': (lambda: stq.ssq_cwt(x_t, scales=sc_np),
                        {'cwt_bins.launches', 'scatter_kv.launches'}),
        'cwt_gmw': (lambda: stq.cwt(x_t, scales=sc_np),
                    {'cwt_fused.launches'}),
        'ssq_cwt2_gmw': (lambda: stq.ssq_cwt2(x_t, scales=sc_np),
                         {'cwt_bins2.launches', 'scatter_kv.launches'}),
        'ssq_cwt_cmhat': (lambda: stq.ssq_cwt(x_t, 'cmhat',
                                              scales=wsc['cmhat']),
                          {'cwt_bins.table_launches', 'scatter_kv.launches'}),
        'ssq_cwt_gmw_order1': (lambda: stq.ssq_cwt(
            x_t, ('gmw', {'order': 1}), scales=wsc['gmw1']),
            {'cwt_bins.table_launches', 'scatter_kv.launches'}),
        'ssq_cwt_morlet': (lambda: stq.ssq_cwt(x_t, 'morlet',
                                               scales=wsc['morlet']),
                           {'cwt_general', 'ssq_fused.launches'}),
        'ssq_cwt_order01': (lambda: stq.ssq_cwt(x_t, order=(0, 1),
                                                scales=sc_np),
                            {'cwt_fused.launches',
                             'cwt_fused.table_launches', 'trigdiff',
                             'ssq_fused.launches'}),
        'cwt_hhhat': (lambda: stq.cwt(x_t, 'hhhat', scales=wsc['hhhat']),
                      {'cwt_fused.table_launches'}),
        'ssq_cwt_bump_b4': (lambda: stq.ssq_cwt(xb_t, 'bump',
                                                scales=wsc['bump']),
                            {'cwt_bins.table_batched_launches',
                             'scatter_kv.launches'}),
        'ssq_cwt2_morlet': (lambda: stq.ssq_cwt2(x_t, 'morlet',
                                                 scales=wsc['morlet']),
                            {'cwt_bins2.table_launches',
                             'scatter_kv.launches'}),
        'ssq_cwt2_cmhat_getw': (lambda: stq.ssq_cwt2(
            x_t, 'cmhat', scales=wsc['cmhat'], get_w=True),
            {'cwt_w2.table_launches', 'shift_scatter.launches'}),
        'cwt_custom': (lambda: stq.cwt(x_t, gauss4, scales=wsc['cmhat']),
                       {'cwt_general'}),
        # unpadded (n_up = N, the mixed engine)
        'ssq_cwt_cmhat_padnone': (lambda: stq.ssq_cwt(
            x_t, 'cmhat', scales=wsc['cmhat'], padtype=None),
            {'cwt_bins.table_mixed_launches', 'scatter_kv.launches'}),
        'cwt_hhhat_padnone': (lambda: stq.cwt(
            x_t, 'hhhat', scales=wsc['hhhat'], padtype=None),
            {'cwt_fused.table_mixed_launches'}),
        'ssq_cwt2_morlet_padnone': (lambda: stq.ssq_cwt2(
            x_t, 'morlet', scales=wsc['morlet'], padtype=None),
            {'cwt_bins2.table_mixed_launches', 'scatter_kv.launches'}),
        'ssq_cwt2_cmhat_getw_padnone': (lambda: stq.ssq_cwt2(
            x_t, 'cmhat', scales=wsc['cmhat'], padtype=None, get_w=True),
            {'cwt_w2.table_mixed_launches', 'shift_scatter.launches'}),
    }
    launches = dict.fromkeys((n for n, _, _ in counters), 0)
    for name, (fn, need) in calls.items():
        fn()                                  # plan memo + first launch
        torch.cuda.synchronize()
        out, counts = launches_of(counters, fn)
        moved = {k for k, v in counts.items() if v}
        check(moved == need, "%s at N=%d launched %s (needs exactly %s)"
              % (name, N, sorted(moved), sorted(need)))
        for k, v in counts.items():
            launches[k] += v
        ref = plain_route(fn)
        if name.startswith('cwt'):
            err = rel_err(out[0], ref[0])
            check(bool(torch.isfinite(torch.view_as_real(out[0])).all())
                  and err <= 2e-5, "%s: Wx %s finite, %.3g of max vs the "
                  "plain path" % (name, tuple(out[0].shape), err))
        else:
            err = rel_err(out[1], ref[1])
            check(bool(torch.isfinite(torch.view_as_real(out[0])).all())
                  and err <= 2e-5, "%s: Tx %s finite, Wx %.3g of max vs the "
                  "plain path" % (name, tuple(out[0].shape), err))
            bins_criterion(out[0], ref[0], "%s vs plain path" % name)
        del out, ref
        cwt_cuda._TABLES.clear()
        torch.cuda.empty_cache()
    # each call's peak above what the script holds before it, with only
    # its own wavelet table and cuFFT plans cached
    for name, (fn, _) in calls.items():
        cwt_cuda._TABLES.clear()
        torch.backends.cuda.cufft_plan_cache.clear()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated() / 1e9
        ms, peak = host_ms(fn)
        e2e[name] = (ms, peak - base)
        print("%s end to end at N=%d: %.3f ms/call (host clock, mean of 10 "
              "after warm-up), peak device memory %.3f GB above the %.3f GB "
              "held before the call; card: %s"
              % (name, N, ms, peak - base, base, card), flush=True)
    cwt_cuda._TABLES.clear()
    for mod, name, orig, _ in shims.values():
        setattr(mod, name, orig)
    print("wavelet-table calls' launches, summed over the %d calls: %s"
          % (len(calls), {k: v for k, v in launches.items() if v}),
          flush=True)

    for name, key, counter in (
            ('cwt_bins_table', ('radix-4', 'bins'),
             'cwt_bins.table_launches'),
            ('cwt_fused_table', ('radix-4', 'wx'),
             'cwt_fused.table_launches'),
            ('cwt_bins_batched_table', ('radix-4', 'batched'),
             'cwt_bins.table_batched_launches'),
            ('cwt_bins2_table', ('radix-4', 'bins2'),
             'cwt_bins2.table_launches'),
            ('cwt_w2_table', ('radix-4', 'w2'), 'cwt_w2.table_launches'),
            ('cwt_bins_table_mixed', ('mixed', 'bins'),
             'cwt_bins.table_mixed_launches'),
            ('cwt_fused_table_mixed', ('mixed', 'wx'),
             'cwt_fused.table_mixed_launches'),
            ('cwt_bins2_table_mixed', ('mixed', 'bins2'),
             'cwt_bins2.table_mixed_launches'),
            ('cwt_w2_table_mixed', ('mixed', 'w2'),
             'cwt_w2.table_mixed_launches')):
        r = km[key]
        rows.append(dict(
            name=name, route='cuda',
            source='ssqueezepy_tpu_torch/csrc/cwt_bins.cu',
            replaces='ssqueezepy_tpu/ops/cwt_pallas.py:70',
            launches=launches[counter], max_abs_err=r['err'], ms=r['ms'],
            plain_ms=r['plain_ms'], bound_ms=r['bound_ms'],
            bound_by=r['bound_by'], library_ms=r['library_ms']))
    return rows, e2e


def streaming_section(stq, dev, card, counters):
    """Section 12c: the streaming plans (A10) at chunk 4096 and the 160k
    record through `stream_ssq_cwt`. Returns {kernel counter name:
    launches} of one counted `process` per plan and of the record."""
    import torch
    from ssqueezepy_tpu_torch import streaming as st_mod
    from ssqueezepy_tpu_torch import streaming_multirate as mr_mod
    from ssqueezepy_tpu_torch.models import cwt as cwt_mod
    from ssqueezepy_tpu_torch.ops import cwt_cuda, ssq_cuda, stft_cuda
    from ssqueezepy_tpu_torch.ops.cwt_cuda import (
        cwt_bins_plain, cwt_bins2_plain, cwt_fused, cwt_fused_plain)
    from ssqueezepy_tpu_torch.ops.ssq_cuda import (scatter_kv_plain,
                                                   shift_scatter_plain)
    from ssqueezepy_tpu_torch.ops.stft_cuda import (fsst2_conv_plain,
                                                    stft_conv_plain)

    chunk, n_chunks, B = 4096, 40, 4
    audio_ms = chunk / 48000 * 1e3
    g32 = ('gmw', {'dtype': 'float32'})
    sc97 = np.geomspace(1., 64., 97).reshape(-1, 1)
    wide = np.geomspace(1., 512., 181).reshape(-1, 1)
    ctx97 = dict(scales=sc97, nv=None, N=16 * chunk, history=2048,
                 lookahead=2048)
    # every plain version behind a counting shim: no plan may reach one
    shims = {}
    for mod, name in ((cwt_cuda, 'cwt_bins_plain'),
                      (cwt_cuda, 'cwt_fused_plain'),
                      (cwt_cuda, 'cwt_bins2_plain'), (cwt_cuda, 'wsst2_rows'),
                      (cwt_mod, 'cwt_core'),
                      (ssq_cuda, 'scatter_kv_plain'),
                      (ssq_cuda, 'shift_scatter_plain'),
                      (ssq_cuda, 'ssq_fused_plain'),
                      (stft_cuda, 'stft_conv_plain'),
                      (stft_cuda, 'fsst2_conv_plain'),
                      (stft_cuda, 'fsst2_rows')):
        orig = getattr(mod, name)

        def shim(*a, _orig=orig, _name=name, **k):
            shims[_name][3].calls += 1
            return _orig(*a, **k)
        shim.calls = 0
        shims[name] = (mod, name, orig, shim)
        setattr(mod, name, shim)
    # `cwt_general` (the route of the wavelets off the kernel's) counts
    # its own calls: these GMW plans must take none
    watched = counters + [('cwt_general', cwt_mod.cwt_general, 'calls')] + [
        ('plain ' + n, v[3], 'calls') for n, v in shims.items()]

    def plain_route(fn):
        """fn() with every kernel wrapper the streaming plans call
        replaced by its plain version (on the card's tensors)."""
        swaps = [(st_mod, 'cwt_bins', cwt_bins_plain),
                 (st_mod, 'cwt_fused', cwt_fused_plain),
                 (st_mod, 'cwt_bins2', cwt_bins2_plain),
                 (st_mod, 'scatter_kv', scatter_kv_plain),
                 (st_mod, 'stft_conv', stft_conv_plain),
                 (st_mod, 'fsst2_conv', fsst2_conv_plain),
                 (mr_mod, 'cwt_fused', cwt_fused_plain),
                 (ssq_cuda, 'shift_scatter', shift_scatter_plain)]
        saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
        try:
            for m, n, f in swaps:
                setattr(m, n, f)
            return fn()
        finally:
            for m, n, f in saved:
                setattr(m, n, f)

    def engine(n_up):
        return '' if n_up & (n_up - 1) == 0 else '_mixed'

    def cwt_need(kernel, plan, batched=False):
        return {kernel + ('_batched' if batched else '') + engine(plan.n_up),
                'scatter_kv'} - ({'scatter_kv'} if kernel == 'cwt_fused'
                                 else set())

    plans = {
        'ssq_cwt_97': (lambda: stq.StreamingSSQCWT(chunk, g32, **ctx97), 1,
                       lambda p: cwt_need('cwt_bins', p)),
        'ssq_cwt_97_b4': (lambda: stq.StreamingSSQCWT(chunk, g32, **ctx97),
                          B, lambda p: cwt_need('cwt_bins', p, True)),
        'ssq_cwt_181_flat': (lambda: stq.StreamingSSQCWT(
            chunk, g32, scales=wide, nv=None, N=16 * chunk, history=8192,
            lookahead=8192), 1, lambda p: cwt_need('cwt_bins', p)),
        'ssq_cwt_181_multirate': (lambda: stq.StreamingMultirateSSQCWT(
            chunk, g32, scales=wide, nv=None, N=16 * chunk), 1,
            lambda p: {'cwt_fused' + engine(q['n_up']) for q in p._plans}
            | {'shift_scatter'}),
        'ssq_stft_512': (lambda: stq.StreamingSSQSTFT(
            chunk, n_fft=512, dtype='float32'), 1,
            lambda p: {'stft_conv', 'stft_conv_banded', 'scatter_kv'}),
        'cwt_97': (lambda: stq.StreamingCWT(chunk, g32, **ctx97), 1,
                   lambda p: cwt_need('cwt_fused', p)),
        'stft_512': (lambda: stq.StreamingSTFT(chunk, n_fft=512,
                                               dtype='float32'), 1,
                     lambda p: {'stft_conv', 'stft_conv_banded'}),
        'ssq_cwt2_97': (lambda: stq.StreamingSSQCWT2(chunk, g32, **ctx97), 1,
                        lambda p: cwt_need('cwt_bins2', p)),
        'ssq_stft2_512': (lambda: stq.StreamingSSQSTFT2(
            chunk, n_fft=512, dtype='float32'), 1,
            lambda p: {'fsst2_conv', 'fsst2_conv_banded', 'scatter_kv'}),
    }
    rng = np.random.default_rng(18)
    rec = torch.as_tensor(rng.standard_normal((B, n_chunks * chunk))
                          .astype(np.float32), device=dev)
    launches, rows = {}, {}

    def cat(parts, i):
        return torch.cat([p[i] for p in parts if p[i] is not None], dim=-1)

    # (Tx or None, Wx) of every plan, `StreamingCWT`/`StreamingSTFT` too
    # (their own `process` returns Wx alone)
    def proc(plan, c):
        return st_mod._StreamingBase.process(plan, c)

    def fin(plan):
        return st_mod._StreamingBase.finalize(plan)

    for name, (make, b, need_of) in plans.items():
        x = rec[0] if b == 1 else rec
        chunks = [x[..., i * chunk:(i + 1) * chunk] for i in range(n_chunks)]
        plan = make()
        what = "streaming %s (%s, chunk %d%s)" % (
            name, type(plan).__name__, chunk,
            ", batch of %d" % b if b > 1 else "")
        plan.process(chunks[0])               # first launch, cuFFT plans
        plan.reset()
        # 1. exactly the route's kernels in one process, no plain version
        _, counts = launches_of(watched, lambda: plan.process(chunks[0]))
        moved = {k for k, v in counts.items() if v}
        need = need_of(plan)
        check(moved == need, "%s: one process launched %s (needs exactly "
              "%s)" % (what, sorted(moved), sorted(need)))
        for k in need:
            launches[k] = launches.get(k, 0) + counts[k]
        # 2. the stream against the same plan on the plain versions; the
        # carry state snapshot after chunk 20 (4.: resumed below)
        plan.reset()
        outs = []
        for i, c in enumerate(chunks):
            outs.append(proc(plan, c))
            if i == n_chunks // 2 - 1:
                state = plan.state_dict()
        outs.append(fin(plan))
        ref_plan = make()
        ref = plain_route(lambda: [proc(ref_plan, c) for c in chunks]
                          + [fin(ref_plan)])
        W, W_p = cat(outs, 1), cat(ref, 1)
        err = rel_err(W, W_p)
        check(W.shape[-1] == n_chunks * chunk and err <= 2e-5 and
              bool(torch.isfinite(torch.view_as_real(W)).all()),
              "%s: %d chunks + finalize emit %s, finite, %.3g of max vs the "
              "plain versions (limit 2e-5)" % (what, n_chunks,
                                               tuple(W.shape), err))
        if plan.ssq:
            bins_criterion(cat(outs, 0), cat(ref, 0),
                           "%s vs the plain versions" % what)
        del ref, W_p
        # 3. the STFT streams against the offline port on the record
        if 'stft' in name:
            kw = dict(n_fft=512, dtype='float32')
            if name == 'stft_512':
                S_o = stq.stft(x, **kw)
                e_o = rel_err(W, S_o)
            else:
                off = (stq.ssq_stft2 if name.startswith('ssq_stft2')
                       else stq.ssq_stft)
                T_o, S_o = off(x, **kw)[:2]
                e_o = rel_err(W, S_o)
                bins_criterion(cat(outs, 0), T_o, "%s vs offline" % what)
            check(e_o <= 1e-5, "%s: Sx %.3g of max vs the offline call on "
                  "the %d-sample record, every column (limit 1e-5)"
                  % (what, e_o, x.shape[-1]))
            del S_o
        # 4. resume from the snapshot in a fresh plan, bit for bit
        resumed = make().load_state(state)
        rest = [proc(resumed, c) for c in chunks[n_chunks // 2:]] + [
            fin(resumed)]
        same = all((a is None and b_ is None) or torch.equal(a, b_)
                   for o, r in zip(outs[n_chunks // 2:], rest)
                   for a, b_ in zip(o, r))
        check(same, "%s: resumed after chunk %d in a fresh plan, the "
              "continuation is bit-identical" % (what, n_chunks // 2))
        # each multirate octave's B3 against its plain version
        if name == 'ssq_cwt_181_multirate':
            errs = []

            def held(xh, scales, *a, _errs=errs):
                out = cwt_fused(xh, scales, *a)
                ref1 = cwt_fused_plain(xh, scales, *a)
                _errs.append(max(rel_err(out[0], ref1[0]),
                                 rel_err(out[1], ref1[1])))
                return out
            mr_mod.cwt_fused = held
            try:
                plan.reset()
                plan.process(chunks[3])
            finally:
                mr_mod.cwt_fused = cwt_fused
            for p, e in zip(plan._plans, errs):
                check(e <= 2e-5, "%s: octave %d B3 (%d rows, n_up=%d, %s "
                      "engine) Wx, dWx %.3g of max vs its plain version "
                      "(limit 2e-5)" % (what, p['j'], len(p['scales']),
                                        p['n_up'], 'mixed' if engine(
                                            p['n_up']) else 'radix-4', e))
        del outs, rest, W
        # 6. ms per chunk and peak, chunks on the card, plan included
        del plan, resumed, ref_plan
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        plan = make()
        for i in range(3):
            plan.process(chunks[i])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(50):
            plan.process(chunks[(3 + i) % n_chunks])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 50 * 1e3
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        rows[name] = (ms, peak)
        extra = {'n_up': getattr(plan, 'n_up', None),
                 'Np2': getattr(plan, 'Np2', None),
                 'history': plan.history, 'lookahead': plan.lookahead}
        if name == 'ssq_cwt_181_multirate':
            extra['octave n_up'] = [p['n_up'] for p in plan._plans]
            extra['compute_ratio'] = round(plan.compute_ratio, 3)
        print("%s: %.4f ms per chunk (host clock, mean of 50 after 3 "
              "warm-up, chunks on the card), real-time factor %.1f at 48 "
              "kHz (%d samples = %.3f ms of audio%s), peak %.4f GB above "
              "the %.3f GB held before the plan (its constants included); "
              "%s; card: %s"
              % (what, ms, audio_ms * b / ms, chunk, audio_ms,
                 ", %d signals" % b if b > 1 else "", peak, base / 1e9,
                 extra, card), flush=True)
        del plan
        torch.cuda.empty_cache()

    # 5. a 160000-sample chirp through `stream_ssq_cwt` and back
    N, c10 = 160000, 10000
    n = np.arange(N)
    xc = np.cos(2 * np.pi * (0.02 * n + (0.18 - 0.02) / (2 * N) * n ** 2)) \
        .astype(np.float32)
    x160 = torch.as_tensor(xc, device=dev)
    stq.stream_ssq_cwt(x160, c10, 'gmw', N=N)   # first launches, cuFFT plans
    torch.cuda.synchronize()
    (Tx, Wx, fr, sc), counts = launches_of(
        watched, lambda: stq.stream_ssq_cwt(x160, c10, 'gmw', N=N))
    plan = stq.StreamingSSQCWT(c10, 'gmw', N=N)
    need = cwt_need('cwt_bins', plan)
    moved = {k for k, v in counts.items() if v}
    check(moved == need, "stream_ssq_cwt at N=%d, chunk %d: launched %s "
          "(needs exactly %s)" % (N, c10, sorted(moved), sorted(need)))
    for k in need:
        launches[k] = launches.get(k, 0) + counts[k]
    mad = stq.toolkit.mad_rms(xc, stq.issq_cwt(Tx))
    check(Tx.shape == (plan.nbins, N) and mad < 0.1, "stream_ssq_cwt at "
          "N=%d (%d scales, n_reliable %d, history = lookahead = %d, n_up = "
          "%d): Tx %s, issq_cwt mad_rms %.4f (limit 0.1)"
          % (N, len(sc), plan.n_reliable, plan.history, plan.n_up,
             tuple(Tx.shape), mad))
    Tx_o = stq.ssq_cwt(x160, 'gmw', scales='log', nv=32)[0]
    m = plan.history
    cs = (Tx.real.sum(-2) - Tx_o.real.sum(-2))[m:-m].abs().max()
    col = float(cs / Tx_o.abs().max())
    check(col < 5e-2, "stream_ssq_cwt at N=%d: Tx column sums %.3g of "
          "max|Tx| from the offline ssq_cwt of the same plan, %d columns "
          "from each edge (limit 5e-2)" % (N, col, m))
    del Tx, Wx, Tx_o
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rec_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = stq.stream_ssq_cwt(x160, c10, 'gmw', N=N)
        torch.cuda.synchronize()
        rec_ms.append((time.perf_counter() - t0) * 1e3)
        del out
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    drive_ms = []
    for _ in range(3):
        plan.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = st_mod._drive(plan, x160, c10)
        torch.cuda.synchronize()
        drive_ms.append((time.perf_counter() - t0) * 1e3)
        del out
    rows['stream_ssq_cwt_160k'] = (min(rec_ms), peak)
    print("streaming stream_ssq_cwt at N=%d, chunk %d (%d steps with "
          "finalize's): %.3f ms per record (host clock, best of 3 calls, "
          "plan made in the call: %s), %.3f ms for the chunks and finalize "
          "with the plan made (best of 3: %s), peak %.3f GB above the %.3f "
          "GB held before; card: %s"
          % (N, c10, N // c10 + -(-plan.lookahead // c10), min(rec_ms),
             ', '.join('%.3f' % v for v in rec_ms), min(drive_ms),
             ', '.join('%.3f' % v for v in drive_ms), peak, base / 1e9,
             card), flush=True)
    for mod, name, orig, _ in shims.values():
        setattr(mod, name, orig)
    print("streaming launches, one process per plan and the 160k record: "
          "%s" % launches, flush=True)
    return launches


def grad_section(stq, dev, card, counters, x_np, xb_np, spec, scales,
                 ssq_freqs, n_fft):
    """Section 12d: gradients through the kernels (each wrapper's
    `torch.autograd.Function`) at the 160k shapes. Per route: the forward
    on exactly the route's kernels and the backward on none; x.grad
    through the kernels against x.grad through the plain versions on the
    card (the models' kernel wrappers swapped for them, autograd through
    torch ops): for a reconstruction loss through the route's inverse
    within 1e-4 of max, for sum |out|^2 within 2e-3 of max with the plain
    versions at the kernel route's state, on the bins its scatters used
    and with its cotangent 2 Tx (the difference on their own bins and Tx,
    and the count of cells whose bins differ, printed);
    forward and forward + backward ms (host clock) and the peak. Returns
    the forward launches per counter."""
    import torch
    from ssqueezepy_tpu_torch.models import (cwt as cwt_mod,
                                             ssq_cwt as ssq_mod,
                                             ssq_cwt2 as ssq2_mod,
                                             ssq_stft as ssq_stft_mod,
                                             stft as stft_mod)
    from ssqueezepy_tpu_torch.models.windows import get_window
    from ssqueezepy_tpu_torch.ops import cwt_cuda, ssq_cuda, stft_cuda
    from ssqueezepy_tpu_torch.ops.phase import phase_transform_w
    from ssqueezepy_tpu_torch.ops.ssq_kernels import compute_bins

    N = len(x_np)
    f_stft = 2 / get_window(None, n_fft, n_fft=n_fft)[n_fft // 2]
    kw = dict(wavelet=spec, scales=scales, ssq_freqs=ssq_freqs)
    gamma = 10 * float(np.finfo(np.float32).eps)

    def route(call, inverse, need, hop=1):
        """(forward: x -> (plane, its reconstruction, hop), the counters
        the forward must launch, exactly)."""
        def fwd(x):
            plane = call(x)
            return plane, inverse(plane), hop
        return fwd, need

    def issq_cwt(Tx):
        return stq.issq_cwt(Tx, spec)

    def issq_stft(Tx):
        return stq.issq_stft(Tx, n_fft=n_fft)

    def ssqueeze_dwx(x):
        Wx, _, dWx = stq.cwt(x, wavelet=spec, scales=scales,
                             derivative=True)
        return stq.ssqueeze(Wx, dWx=dWx, gamma=gamma, scales=scales,
                            ssq_freqs=ssq_freqs, flipud=True)[0]

    routes = {
        'ssq_cwt': route(lambda x: stq.ssq_cwt(x, **kw)[0], issq_cwt,
                         {'cwt_bins', 'scatter_kv'}),
        'ssq_cwt_b4': route(lambda x: stq.ssq_cwt(x, **kw)[0], issq_cwt,
                            {'cwt_bins_batched', 'scatter_kv'}),
        'ssq_cwt_dwx': route(lambda x: stq.ssq_cwt(x, get_dWx=True,
                                                   **kw)[0], issq_cwt,
                             {'cwt_fused', 'ssq_fused'}),
        'ssq_cwt_getw': route(lambda x: stq.ssq_cwt(x, get_w=True, **kw)[0],
                              issq_cwt, {'cwt_fused', 'shift_scatter'}),
        'cwt': route(lambda x: stq.cwt(x, wavelet=spec, scales=scales)[0],
                     lambda Wx: stq.icwt(Wx, spec, scales=scales),
                     {'cwt_fused'}),
        'ssq_cwt2': route(lambda x: stq.ssq_cwt2(x, spec, scales=scales)[0],
                          issq_cwt, {'cwt_bins2', 'scatter_kv'}),
        'ssq_stft': route(lambda x: stq.ssq_stft(x, n_fft=n_fft)[0],
                          issq_stft, {'stft_conv', 'stft_conv_banded',
                                      'scatter_kv'}),
        'ssq_stft_hop8': route(
            lambda x: stq.ssq_stft(x, n_fft=n_fft, hop_len=8)[0],
            lambda Tx: Tx.real.sum(-2) * f_stft, {'ssq_fused'}, hop=8),
        'ssq_stft2': route(lambda x: stq.ssq_stft2(x, n_fft=n_fft)[0],
                           issq_stft, {'fsst2_conv', 'fsst2_conv_banded',
                                       'scatter_kv'}),
        'stft': route(lambda x: stq.stft(x, n_fft=n_fft),
                      lambda Sx: stq.istft(Sx, n_fft=n_fft, N=N),
                      {'stft_conv', 'stft_conv_banded'}),
        'ssqueeze_dwx': route(ssqueeze_dwx, issq_cwt,
                              {'cwt_fused', 'ssq_fused'}),
    }
    # the plain versions of the transforms, where the models reach them
    transforms = [(cwt_mod, 'cwt_fused', cwt_cuda.cwt_fused_plain),
                  (ssq_mod, 'cwt_bins', cwt_cuda.cwt_bins_plain),
                  (ssq_mod, 'cwt_fused', cwt_cuda.cwt_fused_plain),
                  (ssq2_mod, 'cwt_bins2', cwt_cuda.cwt_bins2_plain),
                  (ssq_stft_mod, 'stft_conv', stft_cuda.stft_conv_plain),
                  (ssq_stft_mod, 'fsst2_conv', stft_cuda.fsst2_conv_plain),
                  (stft_mod, 'stft_conv', stft_cuda.stft_conv_plain)]
    kernel = dict(kv=ssq_cuda.scatter_kv, fused=ssq_cuda.ssq_fused,
                  shift=ssq_cuda.shift_scatter)
    plain = dict(kv=ssq_cuda.scatter_kv_plain, fused=ssq_cuda.ssq_fused_plain,
                 shift=ssq_cuda.shift_scatter_plain)

    def fused_bins(Wx, dWx, params, gamma, flipud, Sfs):
        """The bins B4's backward gathers by: the plain bin map of its
        inputs (-1 where gated)."""
        k, valid = compute_bins(phase_transform_w(
            Wx.detach(), dWx.detach(), gamma, Sfs), params, flipud)
        return torch.where(valid, k, torch.full_like(k, -1))

    class Counted:
        """`fn` under the wrapper's name, its attributes (the launch
        counts) those of `wrapper`: a kernel wrapper counts its launches
        on the module name it is reached by."""
        def __init__(self, fn, wrapper):
            object.__setattr__(self, 'fn', fn)
            object.__setattr__(self, 'wrapper', wrapper)

        def __call__(self, *a, **k):
            return self.fn(*a, **k)

        def __getattr__(self, name):
            return getattr(self.wrapper, name)

        def __setattr__(self, name, value):
            setattr(self.wrapper, name, value)

    def scatters(mode, log):
        """The scatter wrappers, where the models reach them, for `mode`:
        'kernel' (the kernels) and 'plain' (the plain versions), each
        appending to `log` the bins it scatters by (B4: those its backward
        gathers by); 'pinned' (the plain versions on the bins of `log`, in
        call order)."""
        replay = iter(list(log)) if mode == 'pinned' else None
        use = kernel if mode == 'kernel' else plain

        def kv(Wx, k, const, nbins):
            if replay is not None:
                k = next(replay)
            else:
                log.append(k)
            return use['kv'](Wx, k, const, nbins)

        def fused(Wx, dWx, const, params, gamma, flipud, Sfs=None):
            if replay is not None:
                return plain['kv'](Wx, next(replay), const,
                                   params['omax'] + 1)
            log.append(fused_bins(Wx, dWx, params, gamma, flipud, Sfs))
            return use['fused'](Wx, dWx, const, params, gamma, flipud, Sfs)

        def shift(v, k, valid, nbins, const=None):
            if replay is not None:
                k, valid = next(replay)
            else:
                log.append((k, valid))
            return use['shift'](v, k, valid, nbins, const)
        kv, fused, shift = (Counted(f, kernel[n]) for f, n in (
            (kv, 'kv'), (fused, 'fused'), (shift, 'shift')))
        return ([(m, 'scatter_kv', kv) for m in (ssq_mod, ssq2_mod,
                                                 ssq_stft_mod)]
                + [(m, 'ssq_fused', fused) for m in (ssq_mod, ssq_stft_mod,
                                                     ssq_cuda)]
                + [(ssq_cuda, 'shift_scatter', shift)])

    def swapped(swaps, fn):
        """fn() with the module attributes of `swaps` replaced."""
        saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
        try:
            for m, n, f in swaps:
                setattr(m, n, f)
            return fn()
        finally:
            for m, n, f in reversed(saved):
                setattr(m, n, f)

    def differ(log_a, log_b):
        """Cells whose bins differ between two logs of one route."""
        n = 0
        for a, b in zip(log_a, log_b):
            if isinstance(a, tuple):
                n += int(((a[0] != b[0]) | (a[1] != b[1])).sum())
            else:
                n += int((a != b).sum())
        return n

    def loss(kind, out, y):
        plane, rec, hop = out
        if kind == 'sq':
            return (plane.real ** 2 + plane.imag ** 2).sum()
        return ((rec - y[..., ::hop]) ** 2).mean()

    launches = dict.fromkeys((n for n, _, _ in counters), 0)
    for name, (fwd, need) in routes.items():
        src = xb_np if name.endswith('_b4') else x_np
        x = torch.as_tensor(src, device=dev).requires_grad_()
        # the reconstruction's target: half the signal (a target the
        # inverse does not reach exactly, so that its gradient is not
        # rounding noise)
        y = (0.5 * x).detach()
        fwd(x)                                  # plan memo, first launch
        for kind in ('rec', 'sq'):
            x.grad = None
            log_k, log_p = [], []
            out, counts = launches_of(counters, lambda: swapped(
                scatters('kernel', log_k), lambda: fwd(x)))
            moved = {k for k, v in counts.items() if v}
            check(moved == need, "grad %s: the forward launched %s (needs "
                  "exactly %s)" % (name, sorted(moved), sorted(need)))
            if kind == 'rec':
                for k, v in counts.items():
                    launches[k] += v
            fn_name = type(out[0].grad_fn).__name__
            check(fn_name.endswith('GradBackward'), "grad %s: the output's "
                  "grad_fn is a kernel's Function (%s)" % (name, fn_name))
            _, counts = launches_of(
                counters, lambda: loss(kind, out, y).backward())
            check(not any(counts.values()), "grad %s, %s loss: the "
                  "backward launched no kernel" % (name, kind))
            g_k, plane_k = x.grad, out[0].detach()
            del out
            x.grad = None
            swapped(transforms + scatters('plain', log_p),
                    lambda: loss(kind, fwd(x), y).backward())
            g_p = x.grad
            err = rel_err(g_k, g_p)
            flips = differ(log_k, log_p)
            if kind == 'rec':
                check(bool(torch.isfinite(g_k).all()) and float(
                    g_p.abs().max()) > 0 and err <= 1e-4, "grad %s, "
                    "reconstruction loss: x.grad through the kernels %.3g "
                    "of max vs through the plain versions (1e-4; %d cells' "
                    "bins differ)" % (name, err, flips))
            else:
                # sum |out|^2 is piecewise in the bins: its cotangent 2 Tx
                # and the cell each gradient reads follow each cell's bin,
                # and the kernel and the plain bin map place a few cells
                # apart (B4's backward also maps its own bins, as the JAX
                # package's VJP does). So the plain versions run at the
                # kernel route's state: on the bins its scatters used,
                # with its cotangent 2 Tx; on their own bins and Tx the
                # difference is printed
                x.grad = None

                def pinned():
                    plane = fwd(x)[0]
                    (2 * (plane_k.real * plane.real + plane_k.imag
                          * plane.imag)).sum().backward()
                swapped(transforms + scatters('pinned', log_k), pinned)
                err_pin = rel_err(g_k, x.grad)
                cells = sum(int(np.prod(tuple((a[0] if isinstance(a, tuple)
                                                else a).shape)))
                            for a in log_k)
                check(bool(torch.isfinite(g_k).all()) and float(
                    g_p.abs().max()) > 0 and err_pin <= 2e-3, "grad %s, "
                    "sum |out|^2: x.grad through the kernels %.3g of max vs "
                    "through the plain versions at the kernel route's bins "
                    "and Tx (2e-3); on their own %.3g (%d of %d cells' bins "
                    "differ)" % (name, err_pin, err, flips, cells))
            del g_k, g_p, plane_k, log_k, log_p
        x.grad = None
        torch.backends.cuda.cufft_plan_cache.clear()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated() / 1e9
        fwd_ms, fwd_peak = host_ms(lambda: fwd(x))

        def step():
            x.grad = None
            loss('rec', fwd(x), y).backward()
        step_ms, step_peak = host_ms(step)
        print("grad %s at %s: forward %.3f ms (x requiring grad; peak %.3f "
              "GB above the %.3f held), forward + backward %.3f ms (peak "
              "%.3f GB above), backward's share %.1f%% (host clock, mean of "
              "10 after warm-up); card: %s"
              % (name, tuple(x.shape), fwd_ms, fwd_peak - base, base,
                 step_ms, step_peak - base,
                 100 * (step_ms - fwd_ms) / step_ms, card), flush=True)
        del x, y
        torch.cuda.empty_cache()

    # the framed STFT (hop 8) on the batch: each row bit-identical to its
    # signal transformed alone (its frames are rows transformed along
    # their last axis)
    xb = torch.as_tensor(xb_np, device=dev)
    Sb = stq.stft(xb, n_fft=n_fft, hop_len=8)
    same = [bool(torch.equal(Sb[b], stq.stft(xb[b], n_fft=n_fft,
                                              hop_len=8)))
            for b in range(len(xb_np))]
    check(all(same), "framed stft (hop 8) on %s: each row bit-identical "
          "to its one-signal call (%s)" % (tuple(xb.shape), same))
    del Sb, xb
    print("grad section: forward launches %s"
          % {k: v for k, v in launches.items() if v}, flush=True)
    return launches


def _parallel_rank(rank, world, N):
    """Section 12e (b): one rank of a world of 2 or 4 spawned on this card
    under gloo with CUDA tensors. Runs the mesh shapes (1, 2), (2, 1), the
    time mesh (1, 2) and the STFT rows (world 2), or (2, 2), the time mesh
    (1, 4) and the three-axis (1, 2, 2) (world 4), each on the global
    (2, N) and gathered, and a heartbeat; rank 0 holds each against the
    one-device call on this card with the CPU tests' tolerances. Returns
    rank 0's {check: (value, limit)}."""
    import torch
    import ssqueezepy_tpu_torch as stq
    from ssqueezepy_tpu_torch import parallel as par

    g32 = ('gmw', {'dtype': 'float32'})
    x = np.random.default_rng(20).standard_normal((2, N)).astype(np.float32)
    lead = rank == 0
    out = {}

    def rel(a, b, m=0):
        if m:
            a, b = a[..., m:-m], b[..., m:-m]
        return float((a - b).abs().max() / b.abs().max())

    def hold(name, T, W, T1, W1, m=0, w_lim=1e-5):
        """Wx (Sx) within `w_lim` of max, Tx by its column sums within 1e-4
        of max (5e-3 for the time plans: `m` columns trimmed each side)
        and its energy within 5e-3."""
        if not lead:
            return
        if W is not None:
            out[name + ' Wx'] = (rel(W, W1, m), w_lim)
        c = float((T.sum(-2) - T1.sum(-2))[..., m:N - m].abs().max()
                  / T1.abs().max())
        out[name + ' Tx column sums'] = (c, 1e-4 if not m else 5e-3)
        e, e1 = float(T.abs().sum()), float(T1.abs().sum())
        out[name + ' Tx energy'] = (abs(e - e1) / e1, 5e-3)

    T1, W1, *_ = stq.ssq_cwt(x, g32, scales='log', nv=16)
    for b, s in (((1, 2), (2, 1)) if world == 2 else ((2, 2),)):
        mesh = par.make_mesh(batch=b, scale=s, device_type='cuda')
        p = par.ShardedSSQCWT(N, g32, 'log', nv=16, mesh=mesh)
        hold('ShardedSSQCWT %dx%d' % (b, s), *p.gather(*p(x)), T1, W1)
    tmesh = par.make_mesh_time(batch=1, time=world, device_type='cuda')
    p = par.TimeShardedSSQCWT(N, g32, 'log', nv=16, mesh=tmesh)
    Tt, Wt, _ = p.gather(*p(x))
    hold('TimeShardedSSQCWT 1x%d' % world, Tt, Wt, T1, W1, 256, 5e-3)
    if world == 2:
        mesh = par.make_mesh(batch=1, scale=2, device_type='cuda')
        p = par.ShardedSSQSTFT(N, n_fft=256, mesh=mesh, dtype='float32')
        Ts1, Ss1, *_ = stq.ssq_stft(x, n_fft=256, dtype='float32')
        hold('ShardedSSQSTFT 1x2', *p.gather(*p(x)), Ts1, Ss1)
    else:
        m3 = par.make_mesh3(batch=1, scale=2, time=2, device_type='cuda')
        p = par.FullShardedSSQCWT(N, g32, 'log', nv=16, mesh=m3)
        T3, = p.gather(p(x))
        hold('FullShardedSSQCWT 1x2x2', T3, None, T1, None, 256)
    ok, dt = par.collective_heartbeat(par.make_mesh(device_type='cuda'),
                                      timeout=60.)
    out['heartbeat missed'] = (0. if ok else 1., 0.5)
    return out if lead else None


def parallel_section(stq, dev, card, counters, xb_np, spec, scales, n_fft):
    """Section 12e: the multi-rank layer (`ssqueezepy_tpu_torch/parallel/`).
    (a) A world of one under NCCL on this card at the headline: each plan
    on the (4, 160000) batch, the counters zeroed just before it, held
    against the one-device call on the same batch (bit-identical: the same
    launches on the same inputs; the time plan, whose window differs, by
    the time tolerances), timed beside it (CUDA events) with the
    all_reduce's time and the peak. (b) Worlds of 2 and 4 ranks spawned on
    this card under gloo with CUDA tensors (`_parallel_rank`). Returns
    (a)'s launches per counter."""
    import torch
    import torch.distributed as dist
    from ssqueezepy_tpu_torch import parallel as par
    from ssqueezepy_tpu_torch.parallel.collectives import psum
    from ssqueezepy_tpu_torch.parallel.distributed import spawn

    N = xb_np.shape[-1]
    xb = torch.as_tensor(xb_np, device=dev)
    rank, world = par.init_distributed(backend='nccl', device_type='cuda')
    check((rank, world, dist.get_backend()) == (0, 1, 'nccl'),
          "parallel (a): a world of one under NCCL (rank %d of %d, %s)"
          % (rank, world, dist.get_backend()))
    mesh = par.make_mesh(device_type='cuda')
    tmesh = par.make_mesh_time(device_type='cuda')
    kw = dict(wavelet=spec, scales=scales, nv=None)
    plans = {
        'ShardedSSQCWT': (
            par.ShardedSSQCWT(N, spec, scales, nv=None, mesh=mesh),
            lambda: stq.ssq_cwt(xb, **kw)[:2],
            {'cwt_bins_batched', 'scatter_kv'}),
        'ShardedSSQSTFT': (
            par.ShardedSSQSTFT(N, n_fft=n_fft, mesh=mesh, dtype='float32'),
            lambda: stq.ssq_stft(xb, n_fft=n_fft)[:2],
            {'stft_conv_batched', 'stft_conv_batched_banded', 'scatter_kv'}),
        'ShardedSSQSTFT2': (
            par.ShardedSSQSTFT2(N, n_fft=n_fft, mesh=mesh, dtype='float32'),
            lambda: stq.ssq_stft2(xb, n_fft=n_fft)[:2],
            {'fsst2_conv_batched', 'fsst2_conv_batched_banded',
             'scatter_kv'}),
        'ShardedSSQCWT2': (
            par.ShardedSSQCWT2(N, spec, scales, nv=None, mesh=mesh),
            lambda: stq.ssq_cwt2(xb, **kw)[:2],
            {'cwt_bins2_batched', 'scatter_kv'}),
        'sharded_cwt': (
            lambda x: par.sharded_cwt(x, spec, scales, nv=None,
                                      mesh=mesh)[:1],
            lambda: stq.cwt(xb, spec, scales=scales)[:1], {'cwt_fused'}),
    }
    # the time plan: B3 on its interior rows (n_up of the extended chunk,
    # the mixed engine unless a power of two) and on its exact rows (the
    # global window), then B4
    tp = par.TimeShardedSSQCWT(N, spec, scales, nv=None, mesh=tmesh)
    need = {'ssq_fused'}
    for n_up, rows in ((tp.n_up, tp._mid), (tp.g_nup, tp._exact)):
        if len(rows):
            need.add('cwt_fused' + ('' if n_up & (n_up - 1) == 0
                                    else '_mixed'))
    plans['TimeShardedSSQCWT'] = (
        tp, lambda: stq.ssq_cwt(xb, get_dWx=True, **kw), need)
    launches = {}
    for name, (plan, one, need) in plans.items():
        out, got = launches_of(counters, lambda: plan(xb))
        ran = {k for k, v in got.items() if v}
        check(ran == need, "parallel (a) %s on %s launches exactly %s (%s)"
              % (name, tuple(xb.shape), sorted(need),
                 {k: v for k, v in got.items() if v}))
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        ref = one()
        if name == 'TimeShardedSSQCWT':
            T, W, dW = out
            T1, W1 = ref[0], ref[1]
            m = 256
            c = float((T.sum(-2) - T1.sum(-2))[..., m:-m].abs().max()
                      / T1.abs().max())
            w = rel_err(W[..., m:-m], W1[..., m:-m])
            check(c < 5e-3 and w < 5e-3, "parallel (a) %s (n_up %d, halo "
                  "%d, exact rows %d): Tx column sums %.3g, Wx %.3g of max "
                  "on columns [%d, N - %d) of the one-device get_dWx call "
                  "(time tolerances 5e-3)" % (name, tp.n_up, tp.halo,
                                             tp.n_lo + len(scales) - tp.n_hi,
                                             c, w, m, m))
        else:
            same = [bool(torch.equal(a, b)) for a, b in zip(out, ref)]
            check(all(same), "parallel (a) %s: every output bit-identical "
                  "to the one-device call on the batch (%s)" % (name, same))
        if name == 'ShardedSSQCWT':
            Tx, Wx = out
        del out, ref
    # the inverses, on (a)'s shards (a world of one: the whole planes)
    for name, sharded, one in (
            ('sharded_icwt', lambda: par.sharded_icwt(
                Wx, spec, scales=scales, mesh=mesh),
             lambda: stq.icwt(Wx, spec, scales=scales)),
            ('sharded_issq_cwt', lambda: par.sharded_issq_cwt(
                Tx, spec, mesh=mesh), lambda: stq.issq_cwt(Tx, spec))):
        xr, got = launches_of(counters, sharded)
        x1 = one()
        e = float(np.abs(xr - x1).max() / np.abs(x1).max())
        check(e < 1e-5 and not any(got.values()),
              "parallel (a) %s: %.3g of max from the one-device inverse, no "
              "kernel launched" % (name, e))

    # times: each plan and its one-device call in turns (CUDA events), the
    # all_reduce of Tx alone, the peak above what the script holds
    for name, (plan, one, _) in plans.items():
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: plan(xb), reps=5)
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        one_ms = cuda_ms(one, reps=5)
        ms2 = cuda_ms(lambda: plan(xb), reps=5)
        one_ms2 = cuda_ms(one, reps=5)
        print("parallel (a) %s on %s, a world of one under NCCL: %.3f, "
              "%.3f ms; the one-device call %.3f, %.3f ms (CUDA events, "
              "mean of 5 after 2 warm-up, in turns); peak %.3f GB above the "
              "%.3f GB held; card: %s"
              % (name, tuple(xb.shape), ms, ms2, one_ms, one_ms2, peak,
                 base / 1e9, card), flush=True)
    ar_ms = cuda_ms(lambda: psum(Tx, mesh.get_group('scale')), reps=10)
    print("parallel (a) psum of Tx %s complex64 (%.3f GB) over 'scale', "
          "NCCL world of one: %.3f ms (CUDA events, mean of 10); card: %s"
          % (tuple(Tx.shape), Tx.numel() * 8 / 1e9, ar_ms, card), flush=True)
    del plans, tp, Tx, Wx
    dist.destroy_process_group()
    torch.cuda.empty_cache()

    # (b): worlds of 2 and 4 spawned on this card under gloo
    Nb = 32768
    for world in (2, 4):
        t0 = time.perf_counter()
        res = spawn(_parallel_rank, world, (Nb,), backend='gloo',
                    device_type='cuda', timeout=300.)[0]
        for what, (v, lim) in res.items():
            check(v < lim, "parallel (b) %d gloo ranks on this card, N=%d: "
                  "%s %.3g (limit %g)" % (world, Nb, what, v, lim))
        print("parallel (b) world of %d (gloo, CUDA tensors, one card): %.1f "
              "s with its spawn (a correctness run of a transport no "
              "deployment uses)" % (world, time.perf_counter() - t0),
              flush=True)
    print("parallel section: (a)'s launches %s"
          % {k: v for k, v in launches.items() if v}, flush=True)
    return launches


def prime_length_section(stq, dev, card, counters):
    """10b: `padtype=None` at lengths with a prime factor above 7 (2002 =
    2 7 11 13 and 160001, a prime), where the public calls take the
    general route (`cwt_general`, or `wsst2_general` for order 2) and then
    exactly B4 or B5, launching no CWT kernel. At 2002 each call (and a
    (4, 2002) batch) against the same call on the CPU; at 160001 each
    call's round trip on a chirp, timed beside the padded kernel route at
    160000. Returns the launches per kernel counter."""
    import torch
    from ssqueezepy_tpu_torch.models.cwt import cwt_general
    from ssqueezepy_tpu_torch.models.ssq_cwt2 import wsst2_general
    ctr = counters + [('cwt_general', cwt_general, 'calls'),
                      ('wsst2_general', wsst2_general, 'calls')]
    calls = {
        'ssq_cwt': (lambda x, **k: stq.ssq_cwt(x, **k),
                    {'cwt_general', 'ssq_fused'}),
        'ssq_cwt(get_w=True)': (
            lambda x, **k: stq.ssq_cwt(x, get_w=True, **k),
            {'cwt_general', 'shift_scatter'}),
        'ssq_cwt(get_dWx=True)': (
            lambda x, **k: stq.ssq_cwt(x, get_dWx=True, **k),
            {'cwt_general', 'ssq_fused'}),
        'cwt': (lambda x, **k: stq.cwt(x, **k), {'cwt_general'}),
        'ssq_cwt2': (lambda x, **k: stq.ssq_cwt2(x, **k),
                     {'wsst2_general', 'shift_scatter'}),
        'ssq_cwt2(get_w=True)': (
            lambda x, **k: stq.ssq_cwt2(x, get_w=True, **k),
            {'wsst2_general', 'shift_scatter'})}
    launches = {}

    kernel_names = {n for n, _, _ in counters}

    def counted(what, fn, need):
        out, counts = launches_of(ctr, fn)
        moved = {k: v for k, v in counts.items() if v}
        check(moved == dict.fromkeys(need, 1), "%s: the general route and "
              "exactly %s, no CWT kernel (%s)" % (what, sorted(need), moved))
        for k in kernel_names & set(moved):
            launches[k] = launches.get(k, 0) + moved[k]
        return out

    rng = np.random.default_rng(2002)
    x2002 = rng.standard_normal(2002).astype(np.float32)
    xb2002 = rng.standard_normal((4, 2002)).astype(np.float32)
    for name, (fn, need) in list(calls.items()) + [
            ('ssq_cwt on (4, 2002)', (calls['ssq_cwt'][0],
                                      {'cwt_general', 'ssq_fused'}))]:
        x = xb2002 if name.endswith('2002)') else x2002
        xd = torch.as_tensor(x, device=dev)
        out = counted("%s(padtype=None) at N=2002" % name,
                      lambda: fn(xd, padtype=None), need)
        ref = fn(x, padtype=None, device='cpu')
        iW = 0 if name == 'cwt' else 1
        err = rel_err(out[iW].cpu(), ref[iW])
        check(tuple(out[iW].shape) == tuple(ref[iW].shape) and err <= 1e-5,
              "%s(padtype=None) at N=2002: Wx %s, %.3g of max vs the CPU "
              "(limit 1e-5)" % (name, tuple(out[iW].shape), err))
        if name != 'cwt':
            bins_criterion(out[0].cpu(), ref[0], "%s(padtype=None) at "
                           "N=2002 vs the CPU" % name)
        del out, ref
    # N = 160001 (a prime): round trips of a chirp, and each call's time
    # beside the same call padded (reflect, n_up = 262144: the kernel
    # route) at N = 160000
    Np = 160001
    n = np.arange(Np)
    xc = np.cos(2 * np.pi * (0.02 * n + 0.3 / (2 * Np) * n ** 2)).astype(
        np.float32)
    xcd = torch.as_tensor(xc, device=dev)
    x160 = torch.as_tensor(xc[:160000], device=dev)
    inverse = {'cwt': lambda out: stq.icwt(out[0])}
    for name, (fn, need) in calls.items():
        out = counted("%s(padtype=None) at N=%d" % (name, Np),
                      lambda: fn(xcd, padtype=None), need)
        inv = inverse.get(name, lambda out: stq.issq_cwt(out[0]))
        mad = float(stq.toolkit.mad_rms(xc, inv(out)))
        check(bool(torch.isfinite(torch.view_as_real(out[0])).all())
              and out[0].shape[-1] == Np and mad < 0.1,
              "%s(padtype=None) at N=%d: round trip mad_rms = %.4g (< 0.1)"
              % (name, Np, mad))
        del out
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated() / 1e9
        ms, gb = host_ms(lambda: fn(xcd, padtype=None), reps=5, warm=1)
        ms_k, gb_k = host_ms(lambda: fn(x160), reps=5, warm=1)
        print("%s: general route at N=%d unpadded %.3f ms (peak %.3f GB "
              "above what the script holds); kernel route at N=160000 "
              "padded %.3f ms (peak %.3f GB); ratio %.2f (host clock, mean "
              "of 5 after warm-up); card: %s"
              % (name, Np, ms, gb - held, ms_k, gb_k - held, ms / ms_k,
                 card), flush=True)
        torch.cuda.empty_cache()
    return launches


def analysis_section(stq, dev, card, counters, x_np, spec, scales,
                     ssq_freqs):
    """The analysis layer at N = 160000: `extract_ridges` (two ridges) on
    the bench plan's `ssq_cwt` of a linear plus an exponential chirp from
    `TestSignals`, on exactly the ridge kernels, its ridges against the
    two known frequency laws; the ridge kernels against their plain
    versions on the first 8192 columns and at the full length (pe
    bit-identical, the indices equal), each timed at the full length
    beside its plain version and its bound; the forward's plan (cluster
    size, P in registers, trace rings), the forward also at 16 CTAs
    (bit-identical) and its per-column floor at F = 8;
    `experimental.phase_ssqueeze` from `ssq_cwt(get_dWx=True)`'s
    planes, on B5 alone, against `ssq_cwt(get_w=True)` by the bins
    criterion. Returns (the kernel rows, launches per counter)."""
    import ctypes
    import torch
    from ssqueezepy_tpu_torch.models.ridge_extraction import _normalized
    from ssqueezepy_tpu_torch.models.test_signals import (_law_exp,
                                                          _law_linear)
    from ssqueezepy_tpu_torch.ops import _build
    from ssqueezepy_tpu_torch.ops.ridge_cuda import (
        ridge_forward, ridge_forward_plain, ridge_plan, ridge_trace,
        ridge_trace_plain)
    N = 160000
    eps = float(np.finfo(np.float32).eps)
    ts = stq.TestSignals(N=N)
    f_lin, f_exp = (.0125 * N, .075 * N), (.125 * N, .375 * N)
    (x1, t), (x2, _) = ts.lchirp(N, *f_lin), ts.echirp(N, *f_exp)
    x = torch.as_tensor((x1 + x2).astype(np.float32), device=dev)
    Tx, _, sf = stq.ssq_cwt(x, wavelet=spec, scales=scales,
                            ssq_freqs=ssq_freqs)[:3]
    torch.cuda.synchronize()

    def run():
        return stq.extract_ridges(Tx, scales, penalty=2, n_ridges=2)
    run()                                     # first launches
    ridges, counts = launches_of(counters, run)
    moved = {k: v for k, v in counts.items() if v}
    check(moved == {'ridge_forward': 2, 'ridge_trace': 2}
          and ridges.shape == (N, 2),
          "extract_ridges(Tx, scales, penalty=2, n_ridges=2) at (%d, %d): "
          "exactly 2 forward + 2 trace launches (%s)"
          % (len(scales), N, moved))
    launches = {k: v for k, v in counts.items() if v}
    # each ridge against the nearer frequency law, cycles per sample, on
    # the interior 80% of columns
    dt = t[1] - t[0]
    laws = [law(t, 0, 1, *f)[1] / (2 * np.pi) * dt
            for law, f in ((_law_linear, f_lin), (_law_exp, f_exp))]
    lo, hi = N // 10, N - N // 10
    med = [[float(np.median(np.abs(sf[ridges[lo:hi, i]] / law[lo:hi] - 1)))
            for law in laws] for i in range(2)]
    errs = min((med[0][0], med[1][1]), (med[0][1], med[1][0]),
               key=lambda p: p[0] + p[1])
    check(max(errs) < 0.1, "extract_ridges on lchirp + echirp: median "
          "relative error of ssq_freqs[ridge] against the known laws %.4g "
          "(linear), %.4g (exponential) on the interior 80%% (< 0.1)"
          % errs)
    # the kernels against their plain versions on 8192 columns
    a = Tx.abs()
    E = (a * a)[None]
    del a
    v = torch.as_tensor(np.log(np.asarray(scales, np.float32)).reshape(-1),
                        device=dev)
    e8 = _normalized(E[..., :8192], eps, torch.float32)
    pe8, pe8_p = ridge_forward(e8, v, 2.), ridge_forward_plain(e8, v, 2.)
    r8, r8_p = ridge_trace(pe8, e8, v, 2., eps), ridge_trace_plain(
        pe8_p, e8, v, 2., eps)
    torch.cuda.synchronize()
    err_f = float((pe8 - pe8_p).abs().max())
    err_t = int((r8 - r8_p).abs().max())
    check(torch.equal(pe8, pe8_p) and torch.equal(r8, r8_p),
          "ridge kernels vs plain on (1, 8192, %d): pe bit-identical, "
          "indices equal (max |dpe| %.3g, max |dr| %d)"
          % (len(scales), err_f, err_t))
    # times at the full length: the kernels (CUDA events, 3 after one
    # warm-up) at the plan's cluster and at 16 CTAs, the per-column floor
    # (F = 8: a column's work negligible, the chain of one DSMEM store and
    # one cluster barrier), their plain versions (one run each) and the
    # public call
    e = _normalized(E, eps, torch.float32)
    F, T = e.shape[-1], e.shape[-2]
    plan, plan16 = ridge_plan(F, 4), ridge_plan(F, 4, clusters=16)
    occ = []
    for p in (plan, plan16):
        n = ctypes.c_int(0)
        _build.check(_build.load('ridge_dp').ridge_forward_clusters(
            4, p.clusters, int(p.resident), p.warps, p.forward_smem,
            ctypes.addressof(n)), 'ridge_forward_clusters')
        occ.append(n.value)
    print("ridge plan at F = %d float32: forward cluster of %d CTAs (%d rows "
          "each, %d warps, P %s, %d B of shared memory; %d such clusters fit "
          "the card at once; 16 CTAs: %d rows, P %s, %d fit), trace rings of "
          "%d pe and %d e slots of %d rows (%d B slots, %d B)"
          % (F, plan.clusters, plan.rows, plan.warps,
             'in registers' if plan.resident else 'recomputed',
             plan.forward_smem, occ[0], plan16.rows,
             'in registers' if plan16.resident else 'recomputed', occ[1],
             plan.trace_depth, plan.trace_e_depth, plan.trace_rows,
             plan.trace_slot, plan.trace_smem), flush=True)
    check(min(occ) >= 1 and plan.clusters >= 2, "ridge forward: a cluster of "
          "%d CTAs (and of 16) fits the card" % plan.clusters)
    fw_ms = cuda_ms(lambda: ridge_forward(e, v, 2.), reps=3, warm=1)
    fw16_ms = cuda_ms(lambda: ridge_forward(e, v, 2., plan=plan16), reps=3,
                      warm=1)
    pe = ridge_forward(e, v, 2.)
    check(torch.equal(ridge_forward(e, v, 2., plan=plan16), pe),
          "ridge forward at 16 CTAs bit-identical to %d CTAs at (1, %d, %d)"
          % (plan.clusters, T, F))
    ef = e[..., :8].contiguous()
    floor_ms = cuda_ms(lambda: ridge_forward(ef, v[:8], 2.), reps=3, warm=1)
    del ef
    tr_ms = cuda_ms(lambda: ridge_trace(pe, e, v, 2., eps), reps=3, warm=1)
    r = ridge_trace(pe, e, v, 2., eps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pe_p = ridge_forward_plain(e, v, 2.)
    torch.cuda.synchronize()
    fw_plain = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    r_p = ridge_trace_plain(pe, e, v, 2., eps)
    torch.cuda.synchronize()
    tr_plain = (time.perf_counter() - t0) * 1e3
    # the same kernels against the plain outputs at the main path's shape
    err_f = max(err_f, float((pe - pe_p).abs().max()))
    err_t = max(err_t, int((r - r_p).abs().max()))
    check(torch.equal(pe, pe_p) and torch.equal(r, r_p),
          "ridge kernels vs plain on (1, %d, %d): pe bit-identical, "
          "indices equal (max |dpe| %.3g, max |dr| %d)"
          % (T, F, err_f, err_t))
    del pe_p, r_p, r
    held = torch.cuda.memory_allocated() / 1e9
    e2e, gb = host_ms(run, reps=3, warm=1)
    gb -= held
    # bounds: the forward's min-plus pairs (an add and a min each) and its
    # bytes (e in, pe out); the trace's bytes (pe read once, e and the
    # index per column)
    fw_bound, fw_by = bound(2 * T * F * 4, 2 * (T - 1) * F * F)
    fl_bound, fl_by = bound(2 * T * 8 * 4, 2 * (T - 1) * 8 * 8)
    tr_bound, tr_by = bound(T * F * 4 + 2 * T * 4, 4 * T * F)
    print("ridge_forward at (1, %d, %d) float32: %.3f ms at %d CTAs per "
          "cluster (%.3f us per column; plain %.1f ms; bound %.3f ms by %s), "
          "%.3f ms at 16 CTAs (%.3f us per column); per-column floor at "
          "(1, %d, 8): %.3f ms (%.3f us per column; bound %.4f ms by %s); "
          "ridge_trace %.3f ms (%.3f us per column; plain %.1f ms; bound "
          "%.3f ms by %s); extract_ridges (2 ridges) %.1f ms end to end "
          "(host clock, mean of 3 after one warm-up), peak %.3f GB above "
          "what the script holds; card: %s"
          % (T, F, fw_ms, plan.clusters, fw_ms * 1e3 / (T - 1), fw_plain,
             fw_bound, fw_by, fw16_ms, fw16_ms * 1e3 / (T - 1), T, floor_ms,
             floor_ms * 1e3 / (T - 1), fl_bound, fl_by, tr_ms,
             tr_ms * 1e3 / (T - 1), tr_plain, tr_bound, tr_by, e2e, gb,
             card), flush=True)
    del E, e, pe, e8, pe8, pe8_p, Tx
    torch.cuda.empty_cache()
    # phase_ssqueeze from (Wx, dWx) against ssq_cwt(get_w=True)
    xn = torch.as_tensor(x_np, device=dev)
    kw = dict(wavelet=spec, scales=scales, ssq_freqs=ssq_freqs)
    out = stq.ssq_cwt(xn, get_dWx=True, **kw)
    Wx, dWx = out[1], out[4]
    del out

    def pssq():
        return stq.experimental.phase_ssqueeze(
            Wx, dWx, ssq_freqs=ssq_freqs, scales=scales, wavelet=spec,
            get_w=True, flipud=True)
    pssq()
    ps, counts = launches_of(counters, pssq)
    moved = {k: v for k, v in counts.items() if v}
    check(moved == {'shift_scatter': 1}, "experimental.phase_ssqueeze at "
          "(%d, %d): B5 alone (%s)" % (len(scales), N, moved))
    launches['shift_scatter'] = launches.get('shift_scatter', 0) + 1
    ref = stq.ssq_cwt(xn, get_w=True, **kw)
    bins_criterion(ps[0], ref[0], "phase_ssqueeze vs ssq_cwt(get_w=True)")
    del ps, ref
    held = torch.cuda.memory_allocated() / 1e9
    ms, gb = host_ms(pssq, reps=5, warm=1)
    print("experimental.phase_ssqueeze(Wx, dWx, get_w=True) at (%d, %d): "
          "%.3f ms (host clock, mean of 5), peak %.3f GB above what the "
          "script holds; card: %s" % (len(scales), N, ms, gb - held, card),
          flush=True)
    del Wx, dWx
    torch.cuda.empty_cache()
    rows = [
        dict(name='ridge_forward', route='cuda',
             source='ssqueezepy_tpu_torch/csrc/ridge_dp.cu',
             replaces='ssqueezepy_tpu/models/ridge_extraction.py:24',
             launches=launches['ridge_forward'], max_abs_err=err_f,
             ms=fw_ms, plain_ms=fw_plain, bound_ms=fw_bound,
             bound_by=fw_by, library_ms=None),
        dict(name='ridge_trace', route='cuda',
             source='ssqueezepy_tpu_torch/csrc/ridge_dp.cu',
             replaces='ssqueezepy_tpu/models/ridge_extraction.py:24',
             launches=launches['ridge_trace'], max_abs_err=err_t,
             ms=tr_ms, plain_ms=tr_plain, bound_ms=tr_bound,
             bound_by=tr_by, library_ms=None)]
    return rows, launches


def stage_ms(fn, reps=5, stages=('stft_stage1', 'stft_stage2')):
    """Device ms per call of a kernel's two launches (the STFT kernel's
    `stft_stage1`, `stft_stage2`; the CWT kernel's `bins_stage1`,
    `bins_stage2`) over `reps` calls of `fn` under `torch.profiler`, after
    one warm-up; {} where the profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import profile, ProfilerActivity
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, 'self_device_time_total',
                     getattr(ev, 'self_cuda_time_total', 0))
        if ev.device_type != DeviceType.CUDA or us <= 0:
            continue
        for stage in stages:
            if stage in ev.key:
                out[stage] = out.get(stage, 0.) + us / 1e3 / reps
    return out


def stage1_levels(klims, n_up):
    """Per row, the DFT levels (log2 of the length transformed) stage 1 of
    the CWT kernel runs with its rows pruned at `klims` (ops/cwt_cuda.py::
    support_klims). Radix-4 engine: from level j + 1 to lg f1, j >= 1 the
    largest with klim <= f1 / 2^j, and j = 1 where the Nyquist row is in
    (the first level's partner is zero above n_up/2 but there, and that
    level runs in registers). Mixed engine: log2(f1 / Ns), Ns the product
    of the leading radices with klim <= f1 / Ns (`dft_mixed.cuh`'s
    radices, the passes that only copy)."""
    from ssqueezepy_tpu_torch.ops.cwt_cuda import four_step
    from ssqueezepy_tpu_torch.ops.stft_cuda import radices
    f1 = four_step(n_up)[0]
    out = []
    for kl in np.asarray(klims).ravel():
        if n_up & (n_up - 1) == 0:
            lg1 = f1.bit_length() - 1
            j = 1
            while kl <= f1 // 2 and j < lg1 and kl <= f1 >> (j + 1):
                j += 1
            out.append(lg1 - j)
        else:
            Ns = 1
            for R, n in radices(f1):
                if kl * R > f1 // n:
                    break
                Ns = n * R
            out.append(np.log2(f1 / Ns))
    return np.array(out, float)


def prune_section(stq, dev, card, x_np, xb_np, scales, params):
    """Section 12h: stage-1 support pruning of the CWT kernel at the
    headline (the bench's 293 scales, N = 160000): the support plan
    (rows kept, klim quantiles, the stage-1 levels run per row), then
    each mode pruned (the public calls' launch) and unpruned (the private
    hook `klims`, rows0 in every row): B1, B3 with one and two planes, B3b
    on the (4, 160000) batch, B8 and its w2 mode on the radix-4 engine
    (n_up = 262144), B1 and B8 unpadded on the mixed engine (n_up =
    160000), and B1 with cmhat from its table at cmhat's own scales. Each
    pair bit-identical but for the sign of zero cells (their count
    printed), timed in turns (unpruned, pruned, pruned, unpruned; CUDA
    events) and its two launches under the profiler (`bins_stage1`,
    `bins_stage2`). Returns {mode: numbers}."""
    import torch
    from ssqueezepy_tpu_torch.models.cwt import resolve_wavelet
    from ssqueezepy_tpu_torch.ops import cwt_cuda as cc
    from ssqueezepy_tpu_torch.ops.fft import rfft
    from ssqueezepy_tpu_torch.ops.pad import pad_params, padsignal
    t0 = time.perf_counter()
    N = x_np.shape[-1]
    gamma = 10 * float(np.finfo(np.float32).eps)
    wv = resolve_wavelet(('gmw', {'dtype': 'float32'}), N=N)
    cm = resolve_wavelet(('cmhat', {'dtype': 'float32'}), N=N)
    sc = torch.as_tensor(np.ravel(scales), dtype=torch.float32, device=dev)
    sc_cm = torch.as_tensor(np.ravel(stq.process_scales(
        'log-piecewise', N, cm)[:300]), dtype=torch.float32, device=dev)
    n_up, n1, _ = pad_params(N, 'reflect')
    x = torch.as_tensor(x_np, device=dev)
    xh = rfft(padsignal(x, 'reflect')).contiguous()
    xhb = rfft(padsignal(torch.as_tensor(xb_np, device=dev),
                         'reflect')).contiguous()
    xhm = rfft(x).contiguous()
    for what, n in (('radix-4', n_up), ('mixed', N)):
        k = cc.support_klims(wv, np.ravel(scales), n, 'float32')
        rows0 = cc.stage1_rows(n)
        lv = ("; stage 1 runs %.2f DFT levels per row on average, "
              "against %d unpruned" % (stage1_levels(k, n).mean(),
                                       cc.four_step(n)[0].bit_length() - 2)
              if what == 'radix-4' else "")
        print("support plan, %s engine at n_up=%d=%dx%d: %d scales, rows0 "
              "%d, %.1f%% of the rows kept, klim quantiles 10/25/50/75/90%% "
              "%s, %d scales on row 0 alone%s"
              % ((what, n) + cc.four_step(n) + (len(k), rows0,
                 100 * k.sum() / (len(k) * rows0),
                 '/'.join('%d' % q for q in np.quantile(
                     k, [.1, .25, .5, .75, .9])), int((k == 1).sum()), lv)),
              flush=True)
    bins = (True, params, gamma, True)
    cases = [
        ('B1', cc.cwt_bins, cc._OUT_BINS, xh, sc, wv, n_up, n1, bins, {}),
        ('B3 Wx only', cc.cwt_fused, cc._OUT_W, xh, sc, wv, n_up, n1,
         (True,), {}),
        ('B3 Wx + dWx', cc.cwt_fused, cc._OUT_W_DW, xh, sc, wv, n_up, n1,
         (True,), {}),
        ('B3b', cc.cwt_bins, cc._OUT_BINS, xhb, sc, wv, n_up, n1, bins, {}),
        ('B8', cc.cwt_bins2, cc._OUT_BINS2, xh, sc, wv, n_up, n1, bins, {}),
        ('B8 w2', cc.cwt_w2, cc._OUT_W2, xh, sc, wv, n_up, n1, (True,),
         dict(gamma=gamma)),
        ('mixed B1', cc.cwt_bins, cc._OUT_BINS, xhm, sc, wv, N, 0, bins, {}),
        ('mixed B8', cc.cwt_bins2, cc._OUT_BINS2, xhm, sc, wv, N, 0, bins,
         {}),
        ('B1 cmhat table', cc.cwt_bins, cc._OUT_BINS, xh, sc_cm, cm, n_up,
         n1, bins, {})]
    out = {}
    for name, wrapper, mode, z, s, w, nu, n1e, args, kw in cases:
        full = torch.full(s.shape, cc.stage1_rows(nu), dtype=torch.int32,
                          device=dev)

        def run(klims=None, z=z, s=s, w=w, nu=nu, n1e=n1e, args=args,
                kw=kw, wrapper=wrapper, mode=mode):
            return cc._launch(wrapper, mode, z, s, w, nu, n1e, N, 1., *args,
                              klims=klims, **kw)
        pruned, unpruned = run(), run(full)
        torch.cuda.synchronize()
        signs = 0
        for a, b in zip(pruned, unpruned):
            if a is None:
                continue
            if a.is_complex():
                a, b = torch.view_as_real(a), torch.view_as_real(b)
            same = torch.equal(a, b)
            if not same and a.is_floating_point():
                ib = torch.int32 if a.element_size() == 4 else torch.int64
                differ = a.view(ib) != b.view(ib)
                same = bool((a == b).all() and (a[differ] == 0).all())
                signs += int(differ.sum())
            check(same, "pruned %s: bit-identical to unpruned stage 1 but "
                  "for the sign of zero cells" % name)
        del pruned, unpruned
        torch.cuda.empty_cache()
        t = [cuda_ms(f) for f in (lambda: run(full), run, run,
                                  lambda: run(full))]
        row = dict(ms=(t[1] + t[2]) / 2, ms_full=(t[0] + t[3]) / 2,
                   signs=signs,
                   stages=stage_ms(run, 3, ('bins_stage1', 'bins_stage2')),
                   stages_full=stage_ms(lambda: run(full), 3,
                                        ('bins_stage1', 'bins_stage2')))
        st = lambda d: ("stage 1 %.3f + stage 2 %.3f ms"
                        % (d['bins_stage1'], d['bins_stage2'])
                        if {'bins_stage1', 'bins_stage2'} <= set(d)
                        else "stages not measured (no device time in the "
                        "profile)")
        print("pruned %s at %s, n_up=%d: %.3f ms pruned vs %.3f ms "
              "unpruned (CUDA events, in turns); pruned %s, unpruned %s "
              "(profiler); %d cells differ in the sign of a zero; card: %s"
              % (name, tuple(z.shape[:-1]) + (s.shape[0], N), nu, row['ms'],
                 row['ms_full'], st(row['stages']), st(row['stages_full']),
                 signs, card), flush=True)
        out[name] = row
        torch.cuda.empty_cache()
    cc._TABLES.clear()
    torch.cuda.empty_cache()
    print("prune section: %.1f s" % (time.perf_counter() - t0), flush=True)
    return out


def band_section(stq, dev, card, x_np, xb_np, n_fft):
    """Section 12g: the band plan of B6/B7 at the headline (N = 160000,
    n_fft = 598) and on the (4, 160000) batch. Prints the bands (br of f1)
    and the tables' MB, banded and full; holds every mode (B6 0-2, B7 3-4)
    on banded tables against its banded plain version (2e-5 of max, k
    flips <= 1%, Tx by the bins criterion, w2's inf cells but 0.1%), the
    batch's rows bit-identical to their spectra launched alone, B7's V
    bit-identical to B6's Sx with the bank's first table on the bank's
    band; times each mode banded and full in turns (CUDA events) and its
    two launches under the profiler (stage 1 and stage 2, banded against
    full); and the peaks of `stft`, `ssq_stft` and `ssq_stft2` with the
    band on and off. Returns {(mode, shape): numbers} for the `kernels`
    line."""
    import torch
    from ssqueezepy_tpu_torch.configs import configure
    from ssqueezepy_tpu_torch.models.ssq_stft import fsst2_plan, stft_plan
    from ssqueezepy_tpu_torch.models.stft import signal_spectrum
    from ssqueezepy_tpu_torch.ops import stft_conv as tabs
    from ssqueezepy_tpu_torch.ops.ssq_cuda import scatter_kv_plain
    from ssqueezepy_tpu_torch.ops.ssq_kernels import compute_bins
    from ssqueezepy_tpu_torch.ops.stft_cuda import (
        BandedTable, fsst2_conv, fsst2_conv_plain, fsst2_rows, fsst2_w,
        split_fft_len, stft_conv, stft_conv_plain)
    n_rows = n_fft // 2 + 1
    sp = stft_plan(None, None, n_fft, n_fft, 1., 'float32')
    fp = fsst2_plan(None, None, n_fft, n_fft, 1., 'float32')
    bins = dict(Sfs=torch.as_tensor(sp.Sfs, device=dev), params=sp.params,
                flipud=False, gamma=10 * float(np.finfo(np.float32).eps))
    c = torch.full((n_rows,), sp.const, dtype=torch.float32, device=dev)
    nb = sp.params['omax'] + 1
    names = {0: 'B6 Sx', 1: 'B6 Sx + dSx', 2: 'B6 bins', 3: 'B7 FSST2',
             4: 'B7 w2'}

    N = x_np.shape[-1]

    def run(mode, xh, H, Hd, B, plain=False):
        if mode <= 2:
            fn = stft_conv_plain if plain else stft_conv
            return fn(xh, H, None if mode == 0 else Hd, N, 1.,
                      bins if mode == 2 else None)
        if mode == 3:
            return (fsst2_conv_plain if plain else fsst2_conv)(xh, B, N, 1.,
                                                               bins)
        return (fsst2_rows if plain else fsst2_w)(xh, B, N, 1., bins['Sfs'],
                                                  bins['gamma'])

    out = {}
    for shape, xs in (('one', x_np), ('b4', xb_np)):
        xh = signal_spectrum(torch.as_tensor(xs, dtype=torch.float32,
                                             device=dev), n_fft, 'reflect')
        Np2 = xh.shape[-1]
        f1, f2 = split_fft_len(Np2)
        H, Hd = tabs.stft_tables(sp.window, sp.diff_window, n_fft, Np2,
                                 True, 'float32', dev)
        B = tabs.fsst2_tables(fp.bank, n_fft, Np2, True, 'float32', dev)
        check(all(isinstance(t, BandedTable) for t in (H, Hd, B))
              and H.br <= f1 // 2 and B.br <= f1 // 2,
              "band plan at Np2=%d=%dx%d: pair br=%d, bank br=%d of f1=%d "
              "(band starts 8-aligned: %s)"
              % (Np2, f1, f2, H.br, B.br, f1,
                 bool((H.r0_host % 8 == 0).all())))
        Hf = tabs.conv_table(sp.window, n_fft, Np2, True, 'float32', dev)
        Hdf = tabs.conv_table(sp.diff_window, n_fft, Np2, True, 'float32',
                              dev)
        Bf = tabs.conv_bank(fp.bank, n_fft, Np2, True, 'float32', dev)
        if shape == 'one':
            mb = lambda *ts: sum(t.numel() * t.element_size()
                                 for t in ts) / 1e6
            print("band plan tables at n_fft=%d, Np2=%d: pair %.1f MB "
                  "banded (br=%d) vs %.1f MB full; bank %.1f MB banded "
                  "(br=%d) vs %.1f MB full; card: %s"
                  % (n_fft, Np2, mb(H.t, Hd.t), H.br, mb(Hf, Hdf),
                     mb(B.t), B.br, mb(Bf), card), flush=True)
        # the bank's band over its first table: B7's V is B6's Sx there
        V = run(3, xh, H, Hd, B)[0]
        check(torch.equal(V, stft_conv(xh, B.plane(0), None, N)[0]),
              "banded B7 %s: V bit-identical to banded B6's Sx with the "
              "bank's first table on the bank's band" % shape)
        del V
        for mode in range(5):
            what = "banded %s %s" % (names[mode], shape)
            o_k = run(mode, xh, H, Hd, B)
            torch.cuda.synchronize()
            o_p = run(mode, xh, H, Hd, B, plain=True)
            err = rel_err(o_k[0], o_p[0])
            check(err <= 2e-5, "%s: %.3g of max vs its banded plain "
                  "version (limit 2e-5)" % (what, err))
            row = dict(err=float((o_k[0] - o_p[0]).abs().max()))
            if mode == 1:
                e1 = rel_err(o_k[1], o_p[1])
                check(e1 <= 2e-5, "%s: dSx %.3g of max (limit 2e-5)"
                      % (what, e1))
            if mode == 4:
                inf = float((torch.isinf(o_k[1]) != torch.isinf(o_p[1]))
                            .double().mean())
                check(inf <= 1e-3, "%s: w2's inf cells differ on %.4f%% "
                      "(limit 0.1%%)" % (what, 100 * inf))
                k_k, k_p = (torch.where(v, k, -1) for k, v in (
                    compute_bins(w, sp.params, False)
                    for w in (o_k[1], o_p[1])))
            elif mode >= 2:
                k_k, k_p = o_k[1], o_p[1]
            if mode >= 2:
                flips = float((k_k != k_p).double().mean())
                check(flips <= 0.01, "%s: bins differ on %.4f%% of cells "
                      "(limit 1%%)" % (what, 100 * flips))
                bins_criterion(scatter_kv_plain(o_k[0], k_k, c, nb),
                               scatter_kv_plain(o_p[0], k_p, c, nb), what)
                del k_k, k_p
            if shape == 'b4':
                same = all(torch.equal(a[b], a1) for b in range(len(xs))
                           for a, a1 in zip(o_k, run(
                               mode, xh[b].contiguous(), H, Hd, B))
                           if a is not None)
                check(same, "%s: each row bit-identical to its spectrum "
                      "launched alone" % what)
            del o_k, o_p
            torch.cuda.empty_cache()
            # banded against full, in turns (full, banded, banded, full)
            kb = lambda m=mode: run(m, xh, H, Hd, B)
            kf = lambda m=mode: run(m, xh, Hf, Hdf, Bf)
            t = [cuda_ms(f) for f in (kf, kb, kb, kf)]
            row['ms'], row['ms_full'] = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
            row['stages'], row['stages_full'] = stage_ms(kb), stage_ms(kf)
            if mode >= 2:
                row['plain_ms'] = cuda_ms(
                    lambda m=mode: run(m, xh, H, Hd, B, plain=True),
                    reps=2, warm=1)
            st = lambda d: ("stage 1 %.3f + stage 2 %.3f ms"
                            % (d['stft_stage1'], d['stft_stage2'])
                            if {'stft_stage1', 'stft_stage2'} <= set(d)
                            else "stages not measured (no device time in "
                            "the profile)")
            print("%s at %s: %.3f ms banded (br=%d) vs %.3f ms full "
                  "(CUDA events, in turns); banded %s, full %s "
                  "(profiler); card: %s"
                  % (what, tuple(xh.shape[:-1]) + (n_rows, N), row['ms'],
                     B.br if mode >= 3 else H.br, row['ms_full'],
                     st(row['stages']), st(row['stages_full']), card),
                  flush=True)
            out[(mode, shape)] = row
        del xh, H, Hd, B, Hf, Hdf, Bf
        torch.cuda.empty_cache()

    # the peaks of the public calls, band on and off, each with only its
    # own tables and cuFFT plans live
    x_dev = torch.as_tensor(x_np, device=dev)
    calls = {'stft': lambda: stq.stft(x_dev, n_fft=n_fft),
             'ssq_stft': lambda: stq.ssq_stft(x_dev, n_fft=n_fft),
             'ssq_stft2': lambda: stq.ssq_stft2(x_dev, n_fft=n_fft)}
    for name, fn in calls.items():
        got = {}
        for band in (True, False, True, False):
            configure(stft_band=band)
            try:
                for cache in (tabs._TABLE_CACHE, tabs._BANK_CACHE,
                              tabs._BAND_CACHE):
                    cache.clear()
                torch.backends.cuda.cufft_plan_cache.clear()
                torch.cuda.empty_cache()
                base = torch.cuda.memory_allocated() / 1e9
                ms, peak = host_ms(fn, reps=5)
                got.setdefault(band, []).append((ms, peak, base))
            finally:
                configure(stft_band=True)
        on, off = got[True], got[False]
        print("band plan %s at N=%d: peak %.3f GB banded vs %.3f GB full "
              "(above the %.3f GB held: %.3f vs %.3f), %.3f ms vs %.3f ms "
              "per call (host clock, mean of 5 after 2 warm-up, banded and "
              "full in turns); card: %s"
              % (name, len(x_np), on[0][1], off[0][1], on[0][2],
                 on[0][1] - on[0][2], off[0][1] - off[0][2],
                 (on[0][0] + on[1][0]) / 2, (off[0][0] + off[1][0]) / 2,
                 card), flush=True)
    for cache in (tabs._TABLE_CACHE, tabs._BANK_CACHE, tabs._BAND_CACHE):
        cache.clear()
    torch.cuda.empty_cache()
    return out


def _transform_counters():
    """(name, wrapper, attribute) of every launch counter of the CWT and
    STFT kernels' wrappers (one signal, batch, mixed, table, banded)."""
    from ssqueezepy_tpu_torch.ops import cwt_cuda, stft_cuda
    return [('%s.%s' % (w.__name__, a), w, a)
            for w in (cwt_cuda.cwt_bins, cwt_cuda.cwt_fused,
                      cwt_cuda.cwt_bins2, cwt_cuda.cwt_w2,
                      stft_cuda.stft_conv, stft_cuda.fsst2_conv,
                      stft_cuda.fsst2_w)
            for a in sorted(vars(w)) if a.endswith('launches')]


class general_only:
    """Within the block the public entry points take their general
    routes at any shape: the three host predicates (`cwt_kernel_fits`,
    `stft_kernel_fits`, `scatter_fits`) answer False in-process."""

    def __enter__(self):
        from ssqueezepy_tpu_torch.ops import cwt_cuda, ssq_cuda, stft_cuda
        self.saved = [(m, n, getattr(m, n)) for m, n in (
            (cwt_cuda, 'cwt_kernel_fits'), (stft_cuda, 'stft_kernel_fits'),
            (ssq_cuda, 'scatter_fits'))]
        for m, n, _ in self.saved:
            setattr(m, n, lambda *a: False)

    def __exit__(self, *exc):
        for m, n, f in self.saved:
            setattr(m, n, f)


def past_ceiling_section(stq, dev, card, counters, x_np, spec, scales,
                         ssq_freqs, n_fft):
    """12i: the public calls past the kernels' rules (ROADMAP.md queue C,
    C1b) on their general routes. (a) each past-ceiling case on the card,
    with the counters zeroed just before: the general functions' counters
    move, no CWT/STFT kernel launches, the outputs are finite; its host
    ms and peak GB (second call). (b) at N = 160000 with the predicates
    answering False, each route against the kernel route of the same call
    (Sx/Wx within 2e-5 of max, Tx by the bins criterion), both timed.
    (c) the A12b helpers on CUDA tensors: outputs on the card, equal to
    the CPU's. Returns the launches per kernel counter of (a)."""
    import torch
    from ssqueezepy_tpu_torch.models import (cwt as m_cwt,
                                             ssq_cwt2 as m_ssq2,
                                             ssq_stft as m_ssq_stft,
                                             stft as m_stft)
    from ssqueezepy_tpu_torch.ops.ssq_kernels import scatter_general
    general = [(f.__name__, f, 'calls') for f in (
        m_cwt.cwt_general, m_ssq2.wsst2_general, m_stft.stft_general,
        m_ssq_stft.fsst2_general, scatter_general)]
    transforms = _transform_counters()
    ctr = counters + general + transforms
    kernel_names = {n for n, _, _ in counters}
    launches = {}

    def finite(t):
        t = torch.view_as_real(t) if t.is_complex() else t
        return bool(torch.isfinite(t).all())

    # ---- (a) the past-ceiling calls ----------------------------------
    g = torch.Generator(device=dev)
    x4m = torch.randn(4194304, generator=g.manual_seed(1), device=dev)
    x12 = torch.randn(1200000, generator=g.manual_seed(2), device=dev,
                      dtype=torch.float64)
    x3m = torch.randn(3000000, generator=g.manual_seed(3), device=dev,
                      dtype=torch.float64)
    x1e7 = torch.randn(10 ** 7, generator=g.manual_seed(4), device=dev,
                       dtype=torch.float64)
    x4k = torch.randn(4096, generator=g.manual_seed(5), device=dev)
    g64 = ('gmw', {'dtype': 'float64'})
    sc300 = stq.process_scales('log-piecewise', 3000000,
                               stq.Wavelet(g64))[:300]
    sc8 = 2. ** (2 + np.arange(8) / 4)
    cases = [
        ('stft at N=4194304, float32, hop 1, n_fft=%d' % n_fft,
         lambda: (stq.stft(x4m, n_fft=n_fft),), {'stft_general'},
         (n_fft // 2 + 1, 4194304)),
        ('ssq_stft at N=4194304, float32, hop 1, n_fft=%d' % n_fft,
         lambda: stq.ssq_stft(x4m, n_fft=n_fft)[:2],
         {'stft_general', 'ssq_fused'}, (n_fft // 2 + 1, 4194304)),
        ('ssq_stft2 at N=1200000, float64, n_fft=%d' % n_fft,
         lambda: stq.ssq_stft2(x12, n_fft=n_fft, dtype='float64')[:2],
         {'fsst2_general', 'shift_scatter'}, (n_fft // 2 + 1, 1200000)),
        ('ssq_cwt2 at N=3000000, float64, reflect, %d scales (n_up = '
         '2^23)' % len(sc300),
         lambda: stq.ssq_cwt2(x3m, g64, scales=sc300)[:2],
         {'wsst2_general', 'shift_scatter'}, (len(sc300), 3000000)),
        ('ssq_cwt(padtype=None) at N=10^7, float64, 8 scales',
         lambda: stq.ssq_cwt(x1e7, g64, scales=sc8, padtype=None)[:2],
         {'cwt_general', 'ssq_fused'}, (8, 10 ** 7)),
        ('ssq_stft at N=4096, float32, n_fft=51200, hann (25601 bins)',
         lambda: stq.ssq_stft(x4k, n_fft=51200, window='hann')[:2],
         {'stft_general', 'scatter_general'}, (25601, 4096))]
    for what, fn, need, shape in cases:
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated() / 1e9
        out, counts = launches_of(ctr, fn)
        moved = {k: v for k, v in counts.items() if v}
        check(moved == dict.fromkeys(need, 1), "%s: the general route, "
              "exactly %s, no CWT/STFT kernel launch (%s)"
              % (what, sorted(need), moved))
        check(all(tuple(o.shape[-2:]) == shape and finite(o) for o in out),
              "%s: %s finite, %s" % (what, 'Tx, Sx/Wx' if len(out) == 2
                                     else 'Sx', shape))
        for k in kernel_names & set(moved):
            launches[k] = launches.get(k, 0) + moved[k]
        if what.startswith('stft'):
            xr = stq.istft(out[0], n_fft=n_fft, N=4194304)
            err = float(np.abs(xr - x4m.cpu().numpy()).mean())
            check(err < 1e-5, "%s: istft round trip MAE %.3g (< 1e-5)"
                  % (what, err))
        del out
        torch.cuda.empty_cache()
        ms, gb = host_ms(fn, reps=1, warm=0)
        print("past ceiling: %s: %.3f ms, peak %.3f GB above the %.3f GB "
              "the script holds (host clock, second call); card: %s"
              % (what, ms, gb - held, held, card), flush=True)
        torch.cuda.empty_cache()
    del x4m, x12, x3m, x1e7, x4k
    torch.cuda.empty_cache()

    # ---- (b) general against kernel routes at the headline -----------
    x = torch.as_tensor(x_np, device=dev)
    routes = {
        'stft': (lambda: (stq.stft(x, n_fft=n_fft),), False),
        'ssq_stft': (lambda: stq.ssq_stft(x, n_fft=n_fft)[:2], True),
        'ssq_stft2': (lambda: stq.ssq_stft2(x, n_fft=n_fft)[:2], True),
        'cwt': (lambda: stq.cwt(x, wavelet=spec, scales=scales)[:1],
                False),
        'ssq_cwt': (lambda: stq.ssq_cwt(x, spec, scales=scales,
                                        ssq_freqs=ssq_freqs)[:2], True),
        'ssq_cwt2': (lambda: stq.ssq_cwt2(x, spec, scales=scales)[:2],
                     True)}
    for name, (fn, ssq) in routes.items():
        ref = fn()
        with general_only():
            out, counts = launches_of(ctr, fn)
            check(not any(counts[n] for n, _, _ in transforms),
                  "%s at N=160000, predicates False: no CWT/STFT kernel "
                  "launch" % name)
            ms_g, gb_g = host_ms(fn, reps=3, warm=1)
        ms_k, gb_k = host_ms(fn, reps=3, warm=1)
        err = rel_err(out[-1], ref[-1])
        check(err <= 2e-5, "%s at N=160000: the general route's %s within "
              "%.3g of max of the kernel route's (limit 2e-5)"
              % (name, 'Sx' if 'stft' in name else 'Wx', err))
        if ssq:
            bins_criterion(out[0], ref[0], "%s at N=160000: general vs "
                           "kernel route" % name)
        print("general route at N=160000: %s %.3f ms (peak %.3f GB) "
              "against the kernel route's %.3f ms (peak %.3f GB), ratio "
              "%.2f (host clock, mean of 3 after warm-up); card: %s"
              % (name, ms_g, gb_g, ms_k, gb_k, ms_g / ms_k, card),
              flush=True)
        del out, ref
        torch.cuda.empty_cache()

    # ---- (c) the A12b helpers on CUDA tensors --------------------------
    rng = np.random.default_rng(12)
    h = rng.standard_normal(4096) * 1e-3
    h[::97], h[::101], h[5::89] = np.inf, np.nan, 0.
    hc = torch.as_tensor(h, device=dev)

    def same(a, b, what, tol=0.):
        ok = isinstance(a, torch.Tensor) and a.device.type == 'cuda'
        a, b = a.cpu(), torch.as_tensor(b)
        ok = ok and a.dtype == b.dtype and a.shape == b.shape and \
            torch.allclose(a, b, rtol=tol, atol=0., equal_nan=True)
        check(ok, "helpers on the card: %s stays on the card, equal to the "
              "CPU's%s" % (what, '' if tol == 0. else ' (%g)' % tol))
    for name, kw in (('replace_at_inf_or_nan', dict(replacement=7.)),
                     ('replace_at_inf', {}), ('replace_at_nan', {}),
                     ('replace_at_value', dict(value=0., replacement=3.)),
                     ('replace_under_abs', dict(value=5e-4))):
        fn = getattr(stq, name)
        same(fn(hc, **kw), fn(torch.as_tensor(h), **kw), name)
        same(fn(hc, hc, **kw), fn(h.copy(), **kw), name + ' (numpy ref)')
    hf = np.where(np.isfinite(h), h, 1.)
    hfc = torch.as_tensor(hf, device=dev)
    same(stq.zero_denormals(hfc * 1e-306),
         stq.zero_denormals(torch.as_tensor(hf) * 1e-306), 'zero_denormals')
    S, Q = stq.S, stq.Q
    same(S.asarray([1., 2.], dtype='float64', like=hfc), np.array([1., 2.]),
         'S.asarray')
    same(S.zeros(3, dtype='float64', like=hfc), np.zeros(3), 'S.zeros')
    same(Q.abs(hfc), np.abs(hf), 'Q.abs')
    same(Q.cumsum(hfc, 0), np.cumsum(hf), 'Q.cumsum', 1e-12)
    same(stq.mad(hfc), stq.mad(hf), 'mad', 1e-12)
    W = hf.reshape(8, 512) + 1j * hf[::-1].reshape(8, 512)
    same(stq.est_riskshrink_thresh(torch.as_tensor(W, device=dev), 3),
         stq.est_riskshrink_thresh(W, 3), 'est_riskshrink_thresh', 1e-12)
    win = stq.get_window('hann', 64, 64)
    xbuf = hf[:64 * 40].reshape(64, 40)
    same(stq.unbuffer(torch.as_tensor(xbuf, device=dev), win, 4, 64, 200),
         stq.unbuffer(xbuf, win, 4, 64, 200), 'unbuffer', 1e-12)
    same(stq.FFT_GLOBAL.rfft(hfc), np.fft.rfft(hf), 'FFT_GLOBAL.rfft',
         1e-12)
    a = stq.asnumpy(hfc)
    check(isinstance(a, np.ndarray) and np.array_equal(a, hf)
          and np.array_equal(stq.visuals._np(hfc), hf),
          "helpers on the card: asnumpy and visuals' _np bring a CUDA "
          "tensor to the host")
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, HERE)
    os.environ['SSQ_TPU_TORCH_CACHE'] = os.path.join(HERE, 'build',
                                                     'plan_cache')
    try:
        import ssqueezepy_tpu_torch as stq
        from ssqueezepy_tpu_torch.ops import _build
        from ssqueezepy_tpu_torch.ops.cwt_cuda import (
            bins_plan, cwt_bins, cwt_bins_plain, cwt_bins2, cwt_bins2_plain,
            cwt_fused, cwt_fused_plain, cwt_w2, four_step, support_klims,
            wsst2_rows)
        from ssqueezepy_tpu_torch.ops.ssq_cuda import (
            scatter_kv, scatter_kv_plain, scatter_launch_plan, shift_scatter,
            shift_scatter_plain, ssq_fused, ssq_fused_plain)
        from ssqueezepy_tpu_torch.ops.ridge_cuda import (ridge_forward,
                                                         ridge_trace)
        from ssqueezepy_tpu_torch.ops.phase import (phase_cwt, phase_cwt_num,
                                                    phase_stft,
                                                    phase_transform_w)
        from ssqueezepy_tpu_torch.ops.ssq_kernels import (compute_bins,
                                                          ssq_bin_params)
        from ssqueezepy_tpu_torch.ops.stft_cuda import (
            fsst2_conv, fsst2_conv_plain, fsst2_rows, fsst2_w, stft_conv,
            stft_conv_plain, split_fft_len)
        from ssqueezepy_tpu_torch.ops.stft_conv import (
            conv_bank, conv_table, _BAND_CACHE, _BANK_CACHE, _TABLE_CACHE)
        from ssqueezepy_tpu_torch.ops.fft import rfft
        from ssqueezepy_tpu_torch.ops.pad import padsignal, pad_params
        from ssqueezepy_tpu_torch.models.cwt import resolve_wavelet
        from ssqueezepy_tpu_torch.models.ssq_cwt import _ssq_cwt_plan
        from ssqueezepy_tpu_torch.models.ssq_stft import fsst2_plan, stft_plan
        from ssqueezepy_tpu_torch.models.stft import signal_spectrum
        from ssqueezepy_tpu_torch.models.ssqueezing import \
            _compute_associated_frequencies
        from ssqueezepy_tpu_torch.convert import plan_from_numpy
    except ImportError as e:
        fail("the port is not importable beside this script (%s)" % e)
    # each kernel's launch counter: B3b counts on cwt_bins' batched
    # counter, B1 on its own; B6, B7 and B8 over a batch on theirs; the
    # CWT kernel's mixed engine on its own counters (`mixed_*`); the w2
    # modes of B8 (`cwt_w2`) and B7 (`fsst2_w`) on theirs
    all_kernels = [(k.__name__, k, 'launches') for k in (
        cwt_bins, scatter_kv, stft_conv, cwt_fused, cwt_bins2, fsst2_conv,
        ssq_fused, shift_scatter, cwt_w2, fsst2_w, ridge_forward,
        ridge_trace)] + [
        (k.__name__ + '_batched', k, 'batched_launches')
        for k in (cwt_bins, stft_conv, fsst2_conv, cwt_bins2, cwt_w2,
                  fsst2_w)] + [
        (k.__name__ + '_mixed', k, 'mixed_launches')
        for k in (cwt_bins, cwt_fused, cwt_bins2, cwt_w2)] + [
        (k.__name__ + '_batched_mixed', k, 'mixed_batched_launches')
        for k in (cwt_bins, cwt_bins2, cwt_w2)] + [
        # B6/B7 launches on banded tables (the band plan), also counted
        # on the wrappers' own counters above
        (k.__name__ + suffix + '_banded', k, 'banded_' + attr)
        for k in (stft_conv, fsst2_conv, fsst2_w)
        for suffix, attr in (('', 'launches'),
                             ('_batched', 'batched_launches'))]
    # full-precision float32 products in every plain version
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda')

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else 'nvidia-smi unavailable'
    print(card, flush=True)
    print("torch %s, CUDA %s, %s x %d" % (
        torch.__version__, torch.version.cuda,
        torch.cuda.get_device_name(0), torch.cuda.device_count()),
        flush=True)

    t0 = time.perf_counter()
    ptxas = {}
    build_s = _build.build_all(ptxas=ptxas)
    print("built %s in %.2f s (nvcc, in parallel)"
          % (', '.join(_build.SOURCES), build_s), flush=True)
    # the DFT engine: bins_stage1<T, planes>, bins_stage2<T, out_mode>
    for line in (ptxas_report(ptxas['cwt_bins'], 'bins_stage')
                 if 'cwt_bins' in ptxas else ["not rebuilt in this run"]):
        print("ptxas, CWT engine: " + line, flush=True)
    # the STFT kernel's: stft_stage1<T, planes>, stft_stage2<T, mode>
    for line in (ptxas_report(ptxas['stft_conv'], 'stft_stage')
                 if 'stft_conv' in ptxas else ["not rebuilt in this run"]):
        print("ptxas, STFT engine: " + line, flush=True)
    # the reassignment kernels: scatter_kv_kernel<T>,
    # shift_scatter_kernel<T, mask, const>, ssq_fused_kernel<T, sfs>
    for key in ('scatter_kv_kernel', 'shift_scatter_kernel',
                'ssq_fused_kernel'):
        for line in (ptxas_report(ptxas['scatter_kv'], key)
                     if 'scatter_kv' in ptxas
                     else ["not rebuilt in this run"]):
            print("ptxas, scatters: " + line, flush=True)

    # ---- the bench headline plan ---------------------------------------
    N = 160000
    spec = ('gmw', {'dtype': 'float32'})
    wav = stq.Wavelet(spec)
    scales = stq.process_scales('log-piecewise', N, wav)[:300]
    ssq_freqs = _compute_associated_frequencies(
        scales, N, wav, 'log-piecewise', maprange='peak', was_padded=True,
        dt=1, transform='cwt')
    plan = plan_from_numpy(scales, ssq_freqs, spec, N)
    params = plan['params']
    na, nbins = len(scales), params['omax'] + 1
    n_up, n1, _ = pad_params(N, 'reflect')
    check((na, nbins, n_up, n1, params['mode']) ==
          (293, 293, 262144, 51072, 'log-piecewise'),
          "headline plan: na=%d nbins=%d n_up=%d n1=%d %s"
          % (na, nbins, n_up, n1, params['mode']))
    f1, f2 = four_step(n_up)
    # B2/B5/B4's plans at the headline, from the kernel's shared bytes and
    # the blocks per SM the runtime grants (kind: 0 B2, 1 B5 with mask and
    # const, 4 B5 with neither, 5 B4, 6 B4 with Sfs at ssq_stft's 300 bins)
    for what, kind, itemsize, nb in (
            ('B2 float32', 0, 8, nbins), ('B2 float64', 0, 16, nbins),
            ('B5 float32, mask + const', 1, 8, nbins),
            ('B5 float32, neither', 4, 8, nbins),
            ('B5 float64, mask + const', 1, 16, nbins),
            ('B4 float32', 5, 8, nbins), ('B4 float64', 5, 16, nbins),
            ('B4 float32, Sfs', 6, 8, 300)):
        sp = scatter_launch_plan(kind, nb, itemsize, dev)
        print("scatter plan, %s at nbins=%d: %d columns, ring of %d stages "
              "x 8 rows, %d B shared per block, %d blocks per SM granted by "
              "the runtime, %d B of copies in flight per SM"
              % (what, nb, sp.columns, sp.stages, sp.smem,
                 sp.blocks_per_sm, sp.inflight), flush=True)
    rng = np.random.default_rng(0)
    x_np = rng.standard_normal(N).astype(np.float32)

    def kernel_inputs(dtype):
        tdt = getattr(torch, dtype)
        wv = resolve_wavelet(('gmw', {'dtype': dtype}), N=N)
        xh = rfft(padsignal(torch.as_tensor(x_np, dtype=tdt, device=dev),
                            'reflect'))
        sc = torch.as_tensor(scales.ravel(), dtype=tdt, device=dev)
        c = torch.as_tensor(np.ravel(plan['const']), dtype=tdt, device=dev)
        gamma = 10 * float(np.finfo(dtype).eps)
        return wv, xh, sc, c, gamma

    # ---- B1 against its plain version ------------------------------------
    print("B1 cwt_bins vs plain at (%d, %d), n_up=%d=%dx%d"
          % (na, N, n_up, f1, f2), flush=True)
    b1 = {}
    for dtype in ('float32', 'float64'):
        wv, xh, sc, c, gamma = kernel_inputs(dtype)
        args = (xh, sc, wv, n_up, n1, N, 1., True, params, gamma, True)
        Wx_k, k_k = cwt_bins(*args)
        torch.cuda.synchronize()
        Wx_p, k_p = cwt_bins_plain(*args)
        m = float(Wx_p.abs().max())
        err = float((Wx_k - Wx_p).abs().max())
        flips = float((k_k != k_p).double().mean())
        check(bool(torch.isfinite(torch.view_as_real(Wx_k)).all()),
              "%s: Wx finite" % dtype)
        if dtype == 'float32':
            check(err <= 2e-5 * m, "float32: max|Wx_kernel - Wx_plain| = %.3g of max|Wx| "
                  "(limit 2e-5)" % (err / m))
            check(flips <= 0.01, "float32: k differs on %.4f%% of cells "
                  "(limit 1%%)" % (100 * flips))
            bins_criterion(scatter_kv_plain(Wx_k, k_k, c, nbins),
                           scatter_kv_plain(Wx_p, k_p, c, nbins),
                           "float32 B1")
            Wx_r, k_r = cwt_bins(*args)
            check(torch.equal(Wx_r, Wx_k) and torch.equal(k_r, k_k),
                  "float32 B1 repeat runs bit-identical")
            del Wx_r, k_r
            for deriv in (False, True):
                Wx_3 = cwt_fused(xh, sc, wv, n_up, n1, N, 1., deriv, True)[0]
                check(torch.equal(Wx_3, Wx_k), "float32 B3 Wx (%s) "
                      "bit-identical to B1's" % ("Wx and dWx" if deriv
                                                 else "Wx only"))
                del Wx_3
            b1 = dict(err=err, args=args, Wx=Wx_k, k=k_k, c=c)
        else:
            check(err <= 1e-9 * m, "float64: max|Wx_kernel - Wx_plain| = %.3g of max|Wx| "
                  "(limit 1e-9); k differs on %.4f%% of cells"
                  % (err / m, 100 * flips))
        del Wx_p, k_p, Wx_k, k_k
    torch.cuda.empty_cache()

    # ---- B2 against its plain version ------------------------------------
    Wx, k, c = b1['Wx'], b1['k'], b1['c']
    Tx1 = scatter_kv(Wx, k, c, nbins)
    Tx2 = scatter_kv(Wx, k, c, nbins)
    torch.cuda.synchronize()
    Tx_p = scatter_kv_plain(Wx, k, c, nbins)
    b2_err = float((Tx1 - Tx_p).abs().max())
    check(b2_err <= 1e-5 * float(Tx_p.abs().max()),
          "B2 scatter_kv vs plain: max|Tx_kernel - Tx_plain| = %.3g of max|Tx| (limit 1e-5)"
          % (b2_err / float(Tx_p.abs().max())))
    check(torch.equal(Tx1, Tx2), "B2 repeat runs bit-identical")
    n_valid = int(((k >= 0) & (k < nbins)).sum())
    del Tx1, Tx2, Tx_p

    # ---- B6 against its plain version, three modes -------------------------
    n_fft = 300 * 2 - 2
    n_rows = n_fft // 2 + 1

    def stft_inputs(Ns, dtype, x=None):
        tdt = getattr(torch, dtype)
        if x is None:
            x = rng.standard_normal(Ns)
        xt = torch.as_tensor(x, dtype=tdt, device=dev)
        xh6 = signal_spectrum(xt, n_fft, 'reflect')
        sp = stft_plan(None, None, n_fft, n_fft, 1., dtype)
        Np2 = xh6.shape[-1]
        H = conv_table(sp.window, n_fft, Np2, True, dtype, dev)
        Hd = conv_table(sp.diff_window, n_fft, Np2, True, dtype, dev)
        bins = dict(Sfs=torch.as_tensor(sp.Sfs, device=dev),
                    params=sp.params, flipud=False,
                    gamma=10 * float(np.finfo(dtype).eps))
        c6 = torch.full((n_rows,), sp.const, dtype=tdt, device=dev)
        return xh6, H, Hd, bins, c6

    b6 = {}
    for Ns in (N, 10000):
        for dtype in ('float32', 'float64'):
            xh6, H, Hd, bins6, c6 = stft_inputs(
                Ns, dtype, x_np if Ns == N else None)
            Np2 = xh6.shape[0]
            print("B6 stft_conv vs plain at (%d, %d), Np2=%d=%dx%d, %s"
                  % ((n_rows, Ns, Np2) + split_fft_len(Np2) + (dtype,)),
                  flush=True)
            tol = 2e-5 if dtype == 'float32' else 1e-9
            Sx_0 = None
            for mode, Hd_, bins_ in (('Sx', None, None),
                                     ('Sx+dSx', Hd, None),
                                     ('Sx+k', Hd, bins6)):
                Sx_k, o_k = stft_conv(xh6, H, Hd_, Ns, 1., bins_)
                torch.cuda.synchronize()
                Sx_p, o_p = stft_conv_plain(xh6, H, Hd_, Ns, 1., bins_)
                err = rel_err(Sx_k, Sx_p)
                check(err <= tol, "%s %s: max|Sx_kernel - Sx_plain| = %.3g of "
                      "max|Sx| (limit %g)" % (dtype, mode, err, tol))
                if Sx_0 is None:
                    Sx_0 = Sx_k
                else:
                    check(torch.equal(Sx_k, Sx_0), "%s %s: Sx bit-identical "
                          "to the Sx mode's" % (dtype, mode))
                if Ns == N and dtype == 'float32':
                    Sx_r, o_r = stft_conv(xh6, H, Hd_, Ns, 1., bins_)
                    check(torch.equal(Sx_r, Sx_k) and (
                        o_k is None or torch.equal(o_r, o_k)),
                        "float32 B6 %s repeat runs bit-identical" % mode)
                    del Sx_r, o_r
                if mode == 'Sx+dSx':
                    err_d = rel_err(o_k, o_p)
                    check(err_d <= tol, "%s %s: dSx %.3g of max|dSx| "
                          "(limit %g)" % (dtype, mode, err_d, tol))
                if mode == 'Sx+k':
                    flips = float((o_k != o_p).double().mean())
                    check(flips <= 0.01, "%s %s: k differs on %.4f%% of "
                          "cells (limit 1%%)" % (dtype, mode, 100 * flips))
                    if dtype == 'float32':
                        bins_criterion(
                            scatter_kv_plain(Sx_k, o_k, c6, n_rows),
                            scatter_kv_plain(Sx_p, o_p, c6, n_rows),
                            "float32 B6 at N=%d" % Ns)
                    if Ns == N and dtype == 'float32':
                        b6 = dict(err=float((Sx_k - Sx_p).abs().max()),
                                  args=(xh6, H, Hd, Ns, 1., bins6),
                                  n_valid=int((o_k >= 0).sum()))
                del Sx_k, o_k, Sx_p, o_p
            del xh6, H, Hd, Sx_0
            torch.cuda.empty_cache()

    # ---- B3 against its plain version --------------------------------------
    xb_np = rng.standard_normal((16, 10000)).astype(np.float32)
    b3 = {}
    for shape in ((N,), (16, 10000)):
        for dtype in ('float32', 'float64'):
            tdt = getattr(torch, dtype)
            wv = resolve_wavelet(('gmw', {'dtype': dtype}))
            Nb = shape[-1]
            nu, nn1, _ = pad_params(Nb, 'reflect')
            xsrc = x_np if shape == (N,) else xb_np
            xh3 = rfft(padsignal(torch.as_tensor(xsrc, dtype=tdt,
                                                 device=dev),
                                 'reflect')).contiguous()
            sc3 = torch.as_tensor(scales.ravel(), dtype=tdt, device=dev)
            tol = 2e-5 if dtype == 'float32' else 1e-9
            for deriv in (False, True):
                args3 = (xh3, sc3, wv, nu, nn1, Nb, 1., deriv, True)
                W_k, dW_k = cwt_fused(*args3)
                torch.cuda.synchronize()
                W_p, dW_p = cwt_fused_plain(*args3)
                err = rel_err(W_k, W_p)
                check(err <= tol, "B3 cwt_fused %s %s derivative=%s: "
                      "max|Wx_kernel - Wx_plain| = %.3g of max|Wx| (limit "
                      "%g)" % (shape, dtype, deriv, err, tol))
                if deriv:
                    err_d = rel_err(dW_k, dW_p)
                    check(err_d <= tol, "B3 %s %s: dWx %.3g of max|dWx| "
                          "(limit %g)" % (shape, dtype, err_d, tol))
                if shape == (N,) and dtype == 'float32' and not deriv:
                    b3 = dict(err=float((W_k - W_p).abs().max()),
                              args=args3)
                del W_k, dW_k, W_p, dW_p
            del xh3
            torch.cuda.empty_cache()

    # ---- B8 and B7 against their plain versions ----------------------------
    # B8 on the plan of the bench's ssq_cwt2 call (its scales, the ssq grid
    # computed from them)
    plan2 = plan_from_numpy(scales, None, spec, N)
    params2 = plan2['params']
    nbins2 = params2['omax'] + 1
    b8, b7 = {}, {}
    for Ns, dtype in ((N, 'float32'), (10000, 'float64')):
        tdt = getattr(torch, dtype)
        wv = resolve_wavelet(('gmw', {'dtype': dtype}), N=Ns)
        nu, nn1, _ = pad_params(Ns, 'reflect')
        xsrc = x_np if Ns == N else rng.standard_normal(Ns)
        xh8 = rfft(padsignal(torch.as_tensor(xsrc, dtype=tdt, device=dev),
                             'reflect'))
        pl8 = plan2 if Ns == N else plan_from_numpy(
            stq.process_scales('log-piecewise', Ns, wv), None,
            ('gmw', {'dtype': dtype}), Ns)
        sc8 = torch.as_tensor(pl8['scales'].ravel(), dtype=tdt, device=dev)
        c8 = torch.as_tensor(np.broadcast_to(np.ravel(pl8['const']),
                                             (len(sc8),)).copy(),
                             dtype=tdt, device=dev)
        gamma = 10 * float(np.finfo(dtype).eps)
        args8 = (xh8, sc8, wv, nu, nn1, Ns, 1., pl8['params'], gamma, True)
        print("B8 cwt_bins2 vs plain at (%d, %d), n_up=%d, %s"
              % (len(sc8), Ns, nu, dtype), flush=True)
        W_k, k_k = cwt_bins2(*args8)
        torch.cuda.synchronize()
        W_p, k_p = cwt_bins2_plain(*args8)
        err = rel_err(W_k, W_p)
        flips = float((k_k != k_p).double().mean())
        tol = 2e-5 if dtype == 'float32' else 1e-9
        check(bool(torch.isfinite(torch.view_as_real(W_k)).all())
              and err <= tol and flips <= 0.01,
              "B8 %s: max|W_kernel - W_plain| = %.3g of max|W| (limit %g), "
              "k differs on %.4f%% of cells (limit 1%%)"
              % (dtype, err, tol, 100 * flips))
        nb = pl8['params']['omax'] + 1
        bins_criterion(scatter_kv_plain(W_k, k_k, c8, nb),
                       scatter_kv_plain(W_p, k_p, c8, nb), "%s B8" % dtype)
        if Ns == N:
            b8 = dict(err=float((W_k - W_p).abs().max()), args=args8, c=c8)
            check(torch.equal(W_k, b1['Wx']), "B8 W bit-identical to "
                  "B1's Wx (L1 norm, same spectrum and scales)")
        del W_k, k_k, W_p, k_p
        torch.cuda.empty_cache()

        # B7 at the ssq_stft2 headline (float32) and at N = 10000 (float64)
        xt7 = torch.as_tensor(xsrc, dtype=tdt, device=dev)
        xh7 = signal_spectrum(xt7, n_fft, 'reflect')
        p7 = fsst2_plan(None, None, n_fft, n_fft, 1., dtype)
        tab7 = conv_bank(p7.bank, n_fft, xh7.shape[0], True, dtype, dev)
        bins7 = dict(Sfs=torch.as_tensor(p7.Sfs, device=dev),
                     params=p7.params, flipud=False, gamma=gamma)
        c7 = torch.full((n_rows,), p7.const, dtype=tdt, device=dev)
        print("B7 fsst2_conv vs plain at (%d, %d), Np2=%d=%dx%d, %s"
              % ((n_rows, Ns, xh7.shape[0]) + split_fft_len(xh7.shape[0])
                 + (dtype,)), flush=True)
        V_k, k_k = fsst2_conv(xh7, tab7, Ns, 1., bins7)
        torch.cuda.synchronize()
        V_p, k_p = fsst2_conv_plain(xh7, tab7, Ns, 1., bins7)
        err = rel_err(V_k, V_p)
        flips = float((k_k != k_p).double().mean())
        check(bool(torch.isfinite(torch.view_as_real(V_k)).all())
              and err <= tol and flips <= 0.01,
              "B7 %s: max|V_kernel - V_plain| = %.3g of max|V| (limit %g), "
              "k differs on %.4f%% of cells (limit 1%%)"
              % (dtype, err, tol, 100 * flips))
        bins_criterion(scatter_kv_plain(V_k, k_k, c7, n_rows),
                       scatter_kv_plain(V_p, k_p, c7, n_rows),
                       "%s B7" % dtype)
        check(torch.equal(stft_conv(xh7, tab7[0], None, Ns)[0], V_k),
              "B7 %s: V bit-identical to B6's Sx with the first table as H"
              % dtype)
        V_r, k_r = fsst2_conv(xh7, tab7, Ns, 1., bins7)
        check(torch.equal(V_r, V_k) and torch.equal(k_r, k_k),
              "B7 %s repeat runs bit-identical" % dtype)
        del V_r, k_r
        if Ns == N:
            b7 = dict(err=float((V_k - V_p).abs().max()),
                      args=(xh7, tab7, Ns, 1., bins7), c=c7)
        else:
            del xh7, tab7
        del V_k, k_k, V_p, k_p
        _BANK_CACHE.clear()
        torch.cuda.empty_cache()

    # ---- B3b and batched B2 against their plain versions -----------------
    B4N = 4
    xb_big = rng.standard_normal((B4N, N)).astype(np.float32)
    b3b = {}
    for shape, dtype in (((B4N, N), 'float32'), ((3, 10000), 'float64')):
        tdt = getattr(torch, dtype)
        Nb = shape[-1]
        wv = resolve_wavelet(('gmw', {'dtype': dtype}), N=Nb)
        if Nb == N:
            plb, xsrc = plan, xb_big
        else:
            plb = plan_from_numpy(stq.process_scales('log-piecewise', Nb, wv),
                                  None, ('gmw', {'dtype': dtype}), Nb)
            xsrc = rng.standard_normal(shape)
        nu, nn1, _ = pad_params(Nb, 'reflect')
        xhb = rfft(padsignal(torch.as_tensor(xsrc, dtype=tdt, device=dev),
                             'reflect')).contiguous()
        scb = torch.as_tensor(plb['scales'].ravel(), dtype=tdt, device=dev)
        cb_ = torch.as_tensor(np.broadcast_to(np.ravel(plb['const']),
                                              (len(scb),)).copy(),
                              dtype=tdt, device=dev)
        gamma = 10 * float(np.finfo(dtype).eps)
        rest = (scb, wv, nu, nn1, Nb, 1., True, plb['params'], gamma, True)
        print("B3b cwt_bins batched vs plain at %s x %d scales, n_up=%d, %s"
              % (shape, len(scb), nu, dtype), flush=True)
        W_k, k_k = cwt_bins(xhb, *rest)
        torch.cuda.synchronize()
        W_p, k_p = cwt_bins_plain(xhb, *rest)
        err = rel_err(W_k, W_p)
        err_abs = float((W_k - W_p).abs().max())
        flips = float((k_k != k_p).double().mean())
        tol = 2e-5 if dtype == 'float32' else 1e-9
        check(bool(torch.isfinite(torch.view_as_real(W_k)).all())
              and err <= tol and flips <= 0.01,
              "B3b %s: max|Wx_kernel - Wx_plain| = %.3g of max|Wx| (limit "
              "%g), k differs on %.4f%% of cells (limit 1%%)"
              % (dtype, err, tol, 100 * flips))
        nb = plb['params']['omax'] + 1
        bins_criterion(scatter_kv_plain(W_k, k_k, cb_, nb),
                       scatter_kv_plain(W_p, k_p, cb_, nb), "%s B3b" % dtype)
        del W_p, k_p
        same = True
        for b in range(shape[0]):
            W1, k1 = cwt_bins(xhb[b].contiguous(), *rest)
            same = same and torch.equal(W1, W_k[b]) and torch.equal(k1,
                                                                  k_k[b])
        del W1, k1
        check(same, "B3b %s: every row bit-identical to B1 on its signal"
              % dtype)
        # batched B2 on these planes
        T1 = scatter_kv(W_k, k_k, cb_, nb)
        T2 = scatter_kv(W_k, k_k, cb_, nb)
        torch.cuda.synchronize()
        check(torch.equal(T1, T2) and all(
            torch.equal(T1[b], scatter_kv(W_k[b], k_k[b], cb_, nb))
            for b in range(shape[0])),
            "B2 batched %s: repeats and per-signal launches bit-identical"
            % dtype)
        T_p = scatter_kv_plain(W_k, k_k, cb_, nb)
        e2 = rel_err(T1, T_p)
        check(e2 <= 1e-5, "B2 batched %s vs plain: %.3g of max|Tx| (limit "
              "1e-5)" % (dtype, e2))
        if Nb == N:
            b3b = dict(err=err_abs, args=(xhb,) + rest, c=cb_,
                       b2=(W_k, k_k, cb_, nb))
        del W_k, k_k, T1, T2, T_p
        torch.cuda.empty_cache()

    # ---- B4 against its plain version ------------------------------------
    def b4_check(Wx4, dWx4, c4, params4, gamma4, flipud4, Sfs4, dtype, what):
        T1 = ssq_fused(Wx4, dWx4, c4, params4, gamma4, flipud4, Sfs4)
        T2 = ssq_fused(Wx4, dWx4, c4, params4, gamma4, flipud4, Sfs4)
        torch.cuda.synchronize()
        T_p = ssq_fused_plain(Wx4, dWx4, c4, params4, gamma4, flipud4, Sfs4)
        check(torch.equal(T1, T2) and bool(
            torch.isfinite(torch.view_as_real(T1)).all()),
            "B4 %s: finite, repeats bit-identical" % what)
        if dtype == 'float32':
            bins_criterion(T1, T_p, "B4 " + what)
        else:
            e4 = rel_err(T1, T_p)
            check(e4 <= 1e-9, "B4 %s: max|Tx_kernel - Tx_plain| = %.3g of "
                  "max|Tx| (limit 1e-9)" % (what, e4))
        return float((T1 - T_p).abs().max())

    print("B4 ssq_fused vs plain", flush=True)
    wv, xh, sc, c, gamma = kernel_inputs('float32')
    Wx4, dWx4 = cwt_fused(xh, sc, wv, n_up, n1, N, 1., True, True)
    b4 = dict(err=b4_check(Wx4, dWx4, c, params, gamma, True, None,
                           'float32', "on the get_dWx CWT planes at 160k"),
              args=(Wx4, dWx4, c, params, gamma, True))
    del xh
    xh6, H, Hd, bins6, c6 = stft_inputs(N, 'float32', x_np)
    Sx4, dSx4 = stft_conv(xh6, H, Hd, N, 1.)
    b4_check(Sx4, dSx4, c6, bins6['params'], bins6['gamma'], False,
             bins6['Sfs'], 'float32', "on the STFT's (Sx, dSx) at 160k, Sfs")
    del xh6, H, Hd, Sx4, dSx4
    # as ssq_stft(hop_len=8) runs it: the framed STFT's planes, Sfs
    Sx8, dSx8 = stq.stft(torch.as_tensor(x_np, device=dev), n_fft=n_fft,
                         hop_len=8, derivative=True)
    b4h = dict(args=(Sx8.contiguous(), dSx8.contiguous(), c6,
                     bins6['params'], bins6['gamma'], False, bins6['Sfs']))
    b4h['err'] = b4_check(*b4h['args'], 'float32',
                          "on the hop-8 STFT's (Sx, dSx) %s, Sfs"
                          % (tuple(Sx8.shape),))
    del Sx8, dSx8
    wv64 = resolve_wavelet(('gmw', {'dtype': 'float64'}), N=10000)
    nu, nn1, _ = pad_params(10000, 'reflect')
    x64_10k = torch.as_tensor(rng.standard_normal(10000), device=dev)
    xh64 = rfft(padsignal(x64_10k, 'reflect')).contiguous()
    for scl in ('linear', 'log', 'log-piecewise'):
        pl4, _ = _ssq_cwt_plan(wv64, 10000, scl, 16, None, 'peak', True, 1.)
        sc4 = torch.as_tensor(pl4.scales.ravel(), device=dev)
        c4 = torch.as_tensor(np.broadcast_to(np.ravel(pl4.const),
                                             (len(sc4),)).copy(), device=dev)
        W64, dW64 = cwt_fused(xh64, sc4, wv64, nu, nn1, 10000, 1., True, True)
        for fl in (True, False):
            b4_check(W64, dW64, c4, pl4.params, 10 * float(np.finfo(
                np.float64).eps), fl, None, 'float64', "float64 at N=10000, "
                "%s grid, flipud=%s" % (pl4.params['mode'], fl))
    del xh64, W64, dW64
    torch.cuda.empty_cache()

    # ---- B5 against its plain version --------------------------------------
    def plant(kb, nbins_, gen):
        """k with 1% of cells each set to -1 (wraps to nbins - 1), -nbins
        (wraps to 0), -nbins - 3 and nbins + 2 (both dropped); valid false
        on 5% of cells."""
        kb = kb.clone()
        u = torch.rand(kb.shape, generator=gen, device=kb.device)
        for j, kv in enumerate((-1, -nbins_, -nbins_ - 3, nbins_ + 2)):
            kb[(u >= j * .01) & (u < (j + 1) * .01)] = kv
        valid = torch.rand(kb.shape, generator=gen, device=kb.device) >= .05
        return kb, valid

    def b5_check(v5, k5, valid5, nb5, c5, tol, what):
        T1 = shift_scatter(v5, k5, valid5, nb5, c5)
        T2 = shift_scatter(v5, k5, valid5, nb5, c5)
        torch.cuda.synchronize()
        T_p = shift_scatter_plain(v5, k5, valid5, nb5, c5)
        e5 = rel_err(T1, T_p)
        check(torch.equal(T1, T2) and e5 <= tol,
              "B5 shift_scatter %s: repeats bit-identical, max|out_kernel - "
              "out_plain| = %.3g of max|out| (limit %g)" % (what, e5, tol))
        return float((T1 - T_p).abs().max())

    gen = torch.Generator(device=dev).manual_seed(5)
    k5, valid5 = plant(b1['k'], nbins, gen)
    print("B5 shift_scatter vs plain at (%d, %d), nbins=%d, planted cells: "
          "%d wrapped, %d dropped, %d invalid"
          % (na, N, nbins, int((k5 < 0).sum() - (k5 < -nbins).sum()),
             int(((k5 < -nbins) | (k5 >= nbins)).sum()),
             int((~valid5).sum())), flush=True)
    b5_err = b5_check(b1['Wx'], k5, valid5, nbins, b1['c'], 1e-5,
                      "float32 at the headline")
    del k5, valid5
    rng64 = np.random.default_rng(6)
    v64 = torch.as_tensor(rng64.standard_normal((na, 10000))
                          + 1j * rng64.standard_normal((na, 10000)),
                          device=dev)
    k64 = torch.as_tensor(rng64.integers(-2 * nbins, 2 * nbins,
                                         (na, 10000)), dtype=torch.int32,
                          device=dev)
    k64, valid64 = plant(k64, nbins, gen)
    c64 = torch.as_tensor(rng64.random(na) + .5, device=dev)
    b5_check(v64, k64, valid64, nbins, c64, 1e-12, "float64 at N=10000")
    b5_check(v64, k64, None, nbins, None, 1e-12,
             "float64 at N=10000, no mask, no const")
    del v64, k64, valid64, c64
    torch.cuda.empty_cache()

    # ---- B6, B7 and B8 over a batch against their plain versions ---------
    # rows b * n_rows + i of one launch pair per chunk; each row must be
    # bit-identical to its spectrum launched alone, and each call must
    # count on the batched counter only
    rngb = np.random.default_rng(14)
    b6b, b7b, b8b = {}, {}, {}
    for xsrc, dtype in ((xb_big, 'float32'),
                        (rngb.standard_normal((3, 10000)), 'float64')):
        Bb, Ns = xsrc.shape
        tdt = getattr(torch, dtype)
        tol = 2e-5 if dtype == 'float32' else 1e-9
        gamma = 10 * float(np.finfo(dtype).eps)
        xh6, H, Hd, bins6, c6 = stft_inputs(Ns, dtype, xsrc)
        print("B6 stft_conv over a batch vs plain at (%d, %d, %d), Np2=%d, "
              "%s" % (Bb, n_rows, Ns, xh6.shape[-1], dtype), flush=True)
        for mode, Hd_, bins_ in (('Sx', None, None), ('Sx+dSx', Hd, None),
                                 ('Sx+k', Hd, bins6)):
            out_k, counts = launches_of(all_kernels, lambda: stft_conv(
                xh6, H, Hd_, Ns, 1., bins_))
            check(counts['stft_conv_batched'] >= 1
                  and counts['stft_conv'] == 0,
                  "B6 %s %s over a batch: the batched counter only (%d C "
                  "calls)" % (dtype, mode, counts['stft_conv_batched']))
            out_p = stft_conv_plain(xh6, H, Hd_, Ns, 1., bins_)
            err = rel_err(out_k[0], out_p[0])
            check(out_k[0].shape == (Bb, n_rows, Ns) and err <= tol,
                  "B6 %s %s over a batch: max|Sx_kernel - Sx_plain| = %.3g "
                  "of max|Sx| (limit %g)" % (dtype, mode, err, tol))
            if mode == 'Sx+dSx':
                err_d = rel_err(out_k[1], out_p[1])
                check(err_d <= tol, "B6 %s %s over a batch: dSx %.3g of "
                      "max|dSx| (limit %g)" % (dtype, mode, err_d, tol))
            if mode == 'Sx+k':
                flips = float((out_k[1] != out_p[1]).double().mean())
                check(flips <= 0.01, "B6 %s %s over a batch: k differs on "
                      "%.4f%% of cells (limit 1%%)"
                      % (dtype, mode, 100 * flips))
                if dtype == 'float32':
                    bins_criterion(
                        scatter_kv_plain(out_k[0], out_k[1], c6, n_rows),
                        scatter_kv_plain(out_p[0], out_p[1], c6, n_rows),
                        "float32 B6 over a batch")
            same = all(
                (o is None and o1 is None) or torch.equal(o[b], o1)
                for b in range(Bb) for o, o1 in zip(out_k, stft_conv(
                    xh6[b].contiguous(), H, Hd_, Ns, 1., bins_)))
            check(same, "B6 %s %s over a batch: every row bit-identical to "
                  "its spectrum launched alone" % (dtype, mode))
            if Ns == N and mode == 'Sx+k':
                b6b = dict(err=float((out_k[0] - out_p[0]).abs().max()),
                           args=(xh6, H, Hd, Ns, 1., bins6), c=c6)
            del out_k, out_p
        del H, Hd
        torch.cuda.empty_cache()

        p7 = fsst2_plan(None, None, n_fft, n_fft, 1., dtype)
        tab7 = conv_bank(p7.bank, n_fft, xh6.shape[-1], True, dtype, dev)
        bins7 = dict(Sfs=torch.as_tensor(p7.Sfs, device=dev),
                     params=p7.params, flipud=False, gamma=gamma)
        c7 = torch.full((n_rows,), p7.const, dtype=tdt, device=dev)
        print("B7 fsst2_conv over a batch vs plain at (%d, %d, %d), %s"
              % (Bb, n_rows, Ns, dtype), flush=True)
        (V_k, k_k), counts = launches_of(all_kernels, lambda: fsst2_conv(
            xh6, tab7, Ns, 1., bins7))
        V_p, k_p = fsst2_conv_plain(xh6, tab7, Ns, 1., bins7)
        err, err_abs = rel_err(V_k, V_p), float((V_k - V_p).abs().max())
        flips = float((k_k != k_p).double().mean())
        check(counts['fsst2_conv_batched'] >= 1 and counts['fsst2_conv'] == 0
              and V_k.shape == (Bb, n_rows, Ns) and err <= tol
              and flips <= 0.01,
              "B7 %s over a batch: the batched counter only, max|V_kernel "
              "- V_plain| = %.3g of max|V| (limit %g), k differs on %.4f%% "
              "of cells (limit 1%%)" % (dtype, err, tol, 100 * flips))
        bins_criterion(scatter_kv_plain(V_k, k_k, c7, n_rows),
                       scatter_kv_plain(V_p, k_p, c7, n_rows),
                       "%s B7 over a batch" % dtype)
        del V_p, k_p
        same = all(torch.equal(V_k[b], V1) and torch.equal(k_k[b], k1)
                   for b in range(Bb) for V1, k1 in [fsst2_conv(
                       xh6[b].contiguous(), tab7, Ns, 1., bins7)])
        check(same, "B7 %s over a batch: every row bit-identical to its "
              "spectrum launched alone" % dtype)
        if Ns == N:
            b7b = dict(err=err_abs,
                       args=(xh6, tab7, Ns, 1., bins7), c=c7)
        del V_k, k_k, xh6, tab7
        _BANK_CACHE.clear()
        torch.cuda.empty_cache()

        wv = resolve_wavelet(('gmw', {'dtype': dtype}), N=Ns)
        nu, nn1, _ = pad_params(Ns, 'reflect')
        xh8 = rfft(padsignal(torch.as_tensor(xsrc, dtype=tdt, device=dev),
                             'reflect')).contiguous()
        pl8 = plan2 if Ns == N else plan_from_numpy(
            stq.process_scales('log-piecewise', Ns, wv), None,
            ('gmw', {'dtype': dtype}), Ns)
        sc8 = torch.as_tensor(pl8['scales'].ravel(), dtype=tdt, device=dev)
        c8 = torch.as_tensor(np.broadcast_to(np.ravel(pl8['const']),
                                             (len(sc8),)).copy(),
                             dtype=tdt, device=dev)
        rest8 = (sc8, wv, nu, nn1, Ns, 1., pl8['params'], gamma, True)
        print("B8 cwt_bins2 over a batch vs plain at (%d, %d, %d), n_up=%d, "
              "%s" % (Bb, len(sc8), Ns, nu, dtype), flush=True)
        (W_k, k_k), counts = launches_of(all_kernels,
                                         lambda: cwt_bins2(xh8, *rest8))
        W_p, k_p = cwt_bins2_plain(xh8, *rest8)
        err, err_abs = rel_err(W_k, W_p), float((W_k - W_p).abs().max())
        flips = float((k_k != k_p).double().mean())
        check(counts['cwt_bins2_batched'] >= 1 and counts['cwt_bins2'] == 0
              and W_k.shape == (Bb, len(sc8), Ns) and err <= tol
              and flips <= 0.01,
              "B8 %s over a batch: the batched counter only, max|W_kernel "
              "- W_plain| = %.3g of max|W| (limit %g), k differs on %.4f%% "
              "of cells (limit 1%%)" % (dtype, err, tol, 100 * flips))
        nb = pl8['params']['omax'] + 1
        bins_criterion(scatter_kv_plain(W_k, k_k, c8, nb),
                       scatter_kv_plain(W_p, k_p, c8, nb),
                       "%s B8 over a batch" % dtype)
        del W_p, k_p
        same = all(torch.equal(W_k[b], W1) and torch.equal(k_k[b], k1)
                   for b in range(Bb) for W1, k1 in [cwt_bins2(
                       xh8[b].contiguous(), *rest8)])
        check(same, "B8 %s over a batch: every row bit-identical to its "
              "spectrum launched alone" % dtype)
        if Ns == N:
            b8b = dict(err=err_abs,
                       args=(xh8,) + rest8, c=c8)
        del W_k, k_k, xh8
        torch.cuda.empty_cache()

    # ---- the CWT kernel's mixed engine against its plain versions --------
    # padtype=None: n_up = N, whose prime factors are at most 7; 160000 =
    # 400 x 400 (radices 4 4 5 5), 99225 = 3^4 5^2 7^2 = 315 x 315 (radices
    # 3 3 5 7, no power of two in either factor). Each launch must count
    # on the mixed counters only.
    rngm = np.random.default_rng(15)
    mx = {}
    for Nm, dtype in ((N, 'float32'), (99225, 'float64')):
        tdt = getattr(torch, dtype)
        wv = resolve_wavelet(('gmw', {'dtype': dtype}), N=Nm)
        plm = (plan_from_numpy(scales, None, spec, N, padded=False)
               if Nm == N else plan_from_numpy(
                   stq.process_scales('log-piecewise', Nm, wv), None,
                   ('gmw', {'dtype': dtype}), Nm, padded=False))
        xm = x_np if Nm == N else rngm.standard_normal(Nm)
        xhm = rfft(torch.as_tensor(xm, dtype=tdt, device=dev)).contiguous()
        scm = torch.as_tensor(plm['scales'].ravel(), dtype=tdt, device=dev)
        cm = torch.as_tensor(np.broadcast_to(np.ravel(plm['const']),
                                             (len(scm),)).copy(),
                             dtype=tdt, device=dev)
        pm, nbm = plm['params'], plm['params']['omax'] + 1
        gamma = 10 * float(np.finfo(dtype).eps)
        tol = 2e-5 if dtype == 'float32' else 1e-9
        isz = xhm.element_size()
        print("mixed engine at (%d, %d), n_up=%d=%dx%d, %s; plans (planes: "
              "P1, P2, shared bytes per block): %s" % (
                  len(scm), Nm, Nm, *four_step(Nm), dtype, ', '.join(
                      '%d: %d, %d, %d' % (q, bp.P1, bp.P2, bp.smem1)
                      for q in (1, 2, 5) for bp in [bins_plan(Nm, isz, q)])),
              flush=True)
        argsm = (xhm, scm, wv, Nm, 0, Nm, 1., True, pm, gamma, True)
        (W_k, k_k), counts = launches_of(all_kernels,
                                         lambda: cwt_bins(*argsm))
        W_p, k_p = cwt_bins_plain(*argsm)
        err, err_abs = rel_err(W_k, W_p), float((W_k - W_p).abs().max())
        flips = float((k_k != k_p).double().mean())
        check(counts['cwt_bins_mixed'] >= 1 and counts['cwt_bins'] == 0
              and bool(torch.isfinite(torch.view_as_real(W_k)).all())
              and err <= tol and flips <= 0.01,
              "mixed B1 %s: the mixed counter only, max|Wx_kernel - "
              "Wx_plain| = %.3g of max|Wx| (limit %g), k differs on %.4f%% "
              "of cells (limit 1%%)" % (dtype, err, tol, 100 * flips))
        bins_criterion(scatter_kv_plain(W_k, k_k, cm, nbm),
                       scatter_kv_plain(W_p, k_p, cm, nbm),
                       "%s mixed B1" % dtype)
        del k_p
        W_r, k_r = cwt_bins(*argsm)
        check(torch.equal(W_r, W_k) and torch.equal(k_r, k_k),
              "mixed B1 %s repeat runs bit-identical" % dtype)
        del W_r, k_r
        mx[dtype] = dict(args=argsm, err=err_abs, c=cm, nb=nbm)
        for deriv in (False, True):
            (W3, dW3), counts = launches_of(all_kernels, lambda: cwt_fused(
                xhm, scm, wv, Nm, 0, Nm, 1., deriv, True))
            check(counts['cwt_fused_mixed'] >= 1 and counts['cwt_fused'] == 0
                  and torch.equal(W3, W_k), "mixed B3 %s (%s): the mixed "
                  "counter only, Wx bit-identical to B1's" % (
                      dtype, "Wx and dWx" if deriv else "Wx only"))
            if deriv:
                dW_p = cwt_fused_plain(xhm, scm, wv, Nm, 0, Nm, 1., True,
                                       True)[1]
                e3 = rel_err(dW3, dW_p)
                check(e3 <= tol, "mixed B3 %s: dWx %.3g of max|dWx| (limit "
                      "%g)" % (dtype, e3, tol))
                mx[dtype]['err3d'] = float((dW3 - dW_p).abs().max())
                del dW_p
            del W3, dW3
        mx[dtype]['err3'] = err_abs        # B3's Wx is B1's, bit for bit
        (W8, k8), counts = launches_of(all_kernels, lambda: cwt_bins2(
            xhm, scm, wv, Nm, 0, Nm, 1., pm, gamma, True))
        W8_p, k8_p = cwt_bins2_plain(xhm, scm, wv, Nm, 0, Nm, 1., pm, gamma,
                                     True)
        flips8 = float((k8 != k8_p).double().mean())
        check(counts['cwt_bins2_mixed'] >= 1 and counts['cwt_bins2'] == 0
              and torch.equal(W8, W_k) and flips8 <= 0.01,
              "mixed B8 %s: the mixed counter only, W bit-identical to B1's "
              "Wx, k differs on %.4f%% of cells (limit 1%%)"
              % (dtype, 100 * flips8))
        bins_criterion(scatter_kv_plain(W8, k8, cm, nbm),
                       scatter_kv_plain(W8_p, k8_p, cm, nbm),
                       "%s mixed B8" % dtype)
        mx[dtype]['err8'] = float((W8 - W8_p).abs().max())
        del W8, k8, W8_p, k8_p
        xh2 = torch.stack([xhm, rfft(torch.as_tensor(
            rngm.standard_normal(Nm), dtype=tdt, device=dev))]).contiguous()
        (Wb, kb), counts = launches_of(all_kernels, lambda: cwt_bins(
            xh2, *argsm[1:]))
        check(counts['cwt_bins_batched_mixed'] >= 1
              and counts['cwt_bins_batched'] == 0
              and torch.equal(Wb[0], W_k) and torch.equal(kb[0], k_k),
              "mixed B3b %s on a batch of two: the mixed batched counter "
              "only, row 0 bit-identical to its one-signal launch" % dtype)
        W1b, k1b = cwt_bins(xh2[1].contiguous(), *argsm[1:])
        check(torch.equal(Wb[1], W1b) and torch.equal(kb[1], k1b),
              "mixed B3b %s: row 1 bit-identical to its one-signal launch"
              % dtype)
        del Wb, kb, W1b, k1b, xh2, W_k, k_k, W_p
        torch.cuda.empty_cache()

    # ---- the w2 modes of B8 and B7 against their plain versions --------
    # B8's w2 mode on both engines with the bins mode's inputs (radix 4:
    # n_up = 262144, the bench's ssq_cwt2 plan; mixed: n_up = 160000,
    # unpadded), B7's at the ssq_stft2 headline and on the (4, 160000)
    # batch. W/V must be the bins mode's bits and the bins of w2 its k.
    def w2_check(what, run, plain, binned, params_w, flipud_w, c_w, nb_w,
                 need, batched=None):
        (W, w2), counts = launches_of(all_kernels, run)
        check(counts[need] >= 1 and sum(counts.values()) == counts[need],
              "%s: launched %s only (%d C calls)" % (what, need,
                                                     counts[need]))
        W_p, w2_p = plain()
        err = rel_err(W, W_p)
        gd = float((torch.isinf(w2) != torch.isinf(w2_p)).double().mean())
        check(err <= 2e-5 and gd <= 1e-3 and w2.dtype == torch.float32
              and bool((w2 >= 0).all()),
              "%s: max|W_kernel - W_plain| = %.3g of max|W| (limit 2e-5); "
              "w2 inf on other cells than the plain version's on %.4f%% "
              "(limit 0.1%%)" % (what, err, 100 * gd))
        k_w, v_w = compute_bins(w2, params_w, flipud_w)
        W_b, k_b = binned()
        n_diff = int((torch.where(v_w, k_w, torch.full_like(k_w, -1))
                      != k_b).sum())
        print("%s: the bins of w2 differ from the bins mode's k on %d "
              "cells (criterion: none)" % (what, n_diff), flush=True)
        check(torch.equal(W, W_b) and n_diff == 0, "%s: W bit-identical to "
              "the bins mode's, the bins of w2 equal to its k" % what)
        del W_b, k_b
        k_p, v_p = compute_bins(w2_p, params_w, flipud_w)
        bins_criterion(shift_scatter(W, k_w, v_w, nb_w, c_w),
                       shift_scatter_plain(W_p, k_p, v_p, nb_w, c_w),
                       "%s, B5 on the bins of w2" % what)
        if batched is not None:
            same = all(torch.equal(W[b], W1) and torch.equal(w2[b], w21)
                       for b in range(W.shape[0])
                       for W1, w21 in [batched(b)])
            check(same, "%s: every row bit-identical to its spectrum "
                  "launched alone" % what)
        out = float((W - W_p).abs().max())
        del W, w2, W_p, w2_p, k_w, v_w, k_p, v_p
        torch.cuda.empty_cache()
        return out

    w2k = {}
    a8 = b8['args']
    w2k['radix-4'] = dict(args=a8[:7] + (a8[8],))
    am = mx['float32']['args']
    w2k['mixed'] = dict(args=am[:7] + (am[9],))
    for eng, a, c_w, nb_w, need in (
            ('radix-4', a8, b8['c'], nbins2, 'cwt_w2'),
            ('mixed', am[:7] + am[8:], mx['float32']['c'],
             mx['float32']['nb'], 'cwt_w2_mixed')):
        aw = w2k[eng]['args']
        print("B8 w2 mode (cwt_w2) vs plain on the %s engine at (%d, %d), "
              "n_up=%d" % (eng, len(aw[1]), N, aw[3]), flush=True)
        w2k[eng]['err'] = w2_check(
            "B8 w2 mode, %s engine" % eng, lambda: cwt_w2(*aw),
            lambda: wsst2_rows(*aw), lambda: cwt_bins2(*a), a[7], True,
            c_w, nb_w, need)
    a7 = b7['args']
    w2k['b7'] = dict(args=a7[:4] + (a7[4]['Sfs'], a7[4]['gamma']))
    a7b = b7b['args']
    w2k['b7b'] = dict(args=a7b[:4] + (a7b[4]['Sfs'], a7b[4]['gamma']))
    for key, a, c_w, need in (('b7', a7, b7['c'], 'fsst2_w'),
                              ('b7b', a7b, b7b['c'], 'fsst2_w_batched')):
        aw = w2k[key]['args']
        what = "B7 w2 mode (fsst2_w) at %s" % (tuple(aw[0].shape),)
        print(what + " vs plain", flush=True)
        w2k[key]['err'] = w2_check(
            what, lambda: fsst2_w(*aw), lambda: fsst2_rows(*aw),
            lambda: fsst2_conv(*a), a[4]['params'], False, c_w, n_rows,
            need, batched=None if key == 'b7' else (
                lambda b: fsst2_w(aw[0][b].contiguous(), *aw[1:])))
    # the inputs stay in `w2k` and the kernels' dicts until they are timed
    del a, a7, a7b, a8, am, aw

    # ---- the main paths through the public API ----------------------------
    x_dev = torch.as_tensor(x_np, device=dev)
    gamma32 = 10 * float(np.finfo(np.float32).eps)   # ssq_cwt's default
    xb_dev = torch.as_tensor(xb_big, device=dev)
    kw = dict(wavelet=spec, scales=scales, ssq_freqs=ssq_freqs)
    calls = {
        'ssq_cwt': lambda: stq.ssq_cwt(x_dev, **kw),
        'ssq_stft': lambda: stq.ssq_stft(x_dev, n_fft=n_fft),
        'stft': lambda: stq.stft(x_dev, n_fft=n_fft),
        'cwt': lambda: stq.cwt(x_dev, wavelet=spec, scales=scales),
        'ssq_cwt2': lambda: stq.ssq_cwt2(x_dev, spec, scales=scales),
        'ssq_stft2': lambda: stq.ssq_stft2(x_dev, n_fft=n_fft),
        'ssq_cwt_b4': lambda: stq.ssq_cwt(xb_dev, **kw),
        'ssq_cwt_dwx': lambda: stq.ssq_cwt(x_dev, get_dWx=True, **kw),
        'ssq_stft_hop8': lambda: stq.ssq_stft(x_dev, n_fft=n_fft, hop_len=8),
        'ssq_cwt_getw': lambda: stq.ssq_cwt(x_dev, get_w=True, **kw),
        'ssq_cwt_dwx_lebesgue': lambda: stq.ssq_cwt(
            x_dev, get_dWx=True, squeezing='lebesgue', **kw),
        'ssq_stft_hop8_abs': lambda: stq.ssq_stft(x_dev, n_fft=n_fft,
                                                  hop_len=8, squeezing='abs'),
        'ssqueeze_w': lambda: stq.ssqueeze(
            sq_in['Wx'], w=sq_in['w'], scales=scales, ssq_freqs=ssq_freqs,
            flipud=True),
        'ssqueeze_dwx': lambda: stq.ssqueeze(
            sq_in['Wx_d'], dWx=sq_in['dWx'], gamma=gamma32, scales=scales,
            ssq_freqs=ssq_freqs, flipud=True),
        'ssq_stft_lebesgue': lambda: stq.ssq_stft(x_dev, n_fft=n_fft,
                                                  squeezing='lebesgue'),
        'ssq_cwt2_abs': lambda: stq.ssq_cwt2(x_dev, spec, scales=scales,
                                             squeezing='abs'),
        'ssq_stft2_lebesgue': lambda: stq.ssq_stft2(x_dev, n_fft=n_fft,
                                                    squeezing='lebesgue'),
        'stft_b4': lambda: stq.stft(xb_dev, n_fft=n_fft),
        'ssq_stft_b4': lambda: stq.ssq_stft(xb_dev, n_fft=n_fft),
        'ssq_stft_hop8_b4': lambda: stq.ssq_stft(xb_dev, n_fft=n_fft,
                                                 hop_len=8),
        'ssq_stft_hop8_abs_b4': lambda: stq.ssq_stft(
            xb_dev, n_fft=n_fft, hop_len=8, squeezing='abs'),
        'ssq_stft2_b4': lambda: stq.ssq_stft2(xb_dev, n_fft=n_fft),
        'ssq_cwt2_b4': lambda: stq.ssq_cwt2(xb_dev, spec, scales=scales),
        # unpadded (n_up = N, the mixed engine), the whole padded window,
        # the numeric phase transform
        'ssq_cwt_padnone': lambda: stq.ssq_cwt(x_dev, wavelet=spec,
                                               scales=scales, padtype=None),
        'ssq_cwt_padnone_b4': lambda: stq.ssq_cwt(
            xb_dev, wavelet=spec, scales=scales, padtype=None),
        'cwt_padnone': lambda: stq.cwt(x_dev, wavelet=spec, scales=scales,
                                       padtype=None),
        'cwt_rpadded': lambda: stq.cwt(x_dev, wavelet=spec, scales=scales,
                                       rpadded=True),
        'ssq_cwt_numeric': lambda: stq.ssq_cwt(
            x_dev, wavelet=spec, scales=scales, difftype='numeric',
            get_w=True),
        'ssq_cwt2_padnone': lambda: stq.ssq_cwt2(x_dev, spec, scales=scales,
                                                 padtype=None),
        # order 2 with w2 returned: the w2 modes of B8 (both engines) and
        # B7 (one signal and a batch), then B5 on the bins of w2
        'ssq_cwt2_getw': lambda: stq.ssq_cwt2(x_dev, spec, scales=scales,
                                              get_w=True),
        'ssq_cwt2_getw_padnone': lambda: stq.ssq_cwt2(
            x_dev, spec, scales=scales, padtype=None, get_w=True),
        'ssq_stft2_getw': lambda: stq.ssq_stft2(x_dev, n_fft=n_fft,
                                                get_w=True),
        'ssq_stft2_getw_b4': lambda: stq.ssq_stft2(xb_dev, n_fft=n_fft,
                                                   get_w=True),
    }
    # the w and Wx that `ssqueeze` reassigns: the get_w call's own
    sq_in = {}
    needs = {'ssq_cwt': ('cwt_bins', 'scatter_kv'),
             'ssq_stft': ('stft_conv', 'scatter_kv', 'stft_conv_banded'),
             'stft': ('stft_conv', 'stft_conv_banded'),
             'cwt': ('cwt_fused',),
             'ssq_cwt2': ('cwt_bins2', 'scatter_kv'),
             'ssq_stft2': ('fsst2_conv', 'scatter_kv', 'fsst2_conv_banded'),
             'ssq_cwt_b4': ('cwt_bins_batched', 'scatter_kv'),
             'ssq_cwt_dwx': ('cwt_fused', 'ssq_fused'),
             'ssq_stft_hop8': ('ssq_fused',),
             'ssq_cwt_getw': ('cwt_fused', 'shift_scatter'),
             'ssq_cwt_dwx_lebesgue': ('cwt_fused', 'shift_scatter'),
             'ssq_stft_hop8_abs': ('shift_scatter',),
             'ssqueeze_w': ('shift_scatter',),
             'ssqueeze_dwx': ('ssq_fused',),
             'ssq_stft_lebesgue': ('stft_conv', 'scatter_kv',
                                   'stft_conv_banded'),
             'ssq_cwt2_abs': ('cwt_bins2', 'scatter_kv'),
             'ssq_stft2_lebesgue': ('fsst2_conv', 'scatter_kv',
                                    'fsst2_conv_banded'),
             'stft_b4': ('stft_conv_batched', 'stft_conv_batched_banded'),
             'ssq_stft_b4': ('stft_conv_batched', 'scatter_kv',
                             'stft_conv_batched_banded'),
             'ssq_stft_hop8_b4': ('ssq_fused',),
             'ssq_stft_hop8_abs_b4': ('shift_scatter',),
             'ssq_stft2_b4': ('fsst2_conv_batched', 'scatter_kv',
                              'fsst2_conv_batched_banded'),
             'ssq_cwt2_b4': ('cwt_bins2_batched', 'scatter_kv'),
             'ssq_cwt_padnone': ('cwt_bins_mixed', 'scatter_kv'),
             'ssq_cwt_padnone_b4': ('cwt_bins_batched_mixed', 'scatter_kv'),
             'cwt_padnone': ('cwt_fused_mixed',),
             'cwt_rpadded': ('cwt_fused',),
             'ssq_cwt_numeric': ('cwt_fused', 'shift_scatter'),
             'ssq_cwt2_padnone': ('cwt_bins2_mixed', 'scatter_kv'),
             'ssq_cwt2_getw': ('cwt_w2', 'shift_scatter'),
             'ssq_cwt2_getw_padnone': ('cwt_w2_mixed', 'shift_scatter'),
             'ssq_stft2_getw': ('fsst2_w', 'shift_scatter',
                                'fsst2_w_banded'),
             'ssq_stft2_getw_b4': ('fsst2_w_batched', 'shift_scatter',
                                   'fsst2_w_batched_banded')}
    # kernels a path must not launch: get_w takes no bins kernel, a batch
    # no one-signal launch of B6, B7 or B8
    avoids = {'ssq_cwt_getw': ('cwt_bins', 'cwt_bins_batched', 'scatter_kv',
                               'ssq_fused')}
    avoids.update((name, ('stft_conv', 'fsst2_conv', 'cwt_bins2'))
                  for name in calls if name.endswith('_b4'))
    # an unpadded call takes the mixed engine only, a padded one (the
    # numeric route, the whole window) the radix-4 engine only
    radix4 = ('cwt_bins', 'cwt_fused', 'cwt_bins2', 'cwt_bins_batched',
              'cwt_bins2_batched')
    mixed = tuple(name + '_mixed' for name in radix4)
    for name in ('ssq_cwt_padnone', 'ssq_cwt_padnone_b4', 'cwt_padnone',
                 'ssq_cwt2_padnone'):
        avoids[name] = avoids.get(name, ()) + radix4
    avoids['cwt_rpadded'] = mixed
    avoids['ssq_cwt_numeric'] = mixed + ('cwt_bins', 'scatter_kv',
                                         'ssq_fused')
    # get_w of order 2: no bins mode, no B2, the other engine's or the
    # one-signal w2 launch neither
    bins_modes = tuple(name for name, _, _ in all_kernels if name.split(
        '_batched')[0].split('_mixed')[0] in ('cwt_bins', 'cwt_bins2',
                                              'stft_conv', 'fsst2_conv'))
    for name, other in (('ssq_cwt2_getw', 'cwt_w2_mixed'),
                        ('ssq_cwt2_getw_padnone', 'cwt_w2'),
                        ('ssq_stft2_getw', 'fsst2_w_batched'),
                        ('ssq_stft2_getw_b4', 'fsst2_w')):
        avoids[name] = avoids.get(name, ()) + bins_modes + (
            'scatter_kv', 'ssq_fused', other)
    # no public call on the card may run a plain version: the order-2 ones
    # (the w2 modes' plain versions) count their calls here
    from ssqueezepy_tpu_torch.ops import cwt_cuda as cwt_mod, \
        stft_cuda as stft_mod
    plain_calls = types.SimpleNamespace(wsst2_rows=0, fsst2_rows=0)
    for mod, fn in ((cwt_mod, wsst2_rows), (stft_mod, fsst2_rows)):
        def shim(*a, _fn=fn, **k):
            setattr(plain_calls, _fn.__name__,
                    getattr(plain_calls, _fn.__name__) + 1)
            return _fn(*a, **k)
        setattr(mod, fn.__name__, shim)
    plain_kernels = [(name, plain_calls, name)
                     for name in ('wsst2_rows', 'fsst2_rows')]
    for name in calls:
        avoids[name] = avoids.get(name, ()) + ('wsst2_rows', 'fsst2_rows')
    # the plans and spectra the unpadded and numeric calls' plain paths
    # take: the plan without padding (was_padded=False) and with it
    wv32 = resolve_wavelet(spec, N=N)
    plan0, _ = _ssq_cwt_plan(wv32, N, scales, None, None, 'peak', False, 1.)
    planR, _ = _ssq_cwt_plan(wv32, N, scales, None, None, 'peak', True, 1.)
    sc32 = torch.as_tensor(scales.ravel(), dtype=torch.float32, device=dev)

    def consts(pl):
        return (torch.as_tensor(np.broadcast_to(np.ravel(pl.const),
                                                (na,)).copy(),
                                dtype=torch.float32, device=dev),
                pl.params, pl.params['omax'] + 1)
    # get_w of order 2: (the w2 mode's inputs in `w2k`, the same call
    # without get_w)
    w2_calls = {'ssq_cwt2_getw': ('radix-4', 'ssq_cwt2'),
                'ssq_cwt2_getw_padnone': ('mixed', 'ssq_cwt2_padnone'),
                'ssq_stft2_getw': ('b7', 'ssq_stft2'),
                'ssq_stft2_getw_b4': ('b7b', 'ssq_stft2_b4')}
    launches = dict.fromkeys((name for name, _, _ in all_kernels
                              + plain_kernels), 0)
    stft_b67 = [k + sfx for k in ('stft_conv', 'fsst2_conv', 'fsst2_w')
                for sfx in ('', '_batched')]
    for name, fn in calls.items():
        fn()                                  # plan memo + first launch
        torch.cuda.synchronize()
        out, counts = launches_of(all_kernels + plain_kernels, fn)
        check(all(counts[kn] >= 1 for kn in needs[name])
              and not any(counts[kn] for kn in avoids.get(name, ())),
              "%s at N=%d launched its kernels: %s" % (name, N, counts))
        # the float32 hop-1 STFT family on banded tables only: every B6/B7
        # launch of the call is a banded one
        full = {kn: counts[kn] - counts[kn + '_banded'] for kn in stft_b67
                if counts[kn] != counts[kn + '_banded']}
        check(not full, "%s: every B6/B7 launch on banded tables (full-"
              "table launches: %s)" % (name, full or 'none'))
        for kn, v in counts.items():
            launches[kn] += v
        if name == 'ssq_cwt':
            Tx, Wx_pub = out[0], out[1]
            check(Tx.shape == (nbins, N) and Wx_pub.shape == (na, N)
                  and bool(torch.isfinite(torch.view_as_real(Tx)).all()),
                  "ssq_cwt: Tx (%d, %d), Wx (%d, %d), finite"
                  % (Tx.shape + Wx_pub.shape))
            wv, xh, sc, c, gamma = kernel_inputs('float32')
            Wx_p, k_p = cwt_bins_plain(xh, sc, wv, n_up, n1, N, 1., True,
                                       params, gamma, True)
            bins_criterion(Tx, scatter_kv_plain(Wx_p, k_p, c, nbins),
                           "public ssq_cwt vs plain path")
            del Wx_p, k_p, Wx_pub, Tx
        elif name == 'ssq_stft':
            Tx, Sx = out[0], out[1]
            check(Tx.shape == (n_rows, N) and Sx.shape == (n_rows, N)
                  and bool(torch.isfinite(torch.view_as_real(Tx)).all()),
                  "ssq_stft: Tx, Sx (%d, %d), finite" % Tx.shape)
            xh6, H, Hd, bins6, c6 = stft_inputs(N, 'float32', x_np)
            Sx_p, k_p = stft_conv_plain(xh6, H, Hd, N, 1., bins6)
            check(rel_err(Sx, Sx_p) <= 2e-5, "public ssq_stft: Sx %.3g of "
                  "max vs the plain path" % rel_err(Sx, Sx_p))
            bins_criterion(Tx, scatter_kv_plain(Sx_p, k_p, c6, n_rows),
                           "public ssq_stft vs plain path")
            del Tx, Sx, Sx_p, k_p, xh6, H, Hd
        elif name == 'stft':
            xh6, H = stft_inputs(N, 'float32', x_np)[:2]
            Sx_p = stft_conv_plain(xh6, H, None, N)[0]
            check(out.shape == (n_rows, N) and rel_err(out, Sx_p) <= 2e-5,
                  "public stft: Sx (%d, %d), %.3g of max vs the plain path"
                  % (tuple(out.shape) + (rel_err(out, Sx_p),)))
            del Sx_p, xh6, H
        elif name == 'cwt':
            Wx_c = out[0]
            W_p = cwt_fused_plain(*b3['args'])[0]
            check(Wx_c.shape == (na, N) and rel_err(Wx_c, W_p) <= 2e-5,
                  "public cwt: Wx (%d, %d), %.3g of max vs the plain path"
                  % (tuple(Wx_c.shape) + (rel_err(Wx_c, W_p),)))
            del W_p, Wx_c
        elif name == 'ssq_cwt2':
            Tx, Wx_pub = out[0], out[1]
            check(Tx.shape == (nbins2, N) and Wx_pub.shape == (na, N)
                  and bool(torch.isfinite(torch.view_as_real(Tx)).all()),
                  "ssq_cwt2: Tx (%d, %d), Wx (%d, %d), finite"
                  % (Tx.shape + Wx_pub.shape))
            W_p, k_p = cwt_bins2_plain(*b8['args'])
            check(rel_err(Wx_pub, W_p) <= 2e-5, "public ssq_cwt2: Wx %.3g of "
                  "max vs the plain path" % rel_err(Wx_pub, W_p))
            bins_criterion(Tx, scatter_kv_plain(W_p, k_p, b8['c'], nbins2),
                           "public ssq_cwt2 vs plain path")
            del Tx, Wx_pub, W_p, k_p
        elif name == 'ssq_cwt_b4':
            Tx, Wx_pub = out[0], out[1]
            check(Tx.shape == (B4N, nbins, N) and Wx_pub.shape == (B4N, na, N)
                  and bool(torch.isfinite(torch.view_as_real(Tx)).all()),
                  "batched ssq_cwt: Tx %s, Wx %s, finite"
                  % (tuple(Tx.shape), tuple(Wx_pub.shape)))
            W_p, k_p = cwt_bins_plain(*b3b['args'])
            check(rel_err(Wx_pub, W_p) <= 2e-5, "batched ssq_cwt: Wx %.3g "
                  "of max vs the plain path" % rel_err(Wx_pub, W_p))
            del Wx_pub
            bins_criterion(Tx, scatter_kv_plain(W_p, k_p, b3b['c'], nbins),
                           "public batched ssq_cwt vs plain path")
            del Tx, W_p, k_p
        elif name == 'ssq_cwt_dwx':
            Tx, Wx_pub, dWx_pub = out[0], out[1], out[4]
            check(len(out) == 5 and Tx.shape == (nbins, N)
                  and dWx_pub.shape == (na, N)
                  and bool(torch.isfinite(torch.view_as_real(Tx)).all()),
                  "ssq_cwt(get_dWx=True): Tx (%d, %d), dWx (%d, %d), finite"
                  % (Tx.shape + dWx_pub.shape))
            wv, xh, sc, c, gamma = kernel_inputs('float32')
            W_p, dW_p = cwt_fused_plain(xh, sc, wv, n_up, n1, N, 1., True,
                                        True)
            check(rel_err(dWx_pub, dW_p) <= 2e-5, "ssq_cwt(get_dWx=True): "
                  "dWx %.3g of max vs the plain path" % rel_err(dWx_pub, dW_p))
            bins_criterion(Tx, ssq_fused_plain(W_p, dW_p, c, params, gamma,
                                               True),
                           "public ssq_cwt(get_dWx=True) vs plain path")
            sq_in.update(Wx_d=Wx_pub, dWx=dWx_pub, Tx_d=Tx)
            del Tx, Wx_pub, dWx_pub, W_p, dW_p, xh
        elif name == 'ssq_stft_hop8':
            Tx, Sx = out[0], out[1]
            n_segs = -(-N // 8)
            check(Tx.shape == (n_rows, n_segs) and Sx.shape == (n_rows, n_segs)
                  and bool(torch.isfinite(torch.view_as_real(Tx)).all()),
                  "ssq_stft(hop_len=8): Tx, Sx (%d, %d), finite" % Tx.shape)
            bins6, c6 = stft_inputs(N, 'float32', x_np)[3:]
            Sx_p, dSx_p = stq.stft(x_dev, n_fft=n_fft, hop_len=8,
                                   derivative=True)
            bins_criterion(Tx, ssq_fused_plain(
                Sx_p.contiguous(), dSx_p.contiguous(), c6, bins6['params'],
                bins6['gamma'], False, bins6['Sfs']),
                "public ssq_stft(hop_len=8) vs plain path")
            del Tx, Sx, Sx_p, dSx_p
        elif name in ('ssq_cwt_getw', 'ssq_cwt_dwx_lebesgue'):
            getw = name == 'ssq_cwt_getw'
            Tx, Wx_pub, extra = out[0], out[1], out[4]
            check(len(out) == 5 and Tx.shape == (nbins, N)
                  and extra.shape == (na, N)
                  and bool(torch.isfinite(torch.view_as_real(Tx)).all()),
                  "%s: Tx (%d, %d), %s (%d, %d), finite"
                  % ((name,) + tuple(Tx.shape) + ('w' if getw else 'dWx',)
                     + tuple(extra.shape)))
            wv, xh, sc, c, gamma = kernel_inputs('float32')
            W_p, dW_p = cwt_fused_plain(xh, sc, wv, n_up, n1, N, 1., True,
                                        True)
            check(rel_err(Wx_pub, W_p) <= 2e-5, "%s: Wx %.3g of max vs the "
                  "plain path" % (name, rel_err(Wx_pub, W_p)))
            w_p = phase_cwt(W_p, dW_p, 'trig', gamma)
            k_p, v_p = compute_bins(w_p, params, True)
            vals = W_p if getw else torch.full_like(W_p, 1. / na)
            bins_criterion(Tx, shift_scatter_plain(vals, k_p, v_p, nbins, c),
                           "public %s vs plain path" % name)
            if getw:
                gd = float((torch.isinf(extra) != torch.isinf(w_p))
                           .double().mean())
                check(gd <= 1e-3, "ssq_cwt(get_w=True): w gated on the plain "
                      "path's cells but %.4f%% (limit 0.1%%: |Wx| near gamma "
                      "in float32)" % (100 * gd))
                Tx_fast = calls['ssq_cwt']()[0]
                bins_criterion(Tx, Tx_fast, "ssq_cwt(get_w=True) Tx vs the "
                               "fast (bins) route's Tx")
                sq_in.update(Wx=Wx_pub, w=extra, Tx=Tx)
                del Tx_fast
            del Tx, Wx_pub, extra, W_p, dW_p, w_p, k_p, v_p, vals, xh
        elif name == 'ssq_stft_hop8_abs':
            Tx, Sx = out[0], out[1]
            n_segs = -(-N // 8)
            check(Tx.shape == (n_rows, n_segs)
                  and bool(torch.isfinite(torch.view_as_real(Tx)).all()),
                  "ssq_stft(hop_len=8, squeezing='abs'): Tx (%d, %d), "
                  "finite" % Tx.shape)
            bins6, c6 = stft_inputs(N, 'float32', x_np)[3:]
            Sx_p, dSx_p = stq.stft(x_dev, n_fft=n_fft, hop_len=8,
                                   derivative=True)
            k_p, v_p = compute_bins(phase_stft(Sx_p, dSx_p, bins6['Sfs'],
                                               bins6['gamma']),
                                    bins6['params'], False)
            bins_criterion(Tx, shift_scatter_plain(
                Sx_p.abs().to(Sx_p.dtype), k_p, v_p, n_rows, c6),
                "public ssq_stft(hop_len=8, squeezing='abs') vs plain path")
            del Tx, Sx, Sx_p, dSx_p, k_p, v_p
        elif name == 'ssqueeze_w':
            Tx, fr = out
            check(torch.equal(Tx, sq_in['Tx']), "ssqueeze(Wx, w=w) "
                  "bit-identical to ssq_cwt(get_w=True)'s Tx on its w")
            del Tx
            sq_in.pop('Tx')
        elif name == 'ssqueeze_dwx':
            Tx, fr = out
            check(torch.equal(Tx, sq_in['Tx_d']), "ssqueeze(Wx, dWx=dWx) "
                  "bit-identical to ssq_cwt(get_dWx=True)'s Tx")
            del Tx
            for key in ('Wx_d', 'dWx', 'Tx_d'):
                sq_in.pop(key)
        elif name in ('ssq_stft_lebesgue', 'ssq_cwt2_abs',
                      'ssq_stft2_lebesgue'):
            Tx, W_pub = out[0], out[1]
            if name == 'ssq_stft_lebesgue':
                xh6, H, Hd, bins6, c6 = stft_inputs(N, 'float32', x_np)
                W_p, k_p = stft_conv_plain(xh6, H, Hd, N, 1., bins6)
                cp, nb = c6, n_rows
                del xh6, H, Hd
            elif name == 'ssq_cwt2_abs':
                W_p, k_p = cwt_bins2_plain(*b8['args'])
                cp, nb = b8['c'], nbins2
            else:
                W_p, k_p = fsst2_conv_plain(*b7['args'])
                cp, nb = b7['c'], n_rows
            check(Tx.shape == (nb, N) and rel_err(W_pub, W_p) <= 2e-5
                  and bool(torch.isfinite(torch.view_as_real(Tx)).all()),
                  "%s: Tx (%d, %d), finite; W %.3g of max vs the plain path"
                  % ((name,) + tuple(Tx.shape) + (rel_err(W_pub, W_p),)))
            vals = (W_p.abs().to(W_p.dtype) if name == 'ssq_cwt2_abs'
                    else torch.full_like(W_p, 1. / W_p.shape[0]))
            bins_criterion(Tx, scatter_kv_plain(vals, k_p, cp, nb),
                           "public %s vs plain path" % name)
            del Tx, W_pub, W_p, k_p, vals
        elif name == 'stft_b4':
            xh6, H = stft_inputs(N, 'float32', xb_big)[:2]
            Sx_p = stft_conv_plain(xh6, H, None, N)[0]
            check(out.shape == (B4N, n_rows, N)
                  and rel_err(out, Sx_p) <= 2e-5,
                  "public batched stft: Sx %s, %.3g of max vs the plain "
                  "path" % (tuple(out.shape), rel_err(out, Sx_p)))
            del Sx_p, xh6, H
        elif name in ('ssq_stft_b4', 'ssq_stft2_b4', 'ssq_cwt2_b4'):
            Tx, W_pub = out[0], out[1]
            if name == 'ssq_stft_b4':
                xh6, H, Hd, bins6, c6 = stft_inputs(N, 'float32', xb_big)
                W_p, k_p = stft_conv_plain(xh6, H, Hd, N, 1., bins6)
                cp, nb = c6, n_rows
                del xh6, H, Hd
            elif name == 'ssq_stft2_b4':
                W_p, k_p = fsst2_conv_plain(*b7b['args'])
                cp, nb = b7b['c'], n_rows
            else:
                W_p, k_p = cwt_bins2_plain(*b8b['args'])
                cp, nb = b8b['c'], nbins2
            check(Tx.shape == (B4N, nb, N) and W_pub.shape == W_p.shape
                  and rel_err(W_pub, W_p) <= 2e-5
                  and bool(torch.isfinite(torch.view_as_real(Tx)).all()),
                  "batched %s: Tx %s, finite; W %s, %.3g of max vs the "
                  "plain path" % (name[:-3], tuple(Tx.shape),
                                  tuple(W_pub.shape), rel_err(W_pub, W_p)))
            bins_criterion(Tx, scatter_kv_plain(W_p, k_p, cp, nb),
                           "public batched %s vs plain path" % name[:-3])
            del Tx, W_pub, W_p, k_p
        elif name in ('ssq_stft_hop8_b4', 'ssq_stft_hop8_abs_b4'):
            Tx, Sx = out[0], out[1]
            n_segs = -(-N // 8)
            check(Tx.shape == (B4N, n_rows, n_segs)
                  and Sx.shape == (B4N, n_rows, n_segs)
                  and bool(torch.isfinite(torch.view_as_real(Tx)).all()),
                  "batched %s: Tx, Sx %s, finite"
                  % (name[:-3], tuple(Tx.shape)))
            bins6, c6 = stft_inputs(N, 'float32', x_np)[3:]
            Sx_p, dSx_p = stq.stft(xb_dev, n_fft=n_fft, hop_len=8,
                                   derivative=True)
            Sx_p, dSx_p = Sx_p.contiguous(), dSx_p.contiguous()
            if name == 'ssq_stft_hop8_b4':
                Tx_p = ssq_fused_plain(Sx_p, dSx_p, c6, bins6['params'],
                                       bins6['gamma'], False, bins6['Sfs'])
            else:
                k_p, v_p = compute_bins(phase_stft(Sx_p, dSx_p, bins6['Sfs'],
                                                   bins6['gamma']),
                                        bins6['params'], False)
                Tx_p = shift_scatter_plain(Sx_p.abs().to(Sx_p.dtype), k_p,
                                           v_p, n_rows, c6)
                del k_p, v_p
            bins_criterion(Tx, Tx_p, "public batched %s vs plain path"
                           % name[:-3])
            del Tx, Sx, Sx_p, dSx_p, Tx_p
        elif name in ('ssq_cwt_padnone', 'ssq_cwt_padnone_b4',
                      'ssq_cwt2_padnone'):
            Tx, W_pub = out[0], out[1]
            c0, p0, nb0 = consts(plan0)
            xh0 = rfft(xb_dev if name.endswith('_b4')
                       else x_dev).contiguous()
            lead = (B4N,) if name.endswith('_b4') else ()
            if name == 'ssq_cwt2_padnone':
                W_p, k_p = cwt_bins2_plain(xh0, sc32, wv32, N, 0, N, 1., p0,
                                           gamma32, True)
            else:
                W_p, k_p = cwt_bins_plain(xh0, sc32, wv32, N, 0, N, 1., True,
                                          p0, gamma32, True)
            check(Tx.shape == lead + (nb0, N) and W_pub.shape == W_p.shape
                  and rel_err(W_pub, W_p) <= 2e-5
                  and bool(torch.isfinite(torch.view_as_real(Tx)).all()),
                  "%s: Tx %s, finite; Wx %.3g of max vs the plain path"
                  % (name, tuple(Tx.shape), rel_err(W_pub, W_p)))
            bins_criterion(Tx, scatter_kv_plain(W_p, k_p, c0, nb0),
                           "public %s vs plain path" % name)
            del Tx, W_pub, W_p, k_p, xh0
        elif name in ('cwt_padnone', 'cwt_rpadded'):
            Wx_c = out[0]
            if name == 'cwt_padnone':
                xh0, nu, lo, nn = rfft(x_dev).contiguous(), N, 0, N
            else:
                xh0, nu, lo, nn = b3['args'][0], n_up, 0, n_up
            W_p = cwt_fused_plain(xh0, sc32, wv32, nu, lo, nn, 1., False,
                                  True)[0]
            check(Wx_c.shape == (na, nn) and rel_err(Wx_c, W_p) <= 2e-5,
                  "public %s: Wx (%d, %d), %.3g of max vs the plain path"
                  % ((name,) + tuple(Wx_c.shape) + (rel_err(Wx_c, W_p),)))
            del Wx_c, W_p, xh0
        elif name == 'ssq_cwt_numeric':
            Tx, Wx_pub, w_pub = out[0], out[1], out[4]
            cR, pR, nbR = consts(planR)
            check(len(out) == 5 and Tx.shape == (nbR, N)
                  and Wx_pub.shape == (na, N) and w_pub.shape == (na, N)
                  and bool(torch.isfinite(torch.view_as_real(Tx)).all()),
                  "ssq_cwt(difftype='numeric', get_w=True): Tx (%d, %d), Wx "
                  "and w (%d, %d), finite" % (Tx.shape + Wx_pub.shape))
            W_p = cwt_fused_plain(b3['args'][0], sc32, wv32, n_up, 0,
                                  n_up, 1., False, True)[0]
            W_s = W_p[:, n1 - 4:n1 + N + 4]
            w_p = phase_cwt_num(W_s, 1., 4, gamma32)
            k_p, v_p = compute_bins(w_p, pR, True)
            Tx_p = shift_scatter_plain(W_s.contiguous(), k_p, v_p, nbR,
                                       cR)[:, 4:-4]
            check(rel_err(Wx_pub, W_s[:, 4:-4]) <= 2e-5,
                  "ssq_cwt(difftype='numeric'): Wx %.3g of max vs the plain "
                  "path" % rel_err(Wx_pub, W_s[:, 4:-4]))
            bins_criterion(Tx, Tx_p, "public ssq_cwt(difftype='numeric') vs "
                           "plain path")
            gd = float((torch.isinf(w_pub) != torch.isinf(w_p[:, 4:-4]))
                       .double().mean())
            check(gd <= 1e-3, "ssq_cwt(difftype='numeric'): w gated on the "
                  "plain path's cells but %.4f%% (limit 0.1%%)" % (100 * gd))
            del Tx, Wx_pub, w_pub, W_p, W_s, w_p, k_p, v_p, Tx_p
        elif name in w2_calls:
            key, base = w2_calls[name]
            Tx, W_pub, w2_pub = out[0], out[1], out[4]
            aw = w2k[key]['args']
            if name.startswith('ssq_cwt2'):
                W_p, w2_p = wsst2_rows(*aw)
                params_w, flip_w, c_w, nb_w = (
                    (b8['args'][7], True, b8['c'], nbins2) if key == 'radix-4'
                    else (mx['float32']['args'][8], True, mx['float32']['c'],
                          mx['float32']['nb']))
            else:
                W_p, w2_p = fsst2_rows(*aw)
                params_w, flip_w, c_w, nb_w = (b7['args'][4]['params'], False,
                                               b7['c'], n_rows)
            gd = float((torch.isinf(w2_pub) != torch.isinf(w2_p))
                       .double().mean())
            check(len(out) == 5 and Tx.shape == W_p.shape[:-2] + (nb_w, N)
                  and W_pub.shape == w2_pub.shape == W_p.shape
                  and rel_err(W_pub, W_p) <= 2e-5 and gd <= 1e-3
                  and bool(torch.isfinite(torch.view_as_real(Tx)).all()),
                  "%s: Tx %s, finite; W %.3g of max vs the plain path; w2 %s,"
                  " inf on other cells than the plain path's on %.4f%% "
                  "(limit 0.1%%)" % (name, tuple(Tx.shape),
                                     rel_err(W_pub, W_p),
                                     tuple(w2_pub.shape), 100 * gd))
            k_p, v_p = compute_bins(w2_p, params_w, flip_w)
            bins_criterion(Tx, shift_scatter_plain(W_p, k_p, v_p, nb_w, c_w),
                           "public %s vs plain path" % name)
            del W_p, w2_p, k_p, v_p
            bins_criterion(Tx, calls[base]()[0], "%s: Tx vs the same call "
                           "without get_w (%s)" % (name, base))
            del Tx, W_pub, w2_pub
        else:
            Tx, Sx = out[0], out[1]
            check(Tx.shape == (n_rows, N) and Sx.shape == (n_rows, N)
                  and bool(torch.isfinite(torch.view_as_real(Tx)).all()),
                  "ssq_stft2: Tx, Sx (%d, %d), finite" % Tx.shape)
            V_p, k_p = fsst2_conv_plain(*b7['args'])
            check(rel_err(Sx, V_p) <= 2e-5, "public ssq_stft2: Sx %.3g of "
                  "max vs the plain path" % rel_err(Sx, V_p))
            bins_criterion(Tx, scatter_kv_plain(V_p, k_p, b7['c'], n_rows),
                           "public ssq_stft2 vs plain path")
            del Tx, Sx, V_p, k_p
        del out
        torch.cuda.empty_cache()

    # ---- lengths with a prime factor above 7: the general route ---------
    for kn, v in prime_length_section(stq, dev, card, all_kernels).items():
        launches[kn] += v
    torch.cuda.empty_cache()

    # ---- the kernels' ceilings: one rule on every device -----------------
    # each kernel wrapper called just past its rule raises the same error
    # naming C1b on the card and on the CPU, before any launch (the public
    # calls take their general routes there: section 12i): the CWT
    # kernel's for two planes at n_up = 10^7 and five at 2,000,000 in
    # float64 (the mixed engine), the STFT kernel's past 2^22 and for five
    # planes at 1310720 in float64, the scatters' past 25600 bins
    wav64 = resolve_wavelet(('gmw', {'dtype': 'float64'}))
    c1b_params = ssq_bin_params(np.linspace(.01, .4, 25601), False)

    def past_rules(d):
        sc2 = torch.tensor([4., 8.], dtype=torch.float64, device=d)
        xh7 = torch.empty(10 ** 7 // 2 + 1, dtype=torch.complex128,
                          device=d)
        xh2m = torch.empty(1000001, dtype=torch.complex128, device=d)
        xh22 = torch.empty(9 << 19, dtype=torch.complex64, device=d)
        xh5 = torch.empty(1310720, dtype=torch.complex128, device=d)
        tab5 = torch.empty((5, 1, 1310720), dtype=torch.complex128,
                           device=d)
        sfs = torch.zeros(1, dtype=torch.float64, device=d)
        bins5 = dict(Sfs=sfs, params=ssq_bin_params(np.arange(4.), False),
                     gamma=1e-10, flipud=False)
        v = torch.zeros((3, 8), dtype=torch.complex64, device=d)
        k = torch.zeros((3, 8), dtype=torch.int32, device=d)
        c = torch.ones(3, device=d)
        return (
            ('cwt_bins, n_up = 10^7, float64', lambda: cwt_bins(
                xh7, sc2, wav64, 10 ** 7, 0, 8, 1., True, c1b_params, 1e-10,
                False)),
            ('cwt_fused with dWx, n_up = 10^7, float64', lambda: cwt_fused(
                xh7, sc2, wav64, 10 ** 7, 0, 8, 1., True, True)),
            ('cwt_bins2, n_up = 2,000,000, float64', lambda: cwt_bins2(
                xh2m, sc2, wav64, 2000000, 0, 8, 1., c1b_params, 1e-10,
                False)),
            ('cwt_w2, n_up = 2,000,000, float64', lambda: cwt_w2(
                xh2m, sc2, wav64, 2000000, 0, 8, 1., 1e-10)),
            ('stft_conv, Np2 = 9 x 2^19', lambda: stft_conv(
                xh22, torch.empty((1, 9 << 19), dtype=torch.complex64,
                                  device=d), None, 8)),
            ('fsst2_conv, Np2 = 1310720, float64', lambda: fsst2_conv(
                xh5, tab5, 8, 1., bins5)),
            ('fsst2_w, Np2 = 1310720, float64', lambda: fsst2_w(
                xh5, tab5, 8, 1., sfs, 1e-10)),
            ('scatter_kv, nbins = 25601', lambda: scatter_kv(
                v, k, c, 25601)),
            ('ssq_fused, nbins = 25601', lambda: ssq_fused(
                v, v, c, c1b_params, 1e-6, False)),
            ('shift_scatter, nbins = 25601', lambda: shift_scatter(
                v, k, None, 25601, c)))
    msgs = {}
    for d in ('cuda', 'cpu'):
        for what, fn in past_rules(d):
            def refused():
                try:
                    fn()
                except NotImplementedError as e:
                    return str(e)
                return None
            msg, counts = launches_of(all_kernels, refused)
            check(msg is not None and 'ROADMAP.md queue C, C1b' in msg
                  and not any(counts.values()), "%s on device=%r raises "
                  "naming C1b, launching nothing" % (what, d))
            check(msgs.setdefault(what, msg) == msg,
                  "%s: the same error on both devices" % what)
    torch.cuda.empty_cache()

    # ---- the radix-4 engine at its largest lengths, public calls ---------
    # cwt(padtype=None) at n_up = 2^28 (one plane; three scales, the
    # fewest the scale inference takes) and ssq_cwt2(padtype=None) at
    # n_up = 2^24 (five planes, eight scales), float32, against the plain
    # path on the card
    sc3 = np.array([4., 16., 64.])
    sc8s = 2. ** (2 + np.arange(8) / 4)
    for lg, what in ((28, 'cwt'), (24, 'ssq_cwt2')):
        nl = 1 << lg
        xl = torch.randn(nl, generator=torch.Generator(
            device=dev).manual_seed(lg), device=dev)
        wvl = resolve_wavelet(spec, N=nl)
        if what == 'cwt':
            t1 = time.perf_counter()
            out, counts = launches_of(all_kernels, lambda: stq.cwt(
                xl, wavelet=spec, scales=sc3, nv=None, padtype=None))
            t1 = time.perf_counter() - t1
            Wl = out[0]
            check(counts['cwt_fused'] >= 1
                  and sum(counts.values()) == counts['cwt_fused'],
                  "cwt(padtype=None) at n_up=2^28: the radix-4 engine only "
                  "(%d C calls: one row fills the 2 GiB scratch)"
                  % counts['cwt_fused'])
            xhl = rfft(xl)
            del xl
            W_p = cwt_fused_plain(xhl, torch.as_tensor(
                sc3, dtype=torch.float32, device=dev), wvl, nl, 0, nl, 1.,
                False, True)[0]
            err = rel_err(Wl, W_p)
            check(Wl.shape == (3, nl) and err <= 2e-5,
                  "cwt(padtype=None) at n_up=2^28=%dx%d, 3 scales: Wx %s, "
                  "max|Wx - Wx_plain| = %.3g of max (limit 2e-5); %.3f s "
                  "for the call with its first launch; card: %s"
                  % (four_step(nl) + (tuple(Wl.shape), err, t1, card)))
            del Wl, W_p, out, xhl
        else:
            out, counts = launches_of(all_kernels, lambda: stq.ssq_cwt2(
                xl, spec, scales=sc8s, padtype=None))
            check(counts['cwt_bins2'] >= 1 and counts['scatter_kv'] == 1,
                  "ssq_cwt2(padtype=None) at n_up=2^24: B8 on the radix-4 "
                  "engine and B2 (%s)" % counts)
            pll, _ = _ssq_cwt_plan(wvl, nl, sc8s, None, None, 'peak', False,
                                   1.)
            scl = torch.as_tensor(pll.scales.ravel(), dtype=torch.float32,
                                  device=dev)
            cl = torch.as_tensor(np.broadcast_to(np.ravel(pll.const),
                                                 (len(scl),)).copy(),
                                 dtype=torch.float32, device=dev)
            W_p, k_p = cwt_bins2_plain(rfft(xl), scl, wvl, nl, 0, nl, 1.,
                                       pll.params, gamma32, True)
            err = rel_err(out[1], W_p)
            check(out[1].shape == (8, nl) and err <= 2e-5,
                  "ssq_cwt2(padtype=None) at n_up=2^24=%dx%d, 8 scales: W "
                  "%.3g of max vs the plain path (limit 2e-5); card: %s"
                  % (four_step(nl) + (err, card)))
            bins_criterion(out[0], scatter_kv_plain(
                W_p, k_p, cl, pll.params['omax'] + 1),
                "ssq_cwt2(padtype=None) at n_up=2^24 vs plain path")
            del out, W_p, k_p, xl
        torch.cuda.empty_cache()

    # ---- round trips -------------------------------------------------------
    Nc7 = 19600                           # 2^4 5^2 7^2: unpadded, mixed
    tc7 = np.linspace(0, 6, Nc7, endpoint=False)
    xc7 = np.cos(2 * np.pi * 2 * np.exp(tc7 / 2)).astype(np.float32)
    out, counts = launches_of(all_kernels,
                              lambda: stq.ssq_cwt(xc7, padtype=None)[0])
    mad = float(stq.toolkit.mad_rms(xc7, stq.issq_cwt(out)))
    check(counts['cwt_bins_mixed'] >= 1 and counts['scatter_kv'] >= 1
          and mad < 0.1, "ssq_cwt(padtype=None)/issq_cwt round trip at N=%d:"
          " mad_rms = %.4g (< 0.1), launches %s" % (Nc7, mad, counts))
    del out
    Nc = 19531
    tc = np.linspace(0, 6, Nc, endpoint=False)
    xc = np.cos(2 * np.pi * 2 * np.exp(tc / 2)).astype(np.float32)
    for name, fwd, inv, need in (
            ('issq_cwt', lambda: stq.ssq_cwt(xc)[0], stq.issq_cwt,
             ('cwt_bins', 'scatter_kv')),
            ('issq_stft', lambda: stq.ssq_stft(xc)[0], stq.issq_stft,
             ('stft_conv', 'scatter_kv')),
            ('icwt', lambda: stq.cwt(xc, scales='log')[0],
             lambda W: stq.icwt(W, scales='log'), ('cwt_fused',)),
            ('ssq_cwt2/issq_cwt', lambda: stq.ssq_cwt2(xc)[0], stq.issq_cwt,
             ('cwt_bins2', 'scatter_kv')),
            ('ssq_stft2/issq_stft', lambda: stq.ssq_stft2(xc)[0],
             stq.issq_stft, ('fsst2_conv', 'scatter_kv')),
            ('ssq_cwt(get_w=True)/issq_cwt',
             lambda: stq.ssq_cwt(xc, get_w=True)[0], stq.issq_cwt,
             ('cwt_fused', 'shift_scatter'))):
        out, counts = launches_of(all_kernels, fwd)
        mad = float(stq.toolkit.mad_rms(xc, inv(out)))
        check(all(counts[kn] >= 1 for kn in need) and mad < 0.1,
              "%s round trip: mad_rms = %.4g (< 0.1), launches %s"
              % (name, mad, counts))
    xcb = np.stack([np.cos(2 * np.pi * f * np.exp(tc / 2))
                    for f in (1.5, 2., 2.5, 3.)]).astype(np.float32)
    out, counts = launches_of(all_kernels, lambda: stq.ssq_cwt(xcb)[0])
    xrb = stq.issq_cwt(out)
    mads = [float(stq.toolkit.mad_rms(xcb[b], xrb[b])) for b in range(4)]
    check(counts['cwt_bins_batched'] >= 1 and counts['scatter_kv'] >= 1
          and xrb.shape == xcb.shape and max(mads) < 0.1,
          "batched ssq_cwt/issq_cwt round trip of a (4, %d) chirp batch: "
          "mad_rms = %s (each < 0.1), launches %s"
          % (Nc, ', '.join('%.4g' % m for m in mads), counts))
    del out
    x64 = rng.standard_normal(N)
    for hop in (1, 8):
        S = stq.stft(x64, n_fft=n_fft, hop_len=hop, dtype='float64')
        mae = float(np.abs(stq.istft(S, n_fft=n_fft, hop_len=hop, N=N)
                           - x64).mean())
        check(mae < 1e-12, "stft -> istft float64 at hop %d: MAE = %.3g "
              "(< 1e-12)" % (hop, mae))
        del S
    xb64 = rngb.standard_normal((B4N, N))
    for hop in (1, 8):
        S, counts = launches_of(all_kernels, lambda: stq.stft(
            xb64, n_fft=n_fft, hop_len=hop, dtype='float64'))
        xr = stq.istft(S, n_fft=n_fft, hop_len=hop, N=N)
        mae = max(float(np.abs(xr[b] - xb64[b]).mean()) for b in range(B4N))
        check(xr.shape == xb64.shape and mae < 1e-12 and (
            hop > 1 or (counts['stft_conv_batched'] >= 1
                        and counts['stft_conv'] == 0)),
              "batched stft -> istft float64 of a %s batch at hop %d: MAE "
              "= %.3g (< 1e-12, each row), launches %s"
              % (xb64.shape, hop, mae, counts))
        del S, xr
    torch.cuda.empty_cache()

    # ---- timings ---------------------------------------------------------
    args = b1['args']
    xh, sc = args[0], args[1]
    b1_err = b1['err']
    b1_ms = cuda_ms(lambda: cwt_bins(*args))
    b1_plain_ms = cuda_ms(lambda: cwt_bins_plain(*args), reps=5)
    # library yardstick of B1's DFT core only: one torch.fft.ifft over the
    # two (na, n_up) spectra
    spec2 = torch.zeros((2 * na, n_up), dtype=xh.dtype, device=dev)
    spec2[:, :xh.shape[0]] = xh
    b1_lib_ms = cuda_ms(lambda: torch.fft.ifft(spec2, dim=-1))
    del spec2
    torch.cuda.empty_cache()
    b2_ms = cuda_ms(lambda: scatter_kv(Wx, k, c, nbins))
    b2_plain_ms = cuda_ms(lambda: scatter_kv_plain(Wx, k, c, nbins), reps=5)
    # library yardstick: one index_put_ with accumulate (invalid cells go
    # to a dummy row nbins)
    kk = torch.where((k >= 0) & (k < nbins), k, nbins).long()
    cols = torch.arange(N, device=dev).expand(na, N)
    vals = Wx * c.reshape(-1, 1)
    b2_lib_ms = cuda_ms(lambda: torch.zeros(
        (nbins + 1, N), dtype=Wx.dtype, device=dev).index_put_(
            (kk, cols), vals, accumulate=True))
    del kk, cols, vals
    cb, rb = Wx.element_size(), Wx.element_size() // 2
    del Wx, k, c, b1
    torch.cuda.empty_cache()

    # B6 as the main path runs it (bins mode, two planes); its library
    # yardstick is the DFT core only: one torch.fft.ifft of the two
    # (n_rows, Np2) products
    xh6, H, Hd, bins6 = b6['args'][0], b6['args'][1], b6['args'][2], \
        b6['args'][5]
    Np2 = xh6.shape[0]
    b6_ms = cuda_ms(lambda: stft_conv(*b6['args']))
    b6_sx_ms = cuda_ms(lambda: stft_conv(xh6, H, None, N))
    b6_plain_ms = cuda_ms(lambda: stft_conv_plain(*b6['args']), reps=5)
    prods = H * xh6
    # the Sx mode's yardstick: one torch.fft.ifft of the (n_rows, Np2)
    # products
    b6_sx_lib_ms = cuda_ms(lambda: torch.fft.ifft(prods, dim=-1))
    prods = torch.cat([prods, Hd * xh6])
    b6_lib_ms = cuda_ms(lambda: torch.fft.ifft(prods, dim=-1))
    del prods, H, Hd, xh6, b6['args']
    torch.cuda.empty_cache()

    # B3 as `cwt` runs it (Wx only, one plane); yardstick: one
    # torch.fft.ifft of the (na, n_up) spectra. Its derivative mode (Wx
    # and dWx, as ssq_cwt(get_dWx=True) and get_w run it) beside one
    # torch.fft.ifft of the two planes' spectra
    xh3 = b3['args'][0]
    b3_ms = cuda_ms(lambda: cwt_fused(*b3['args']))
    b3_plain_ms = cuda_ms(lambda: cwt_fused_plain(*b3['args']), reps=5)
    spec1 = torch.zeros((na, n_up), dtype=xh3.dtype, device=dev)
    spec1[:, :xh3.shape[0]] = xh3
    b3_lib_ms = cuda_ms(lambda: torch.fft.ifft(spec1, dim=-1))
    del spec1
    args3d = b3['args'][:7] + (True,) + b3['args'][8:]
    b3d_ms = cuda_ms(lambda: cwt_fused(*args3d))
    spec2 = torch.zeros((2 * na, n_up), dtype=xh3.dtype, device=dev)
    spec2[:, :xh3.shape[0]] = xh3
    b3d_lib_ms = cuda_ms(lambda: torch.fft.ifft(spec2, dim=-1))
    n_xh3 = xh3.numel()
    del spec2, xh3, b3['args'], args3d
    torch.cuda.empty_cache()

    # B8 and B7 as their main paths run them; yardstick: the DFT core
    # only, one torch.fft.ifft of the five spectra / table products
    xh8, sc8 = b8['args'][0], b8['args'][1]
    b8_ms = cuda_ms(lambda: cwt_bins2(*b8['args']))
    b8_plain_ms = cuda_ms(lambda: cwt_bins2_plain(*b8['args']), reps=3)
    spec5 = torch.zeros((5 * na, n_up), dtype=xh8.dtype, device=dev)
    spec5[:, :xh8.shape[0]] = xh8
    b8_lib_ms = cuda_ms(lambda: torch.fft.ifft(spec5, dim=-1), reps=5)
    n_xh8 = xh8.numel()
    # B8's w2 mode on the same inputs; the same DFT core as yardstick
    aw = w2k['radix-4'].pop('args')
    w2_ms = cuda_ms(lambda: cwt_w2(*aw))
    w2_plain_ms = cuda_ms(lambda: wsst2_rows(*aw), reps=3)
    del spec5, xh8, sc8, b8['args'], aw
    torch.cuda.empty_cache()
    xh7, tab7 = b7['args'][0], b7['args'][1]
    Np2_7 = xh7.shape[0]
    b7_ms = cuda_ms(lambda: fsst2_conv(*b7['args']))
    b7_plain_ms = cuda_ms(lambda: fsst2_conv_plain(*b7['args']), reps=3)
    prods5 = tab7 * xh7
    b7_lib_ms = cuda_ms(lambda: torch.fft.ifft(prods5, dim=-1), reps=5)
    aw = w2k['b7'].pop('args')
    w7_ms = cuda_ms(lambda: fsst2_w(*aw))
    w7_plain_ms = cuda_ms(lambda: fsst2_rows(*aw), reps=3)
    del prods5, xh7, tab7, b7['args'], aw
    _BANK_CACHE.clear()
    torch.cuda.empty_cache()

    # B3b as the batched ssq_cwt runs it; yardstick: the DFT core only, one
    # torch.fft.ifft of the two (B * na, n_up) spectra
    xhb = b3b['args'][0]
    b3b_ms = cuda_ms(lambda: cwt_bins(*b3b['args']))
    b3b_plain_ms = cuda_ms(lambda: cwt_bins_plain(*b3b['args']), reps=3)
    specb = torch.zeros((2 * B4N * na, n_up), dtype=xhb.dtype, device=dev)
    specb.view(2, B4N, na, n_up)[..., :xhb.shape[-1]] = xhb[:, None, :]
    b3b_lib_ms = cuda_ms(lambda: torch.fft.ifft(specb, dim=-1), reps=5)
    n_xhb = xhb.numel()
    del specb, xhb, b3b['args']
    # B2 as the batched ssq_cwt runs it, on B3b's (4, 293, 160000) planes
    b2b_ms = cuda_ms(lambda: scatter_kv(*b3b['b2']))
    Wb, kb = b3b['b2'][:2]
    b2b_bytes = Wb.numel() * (cb + 4) + na * rb + B4N * nbins * N * cb
    b2b_bound, b2b_by = bound(b2b_bytes, 4 * int(((kb >= 0)
                                                 & (kb < nbins)).sum()))
    del Wb, kb, b3b['b2']
    torch.cuda.empty_cache()

    # B6 (bins and Sx modes), B7 and B8 over the (4, 160000) batch as the
    # batched ssq_stft, stft, ssq_stft2 and ssq_cwt2 run them; yardstick:
    # the DFT core only, one torch.fft.ifft of the (B * n_rows, Np2)
    # products per plane (B * na spectra for B8)
    xh6b, H6b, Hd6b = b6b['args'][:3]
    b6b_ms = cuda_ms(lambda: stft_conv(*b6b['args']))
    b6b_sx_ms = cuda_ms(lambda: stft_conv(xh6b, H6b, None, N))
    b6b_plain_ms = cuda_ms(lambda: stft_conv_plain(*b6b['args']), reps=3)
    prods = H6b * xh6b[:, None, :]
    b6b_sx_lib_ms = cuda_ms(lambda: torch.fft.ifft(prods, dim=-1))
    prods = torch.cat([prods, Hd6b * xh6b[:, None, :]])
    b6b_lib_ms = cuda_ms(lambda: torch.fft.ifft(prods, dim=-1), reps=5)
    del prods, xh6b, H6b, Hd6b, b6b['args']
    torch.cuda.empty_cache()
    xh7b, tab7b = b7b['args'][:2]
    b7b_ms = cuda_ms(lambda: fsst2_conv(*b7b['args']))
    b7b_plain_ms = cuda_ms(lambda: fsst2_conv_plain(*b7b['args']), reps=2,
                           warm=1)
    prods5 = tab7b * xh7b[:, None, None, :]
    b7b_lib_ms = cuda_ms(lambda: torch.fft.ifft(prods5, dim=-1), reps=3)
    aw = w2k['b7b'].pop('args')
    w7b_ms = cuda_ms(lambda: fsst2_w(*aw))
    w7b_plain_ms = cuda_ms(lambda: fsst2_rows(*aw), reps=2, warm=1)
    del prods5, xh7b, tab7b, b7b['args'], aw
    torch.cuda.empty_cache()
    xh8b = b8b['args'][0]
    b8b_ms = cuda_ms(lambda: cwt_bins2(*b8b['args']))
    b8b_plain_ms = cuda_ms(lambda: cwt_bins2_plain(*b8b['args']), reps=2,
                           warm=1)
    spec5b = torch.zeros((5 * B4N * na, n_up), dtype=xh8b.dtype, device=dev)
    spec5b.view(5, B4N, na, n_up)[..., :xh8b.shape[-1]] = xh8b[:, None, :]
    b8b_lib_ms = cuda_ms(lambda: torch.fft.ifft(spec5b, dim=-1), reps=3)
    n_xh8b = xh8b.numel()
    del spec5b, xh8b, b8b['args']
    torch.cuda.empty_cache()

    # B4 as ssq_cwt(get_dWx=True) runs it; yardstick: the scatter part
    # only, one index_put_ with accumulate on bins computed beforehand
    # (no single PyTorch call computes the phase transform and bin map)
    Wx4, dWx4, c4, p4, g4, f4 = b4['args']
    b4_ms = cuda_ms(lambda: ssq_fused(*b4['args']))
    b4_plain_ms = cuda_ms(lambda: ssq_fused_plain(*b4['args']), reps=5)
    k4, v4 = compute_bins(phase_transform_w(Wx4, dWx4, g4), p4, f4)
    n_valid4 = int(v4.sum())
    kk = torch.where(v4, k4, nbins).long()
    cols = torch.arange(N, device=dev).expand(na, N)
    vals = Wx4 * c4.reshape(-1, 1)
    b4_lib_ms = cuda_ms(lambda: torch.zeros(
        (nbins + 1, N), dtype=Wx4.dtype, device=dev).index_put_(
            (kk, cols), vals, accumulate=True))
    del kk, cols, vals, k4, v4
    # B4 as ssq_stft(hop_len=8) runs it, the same yardstick
    Sx8, dSx8, c8, p8, g8, f8, Sfs8 = b4h['args']
    nr8, ns8 = Sx8.shape
    b4h['ms'] = cuda_ms(lambda: ssq_fused(*b4h['args']))
    b4h['plain_ms'] = cuda_ms(lambda: ssq_fused_plain(*b4h['args']))
    k8, v8 = compute_bins(phase_transform_w(Sx8, dSx8, g8, Sfs8), p8, f8)
    n_valid8 = int(v8.sum())
    kk = torch.where(v8, k8, nr8).long()
    cols = torch.arange(ns8, device=dev).expand(nr8, ns8)
    vals = Sx8 * c8.reshape(-1, 1)
    b4h['lib_ms'] = cuda_ms(lambda: torch.zeros(
        (nr8 + 1, ns8), dtype=Sx8.dtype, device=dev).index_put_(
            (kk, cols), vals, accumulate=True))
    del kk, cols, vals, k8, v8, Sx8, dSx8, b4h['args']
    # B5 as ssq_cwt(get_w=True) runs it: Wx, the bins of the phase
    # transform of the same planes and their mask, the per-row const;
    # yardstick: one index_put_ with accumulate (masked cells go to a
    # dummy row nbins)
    k5, v5 = compute_bins(phase_cwt(Wx4, dWx4, 'trig', g4), p4, f4)
    n_valid5 = int(v5.sum())
    b5_args = (Wx4, k5, v5, nbins, c4)
    b5_ms = cuda_ms(lambda: shift_scatter(*b5_args))
    b5_plain_ms = cuda_ms(lambda: shift_scatter_plain(*b5_args), reps=5)
    kk = torch.where(v5, k5, nbins).long()
    cols = torch.arange(N, device=dev).expand(na, N)
    vals = Wx4 * c4.reshape(-1, 1)
    b5_lib_ms = cuda_ms(lambda: torch.zeros(
        (nbins + 1, N), dtype=Wx4.dtype, device=dev).index_put_(
            (kk, cols), vals, accumulate=True))
    del kk, cols, vals, k5, v5, b5_args, Wx4, dWx4, b4['args']
    torch.cuda.empty_cache()

    # the mixed engine at n_up = 160000 (float32) as the unpadded calls run
    # it: B1 (bins), B3 (Wx only; Wx and dWx), B8, B3b on the (4, 160000)
    # batch; yardstick: the DFT core only, one torch.fft.ifft of the
    # (rows, n_up) spectra per plane. B1 also at n_up = 99225 in float64.
    am = mx['float32']['args']
    xhm, nm = am[0], am[3]
    a3m = (xhm, am[1], am[2], nm, 0, nm, 1., False, True)
    a3dm = a3m[:7] + (True, True)
    a8m = am[:7] + am[8:]
    mk = {}
    mk['b1'] = (cuda_ms(lambda: cwt_bins(*am)),
                cuda_ms(lambda: cwt_bins_plain(*am), reps=5))
    mk['b3'] = (cuda_ms(lambda: cwt_fused(*a3m)),
                cuda_ms(lambda: cwt_fused_plain(*a3m), reps=5))
    mk['b3d'] = (cuda_ms(lambda: cwt_fused(*a3dm)),
                 cuda_ms(lambda: cwt_fused_plain(*a3dm), reps=5))
    mk['b8'] = (cuda_ms(lambda: cwt_bins2(*a8m)),
                cuda_ms(lambda: cwt_bins2_plain(*a8m), reps=3))
    aw = w2k['mixed'].pop('args')
    mk['w2'] = (cuda_ms(lambda: cwt_w2(*aw)),
                cuda_ms(lambda: wsst2_rows(*aw), reps=3))
    del aw
    a64 = mx['float64']['args']
    mk['b1_64'] = (cuda_ms(lambda: cwt_bins(*a64)),
                   cuda_ms(lambda: cwt_bins_plain(*a64), reps=3))
    mlib = {}
    for planes in (1, 2, 5):
        specm = torch.zeros((planes * na, nm), dtype=xhm.dtype, device=dev)
        specm[:, :xhm.shape[0]] = xhm
        mlib[planes] = cuda_ms(lambda: torch.fft.ifft(specm, dim=-1),
                               reps=5)
        del specm
    xhbm = rfft(xb_dev).contiguous()
    abm = (xhbm,) + am[1:]
    mk['b3b'] = (cuda_ms(lambda: cwt_bins(*abm), reps=5),
                 cuda_ms(lambda: cwt_bins_plain(*abm), reps=2, warm=1))
    Wbm = cwt_bins(*abm)[0]
    Wbm_p = cwt_bins_plain(*abm)[0]
    mx['b3b_err'] = float((Wbm - Wbm_p).abs().max())
    del Wbm, Wbm_p
    specm = torch.zeros((2 * B4N * na, nm), dtype=xhm.dtype, device=dev)
    specm.view(2, B4N, na, nm)[..., :xhbm.shape[-1]] = xhbm[:, None, :]
    mlib['b3b'] = cuda_ms(lambda: torch.fft.ifft(specm, dim=-1), reps=3)
    n_xhbm = xhbm.numel()
    del specm, xhbm, abm, a3m, a3dm, a8m
    torch.cuda.empty_cache()

    # each call's peak with only its own cached window tables and cuFFT
    # plans live; `ssqueeze`'s inputs (the get_w call's Wx and w) live only
    # while it is timed
    e2e = {}
    sq_in.clear()
    for name, fn in calls.items():
        _TABLE_CACHE.clear()
        _BANK_CACHE.clear()
        _BAND_CACHE.clear()
        torch.backends.cuda.cufft_plan_cache.clear()
        torch.cuda.empty_cache()
        if name == 'ssqueeze_w':
            out = calls['ssq_cwt_getw']()
            sq_in.update(Wx=out[1], w=out[4])
            del out
        elif name == 'ssqueeze_dwx':
            out = calls['ssq_cwt_dwx']()
            sq_in.update(Wx_d=out[1], dWx=out[4])
            del out
        e2e[name] = host_ms(fn)
        sq_in.clear()

    # ---- bounds from this run's shapes -------------------------------------
    b1_bytes = xh.numel() * cb + sc.numel() * rb + na * N * (cb + 4)
    # two length-n_up inverse DFTs per scale (W and dW) at the usual
    # 5 n FLOP per level, over the levels the data needs: every level of
    # the second factor, and of the first the levels that stage 1 runs on
    # the scale's pruned rows (`stage1_levels`: the spectrum is zero above
    # n_up/2 and beyond the wavelet's support, so those levels' pairs have
    # a zero input). The four-step design's own twiddle multiplies are not
    # work the function needs.
    lg2 = np.log2(four_step(n_up)[1])
    lv1 = float((stage1_levels(support_klims(wav, scales, n_up), n_up)
                 + lg2).sum())
    lv2 = float((stage1_levels(support_klims(wav, scales, n_up,
                                             order2=True), n_up)
                 + lg2).sum())
    b1_flops = 2 * 5 * n_up * lv1
    b1_bound, b1_by = bound(b1_bytes, b1_flops)
    b2_bytes = na * N * (cb + 4) + na * rb + nbins * N * cb
    b2_bound, b2_by = bound(b2_bytes, 4 * n_valid)
    # B6 (bins mode): xh read, Sx and k written; two length-Np2 inverse
    # DFTs per row. The window tables and scratch are one design's.
    b6_bytes = Np2 * cb + n_rows * N * (cb + 4)
    b6_flops = 2 * n_rows * 5 * Np2 * np.log2(Np2)
    b6_bound, b6_by = bound(b6_bytes, b6_flops)
    # B3 (Wx only): xh and scales read, Wx written; one inverse DFT per
    # scale over the levels B1's counts
    b3_bytes = n_xh3 * cb + na * rb + na * N * cb
    b3_flops = 5 * n_up * lv1
    b3_bound, b3_by = bound(b3_bytes, b3_flops)
    # B8: xh and scales read, W and k written; five inverse DFTs per scale
    # over the levels of the order-2 support plan (one row more)
    b8_bytes = n_xh8 * cb + na * rb + na * N * (cb + 4)
    b8_flops = 5 * 5 * n_up * lv2
    b8_bound, b8_by = bound(b8_bytes, b8_flops)
    # B7: xh read, V and k written; five length-Np2 inverse DFTs per row.
    # The five window tables and the scratch are one design's.
    b7_bytes = Np2_7 * cb + n_rows * N * (cb + 4)
    b7_flops = 5 * n_rows * 5 * Np2_7 * np.log2(Np2_7)
    b7_bound, b7_by = bound(b7_bytes, b7_flops)
    # B3b: B1's function over the batch
    b3b_bytes = n_xhb * cb + na * rb + B4N * na * N * (cb + 4)
    b3b_flops = B4N * 2 * 5 * n_up * lv1
    b3b_bound, b3b_by = bound(b3b_bytes, b3b_flops)
    # B6 in Sx mode: xh read, Sx written; one length-Np2 inverse DFT per
    # row. B3 with two planes: xh and scales read, Wx and dWx written; two
    # inverse DFTs per scale
    b6_sx_bound, b6_sx_by = bound(Np2 * cb + n_rows * N * cb, b6_flops / 2)
    b3d_bytes = n_xh3 * cb + na * rb + 2 * na * N * cb
    b3d_bound, b3d_by = bound(b3d_bytes, 2 * b3_flops)
    # the mixed engine at n_up = 160000 = N: each mode's function (inputs
    # read, outputs written once) over na scales, 5 n log2 n FLOP per
    # length-n_up inverse DFT
    # over the levels the pruned rows need (`stage1_levels`)
    lg2m = np.log2(four_step(nm)[1])
    dft_m = 5 * nm * float((stage1_levels(support_klims(
        wav, scales, nm), nm) + lg2m).sum()) / na
    dft_m2 = 5 * nm * float((stage1_levels(support_klims(
        wav, scales, nm, order2=True), nm) + lg2m).sum()) / na
    xhm_b = (nm // 2 + 1) * cb + na * rb
    mb = {
        'b1': bound(xhm_b + na * nm * (cb + 4), 2 * na * dft_m),
        'b3': bound(xhm_b + na * nm * cb, na * dft_m),
        'b3d': bound(xhm_b + 2 * na * nm * cb, 2 * na * dft_m),
        'b8': bound(xhm_b + na * nm * (cb + 4), 5 * na * dft_m2),
        'w2': bound(xhm_b + na * nm * (cb + rb), 5 * na * dft_m2),
        'b3b': bound(n_xhbm * cb + na * rb + B4N * na * nm * (cb + 4),
                     2 * B4N * na * dft_m)}
    # B6, B7 and B8 over the batch: their one-signal functions B4N times
    # (B6 in bins mode, as the batched ssq_stft runs it; and in Sx mode)
    b6b_bound, b6b_by = bound(B4N * b6_bytes, B4N * b6_flops)
    b6b_sx_bound, _ = bound(B4N * (Np2 * cb + n_rows * N * cb),
                            B4N * b6_flops / 2)
    b7b_bound, b7b_by = bound(B4N * b7_bytes, B4N * b7_flops)
    b8b_bytes = n_xh8b * cb + na * rb + B4N * na * N * (cb + 4)
    b8b_bound, b8b_by = bound(b8b_bytes, B4N * b8_flops)
    # B4: Wx, dWx and const read, Tx written; per cell the phase ratio and
    # the bin map (~12 FLOP), per valid cell the accumulate (4 FLOP)
    b4_bytes = 2 * na * N * cb + na * rb + nbins * N * cb
    b4_flops = 12 * na * N + 4 * n_valid4
    b4_bound, b4_by = bound(b4_bytes, b4_flops)
    # at hop 8: the Sfs read too, nbins = the STFT's rows
    b4h['bytes'] = 2 * nr8 * ns8 * cb + 2 * nr8 * rb + nr8 * ns8 * cb
    b4h['bound'], b4h['by'] = bound(b4h['bytes'],
                                    12 * nr8 * ns8 + 4 * n_valid8)
    # the w2 modes: B8's and B7's functions with w2 (real) written in
    # place of k
    w2_bound, w2_by = bound(n_xh8 * cb + na * rb + na * N * (cb + rb),
                            b8_flops)
    w7_bytes = Np2_7 * cb + n_rows * N * (cb + rb)
    w7_bound, w7_by = bound(w7_bytes, b7_flops)
    w7b_bound, w7b_by = bound(B4N * w7_bytes, B4N * b7_flops)
    # B5: v, k, the mask and const read, out written; per valid cell the
    # multiply by const and the accumulate (4 FLOP)
    b5_bytes = na * N * (cb + 4 + 1) + na * rb + nbins * N * cb
    b5_bound, b5_by = bound(b5_bytes, 4 * n_valid5)

    for name, (ms, gb) in e2e.items():
        per = (", %.3f ms per transform" % (ms / B4N)
               if name.endswith('_b4') else '')
        print("%s end to end at N=%d: %.3f ms/call%s (host clock, mean of 10 "
              "after warm-up), peak device memory %.3f GB; card: %s"
              % (name, N, ms, per, gb, card), flush=True)
    print("B1 %.3f ms (plain %.3f, torch.fft.ifft DFT core %.3f, bound "
          "%.3f by %s: %.3g B, %.3g FLOP); B2 %.3f ms (plain %.3f, "
          "index_put_ %.3f, bound %.3f by %s: %.3g B, %d valid cells)"
          % (b1_ms, b1_plain_ms, b1_lib_ms, b1_bound, b1_by, b1_bytes,
             b1_flops, b2_ms, b2_plain_ms, b2_lib_ms, b2_bound, b2_by,
             b2_bytes, n_valid), flush=True)
    print("B6 bins mode %.3f ms, Sx mode %.3f ms (plain bins %.3f, "
          "torch.fft.ifft DFT core %.3f, of the Sx mode's one plane %.3f, "
          "bound %.3f by %s: %.3g B, %.3g FLOP; Sx mode bound %.3f by %s; "
          "Np2=%d); B3 Wx only %.3f "
          "ms (plain %.3f, torch.fft.ifft DFT core %.3f, bound %.3f by %s: "
          "%.3g B, %.3g FLOP)"
          % (b6_ms, b6_sx_ms, b6_plain_ms, b6_lib_ms, b6_sx_lib_ms,
             b6_bound, b6_by, b6_bytes, b6_flops, b6_sx_bound, b6_sx_by,
             Np2, b3_ms, b3_plain_ms,
             b3_lib_ms, b3_bound, b3_by, b3_bytes, b3_flops), flush=True)
    print("B3 Wx + dWx %.3f ms (torch.fft.ifft DFT core of the two planes "
          "%.3f, bound %.3f by %s: %.3g B)"
          % (b3d_ms, b3d_lib_ms, b3d_bound, b3d_by, b3d_bytes), flush=True)
    for key, what, lib in (
            ('b1', 'B1 (bins, 2 planes)', mlib[2]),
            ('b3', 'B3 Wx only (1 plane)', mlib[1]),
            ('b3d', 'B3 Wx + dWx (2 planes)', mlib[2]),
            ('b8', 'B8 (order 2, 5 planes)', mlib[5]),
            ('b3b', 'B3b on (%d, %d)' % (B4N, nm), mlib['b3b'])):
        print("mixed engine at n_up=%d=%dx%d float32, %s: %.3f ms (plain "
              "%.3f, torch.fft.ifft DFT core %.3f, bound %.3f by %s); card: "
              "%s" % ((nm,) + four_step(nm) + (what,) + mk[key] + (lib,)
                      + mb[key] + (card,)), flush=True)
    print("w2 modes: B8 (cwt_w2) %.3f ms at (%d, %d), n_up=%d (plain %.3f, "
          "torch.fft.ifft DFT core %.3f, bound %.3f by %s); on the mixed "
          "engine at n_up=%d %.3f ms (plain %.3f, DFT core %.3f, bound %.3f "
          "by %s); B7 (fsst2_w) %.3f ms (plain %.3f, DFT core %.3f, bound "
          "%.3f by %s); over a (%d, %d) batch %.3f ms (plain %.3f, DFT core "
          "%.3f, bound %.3f by %s); card: %s"
          % (w2_ms, na, N, n_up, w2_plain_ms, b8_lib_ms, w2_bound, w2_by,
             nm, mk['w2'][0], mk['w2'][1], mlib[5], mb['w2'][0], mb['w2'][1],
             w7_ms, w7_plain_ms, b7_lib_ms, w7_bound, w7_by, B4N, N, w7b_ms,
             w7b_plain_ms, b7b_lib_ms, w7b_bound, w7b_by, card), flush=True)
    print("mixed engine at n_up=99225=315x315 float64, B1: %.3f ms (plain "
          "%.3f); card: %s" % (mk['b1_64'] + (card,)), flush=True)
    print("B8 %.3f ms (plain %.3f, torch.fft.ifft DFT core %.3f, bound "
          "%.3f by %s: %.3g B, %.3g FLOP); B7 %.3f ms (plain %.3f, "
          "torch.fft.ifft DFT core %.3f, bound %.3f by %s: %.3g B, %.3g "
          "FLOP; Np2=%d)"
          % (b8_ms, b8_plain_ms, b8_lib_ms, b8_bound, b8_by, b8_bytes,
             b8_flops, b7_ms, b7_plain_ms, b7_lib_ms, b7_bound, b7_by,
             b7_bytes, b7_flops, Np2_7), flush=True)
    print("B3b %.3f ms at (%d, %d) (plain %.3f, torch.fft.ifft DFT core "
          "%.3f, bound %.3f by %s: %.3g B, %.3g FLOP); B4 %.3f ms (plain "
          "%.3f, index_put_ scatter part %.3f, bound %.3f by %s: %.3g B, "
          "%.3g FLOP, %d valid cells)"
          % (b3b_ms, B4N, N, b3b_plain_ms, b3b_lib_ms, b3b_bound, b3b_by,
             b3b_bytes, b3b_flops, b4_ms, b4_plain_ms, b4_lib_ms, b4_bound,
             b4_by, b4_bytes, b4_flops, n_valid4), flush=True)
    print("over a (%d, %d) batch: B6 bins mode %.3f ms, Sx mode %.3f ms "
          "(plain bins %.3f, torch.fft.ifft DFT core %.3f, of the Sx mode's "
          "one plane %.3f, bound %.3f by %s, Sx mode %.3f); B7 %.3f ms "
          "(plain %.3f, torch.fft.ifft DFT core %.3f, bound %.3f by %s); B8 "
          "%.3f ms (plain %.3f, torch.fft.ifft DFT core %.3f, bound %.3f by "
          "%s); card: %s"
          % (B4N, N, b6b_ms, b6b_sx_ms, b6b_plain_ms, b6b_lib_ms,
             b6b_sx_lib_ms, b6b_bound, b6b_by, b6b_sx_bound, b7b_ms,
             b7b_plain_ms, b7b_lib_ms, b7b_bound, b7b_by, b8b_ms,
             b8b_plain_ms, b8b_lib_ms, b8b_bound, b8b_by, card), flush=True)
    print("B4 at hop 8 (%d, %d), Sfs: %.3f ms (plain %.3f, index_put_ "
          "scatter part %.3f, bound %.3f by %s: %.3g B, %d valid cells)"
          % (nr8, ns8, b4h['ms'], b4h['plain_ms'], b4h['lib_ms'],
             b4h['bound'], b4h['by'], b4h['bytes'], n_valid8), flush=True)
    print("B5 %.3f ms (plain %.3f, index_put_ %.3f, bound %.3f by %s: %.3g "
          "B, %d valid cells); B2 in this run %.3f ms"
          % (b5_ms, b5_plain_ms, b5_lib_ms, b5_bound, b5_by, b5_bytes,
             n_valid5, b2_ms), flush=True)
    for what, ms, nbytes, bms in (
            ('B2 at (%d, %d)' % (na, N), b2_ms, b2_bytes, b2_bound),
            ('B2 at (%d, %d, %d)' % (B4N, na, N), b2b_ms, b2b_bytes,
             b2b_bound),
            ('B5 at (%d, %d), mask + const' % (na, N), b5_ms, b5_bytes,
             b5_bound),
            ('B4 at (%d, %d)' % (na, N), b4_ms, b4_bytes, b4_bound),
            ('B4 at (%d, %d), Sfs' % (nr8, ns8), b4h['ms'], b4h['bytes'],
             b4h['bound'])):
        print("%s: %.3f ms, %.3f TB/s of the bytes it must move (%.3g B), "
              "bound %.3f ms, %.1f%% of the bound; card: %s"
              % (what, ms, nbytes / ms / 1e9, nbytes, bms, 100 * bms / ms,
                 card), flush=True)
    band = band_section(stq, dev, card, x_np, xb_big, n_fft)
    prune_section(stq, dev, card, x_np, xb_big, scales, params)
    wav_rows, _ = wavelet_section(stq, dev, card, x_np, xb_big)
    for k, v in streaming_section(stq, dev, card, all_kernels).items():
        launches[k] += v
    for k, v in grad_section(stq, dev, card, all_kernels, x_np, xb_big,
                             spec, scales, ssq_freqs, n_fft).items():
        launches[k] += v
    for k, v in parallel_section(stq, dev, card, all_kernels, xb_big, spec,
                                 scales, n_fft).items():
        launches[k] += v
    ridge_rows, ridge_launches = analysis_section(
        stq, dev, card, all_kernels, x_np, spec, scales, ssq_freqs)
    for kn, v in ridge_launches.items():
        launches[kn] += v
    torch.cuda.empty_cache()
    for kn, v in past_ceiling_section(stq, dev, card, all_kernels, x_np,
                                      spec, scales, ssq_freqs,
                                      n_fft).items():
        launches[kn] += v
    print("main-path launches per kernel, summed over the %d public "
          "calls, the prime lengths' counted calls, the streaming "
          "section's counted calls, the gradient section's forwards, the "
          "parallel section's world of one, the analysis section's "
          "counted calls and the past-ceiling section's: %s"
          % (len(calls), launches), flush=True)
    print("total smoke time %.1f s" % (time.perf_counter() - t0),
          flush=True)

    kernels = [
        dict(name='cwt_bins', route='cuda',
             source='ssqueezepy_tpu_torch/csrc/cwt_bins.cu',
             replaces='ssqueezepy_tpu/ops/cwt_pallas.py:70',
             launches=launches['cwt_bins'], max_abs_err=b1_err,
             ms=b1_ms, plain_ms=b1_plain_ms, bound_ms=b1_bound,
             bound_by=b1_by, library_ms=b1_lib_ms),
        dict(name='scatter_kv', route='cuda',
             source='ssqueezepy_tpu_torch/csrc/scatter_kv.cu',
             replaces='ssqueezepy_tpu/ops/ssq_pallas.py:558',
             launches=launches['scatter_kv'], max_abs_err=b2_err,
             ms=b2_ms, plain_ms=b2_plain_ms, bound_ms=b2_bound,
             bound_by=b2_by, library_ms=b2_lib_ms),
        dict(name='stft_conv', route='cuda',
             source='ssqueezepy_tpu_torch/csrc/stft_conv.cu',
             replaces='ssqueezepy_tpu/ops/stft_conv.py:393',
             launches=launches['stft_conv'], max_abs_err=b6['err'],
             ms=b6_ms, plain_ms=b6_plain_ms, bound_ms=b6_bound,
             bound_by=b6_by, library_ms=b6_lib_ms),
        dict(name='cwt_fused', route='cuda',
             source='ssqueezepy_tpu_torch/csrc/cwt_bins.cu',
             replaces='ssqueezepy_tpu/ops/cwt_pallas.py:70',
             launches=launches['cwt_fused'], max_abs_err=b3['err'],
             ms=b3_ms, plain_ms=b3_plain_ms, bound_ms=b3_bound,
             bound_by=b3_by, library_ms=b3_lib_ms),
        dict(name='cwt_bins2', route='cuda',
             source='ssqueezepy_tpu_torch/csrc/cwt_bins.cu',
             replaces='ssqueezepy_tpu/ops/cwt_pallas.py:70',
             launches=launches['cwt_bins2'], max_abs_err=b8['err'],
             ms=b8_ms, plain_ms=b8_plain_ms, bound_ms=b8_bound,
             bound_by=b8_by, library_ms=b8_lib_ms),
        dict(name='fsst2_conv', route='cuda',
             source='ssqueezepy_tpu_torch/csrc/stft_conv.cu',
             replaces='ssqueezepy_tpu/ops/stft_conv.py:655',
             launches=launches['fsst2_conv'], max_abs_err=b7['err'],
             ms=b7_ms, plain_ms=b7_plain_ms, bound_ms=b7_bound,
             bound_by=b7_by, library_ms=b7_lib_ms),
        dict(name='cwt_bins_batched', route='cuda',
             source='ssqueezepy_tpu_torch/csrc/cwt_bins.cu',
             replaces='ssqueezepy_tpu/ops/cwt_pallas.py:70',
             launches=launches['cwt_bins_batched'], max_abs_err=b3b['err'],
             ms=b3b_ms, plain_ms=b3b_plain_ms, bound_ms=b3b_bound,
             bound_by=b3b_by, library_ms=b3b_lib_ms),
        dict(name='ssq_fused', route='cuda',
             source='ssqueezepy_tpu_torch/csrc/scatter_kv.cu',
             replaces='ssqueezepy_tpu/ops/ssq_pallas.py:345',
             launches=launches['ssq_fused'], max_abs_err=b4['err'],
             ms=b4_ms, plain_ms=b4_plain_ms, bound_ms=b4_bound,
             bound_by=b4_by, library_ms=b4_lib_ms),
        dict(name='shift_scatter', route='cuda',
             source='ssqueezepy_tpu_torch/csrc/scatter_kv.cu',
             replaces='ssqueezepy_tpu/ops/ssq_pallas.py:804',
             launches=launches['shift_scatter'], max_abs_err=b5_err,
             ms=b5_ms, plain_ms=b5_plain_ms, bound_ms=b5_bound,
             bound_by=b5_by, library_ms=b5_lib_ms),
        dict(name='stft_conv_batched', route='cuda',
             source='ssqueezepy_tpu_torch/csrc/stft_conv.cu',
             replaces='ssqueezepy_tpu/ops/stft_conv.py:393',
             launches=launches['stft_conv_batched'], max_abs_err=b6b['err'],
             ms=b6b_ms, plain_ms=b6b_plain_ms, bound_ms=b6b_bound,
             bound_by=b6b_by, library_ms=b6b_lib_ms),
        dict(name='fsst2_conv_batched', route='cuda',
             source='ssqueezepy_tpu_torch/csrc/stft_conv.cu',
             replaces='ssqueezepy_tpu/ops/stft_conv.py:655',
             launches=launches['fsst2_conv_batched'],
             max_abs_err=b7b['err'], ms=b7b_ms, plain_ms=b7b_plain_ms,
             bound_ms=b7b_bound, bound_by=b7b_by, library_ms=b7b_lib_ms),
        dict(name='cwt_bins2_batched', route='cuda',
             source='ssqueezepy_tpu_torch/csrc/cwt_bins.cu',
             replaces='ssqueezepy_tpu/ops/cwt_pallas.py:70',
             launches=launches['cwt_bins2_batched'],
             max_abs_err=b8b['err'], ms=b8b_ms, plain_ms=b8b_plain_ms,
             bound_ms=b8b_bound, bound_by=b8b_by, library_ms=b8b_lib_ms),
    ]
    # the CWT kernel's mixed engine (n_up = 160000 = 400 x 400, float32)
    for name, key, err, lib in (
            ('cwt_bins_mixed', 'b1', mx['float32']['err'], mlib[2]),
            ('cwt_fused_mixed', 'b3', mx['float32']['err3'], mlib[1]),
            ('cwt_bins2_mixed', 'b8', mx['float32']['err8'], mlib[5]),
            ('cwt_bins_batched_mixed', 'b3b', mx['b3b_err'], mlib['b3b']),
            ('cwt_w2_mixed', 'w2', w2k['mixed']['err'], mlib[5])):
        kernels.append(dict(
            name=name, route='cuda',
            source='ssqueezepy_tpu_torch/csrc/cwt_bins.cu',
            replaces='ssqueezepy_tpu/ops/cwt_pallas.py:70',
            launches=launches[name], max_abs_err=err, ms=mk[key][0],
            plain_ms=mk[key][1], bound_ms=mb[key][0], bound_by=mb[key][1],
            library_ms=lib))
    # the w2 modes of B8 (radix 4, n_up = 262144) and B7 (one signal and
    # the (4, 160000) batch)
    kernels += [
        dict(name='cwt_w2', route='cuda',
             source='ssqueezepy_tpu_torch/csrc/cwt_bins.cu',
             replaces='ssqueezepy_tpu/ops/cwt_pallas.py:70',
             launches=launches['cwt_w2'], max_abs_err=w2k['radix-4']['err'],
             ms=w2_ms, plain_ms=w2_plain_ms, bound_ms=w2_bound,
             bound_by=w2_by, library_ms=b8_lib_ms),
        dict(name='fsst2_w', route='cuda',
             source='ssqueezepy_tpu_torch/csrc/stft_conv.cu',
             replaces='ssqueezepy_tpu/ops/stft_conv.py:655',
             launches=launches['fsst2_w'], max_abs_err=w2k['b7']['err'],
             ms=w7_ms, plain_ms=w7_plain_ms, bound_ms=w7_bound,
             bound_by=w7_by, library_ms=b7_lib_ms),
        dict(name='fsst2_w_batched', route='cuda',
             source='ssqueezepy_tpu_torch/csrc/stft_conv.cu',
             replaces='ssqueezepy_tpu/ops/stft_conv.py:655',
             launches=launches['fsst2_w_batched'],
             max_abs_err=w2k['b7b']['err'], ms=w7b_ms,
             plain_ms=w7b_plain_ms, bound_ms=w7b_bound, bound_by=w7b_by,
             library_ms=b7b_lib_ms)]
    # the band plan (section 12g): B6 in bins mode and B7's two modes on
    # banded tables, one signal and the (4, 160000) batch; the bound and
    # the library yardstick are the full-table rows' (the same function)
    for name, mode, shape, bnd, lib in (
            ('stft_conv_banded', 2, 'one', (b6_bound, b6_by), b6_lib_ms),
            ('stft_conv_batched_banded', 2, 'b4', (b6b_bound, b6b_by),
             b6b_lib_ms),
            ('fsst2_conv_banded', 3, 'one', (b7_bound, b7_by), b7_lib_ms),
            ('fsst2_conv_batched_banded', 3, 'b4', (b7b_bound, b7b_by),
             b7b_lib_ms),
            ('fsst2_w_banded', 4, 'one', (w7_bound, w7_by), b7_lib_ms),
            ('fsst2_w_batched_banded', 4, 'b4', (w7b_bound, w7b_by),
             b7b_lib_ms)):
        r = band[(mode, shape)]
        kernels.append(dict(
            name=name, route='cuda',
            source='ssqueezepy_tpu_torch/csrc/stft_conv.cu',
            replaces='ssqueezepy_tpu/ops/stft_conv.py:%d'
            % (393 if mode == 2 else 655),
            launches=launches[name], max_abs_err=r['err'], ms=r['ms'],
            plain_ms=r['plain_ms'], bound_ms=bnd[0], bound_by=bnd[1],
            library_ms=lib))
    kernels += wav_rows + ridge_rows
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
