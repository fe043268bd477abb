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
and every squeezing option on those routes: `ssq_cwt(get_w=True)` and
`ssq_cwt(get_dWx=True, squeezing='lebesgue')` (the derivative CWT, the
phase transform, the generic scatter), `ssq_stft(hop_len=8,
squeezing='abs')`, `ssqueeze` from a precomputed w, and 'lebesgue' /
'abs' `ssq_stft`, `ssq_cwt2` and `ssq_stft2` (their kernels' bins, then
the scatter from bins). It:

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
 10. runs each public entry point (`ssq_cwt`, `ssq_stft`, `stft`, `cwt`,
     `ssq_cwt2`, `ssq_stft2`, the batched `ssq_cwt`, `ssq_cwt(get_dWx=
     True)`, `ssq_stft(hop_len=8)`, `ssqueeze` from (Wx, dWx) and the
     squeezing calls above at 160k)
     with every launch counter set to 0 just before, reads the counters
     just after (each kernel of the path must have launched; the `get_w`
     call must launch neither bins kernel), and checks the outputs against
     the plain path on the card;
 11. round-trips a chirp through `ssq_cwt`/`issq_cwt`,
     `ssq_stft`/`issq_stft`, `cwt`/`icwt`, `ssq_cwt2`/`issq_cwt` and
     `ssq_stft2`/`issq_stft` and `ssq_cwt(get_w=True)`/`issq_cwt`, and a
     (4, N) chirp batch through the batched
     `ssq_cwt`/`issq_cwt` (mad_rms < 0.1, each row), and white noise
     through `stft`/`istft` in float64 at hop 1 and hop 8 (MAE < 1e-12);
 12. times each kernel, its plain version and a library yardstick with
     CUDA events after warm-up (B2 also on the (4, 160000) batch, B4 also
     on the hop-8 STFT's planes), computes each kernel's bound from this
     run's shapes (and, for B2, B4 and B5, the bytes/s achieved and the
     share of the bound), and times each public call with its peak
     memory;
 13. prints one `{"kernels": [...]}` line, then, as the last line,
     `{"ok": true, "device": {...}}`.

Any failed check exits non-zero before those lines. Without a CUDA
device, or without the package beside this script, it exits non-zero.
"""
import json
import os
import re
import subprocess
import sys
import time

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


def main():
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, HERE)
    try:
        import ssqueezepy_tpu_torch as stq
        from ssqueezepy_tpu_torch.ops import _build
        from ssqueezepy_tpu_torch.ops.cwt_cuda import (
            cwt_bins, cwt_bins_plain, cwt_bins2, cwt_bins2_plain, cwt_fused,
            cwt_fused_plain, four_step)
        from ssqueezepy_tpu_torch.ops.ssq_cuda import (
            scatter_kv, scatter_kv_plain, scatter_launch_plan, shift_scatter,
            shift_scatter_plain, ssq_fused, ssq_fused_plain)
        from ssqueezepy_tpu_torch.ops.phase import (phase_cwt, phase_stft,
                                                    phase_transform_w)
        from ssqueezepy_tpu_torch.ops.ssq_kernels import compute_bins
        from ssqueezepy_tpu_torch.ops.stft_cuda import (
            fsst2_conv, fsst2_conv_plain, stft_conv, stft_conv_plain,
            split_fft_len)
        from ssqueezepy_tpu_torch.ops.stft_conv import (
            conv_bank, conv_table, _BANK_CACHE, _TABLE_CACHE)
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
    # counter, B1 on its own
    all_kernels = [(k.__name__, k, 'launches') for k in (
        cwt_bins, scatter_kv, stft_conv, cwt_fused, cwt_bins2, fsst2_conv,
        ssq_fused, shift_scatter)] + [('cwt_bins_batched', cwt_bins, 'batched_launches')]
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
                Wx_3, _ = cwt_fused(xh, sc, wv, n_up, n1, N, 1., deriv, True)
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
        Np2 = xh6.shape[0]
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
    }
    # the w and Wx that `ssqueeze` reassigns: the get_w call's own
    sq_in = {}
    needs = {'ssq_cwt': ('cwt_bins', 'scatter_kv'),
             'ssq_stft': ('stft_conv', 'scatter_kv'),
             'stft': ('stft_conv',), 'cwt': ('cwt_fused',),
             'ssq_cwt2': ('cwt_bins2', 'scatter_kv'),
             'ssq_stft2': ('fsst2_conv', 'scatter_kv'),
             'ssq_cwt_b4': ('cwt_bins_batched', 'scatter_kv'),
             'ssq_cwt_dwx': ('cwt_fused', 'ssq_fused'),
             'ssq_stft_hop8': ('ssq_fused',),
             'ssq_cwt_getw': ('cwt_fused', 'shift_scatter'),
             'ssq_cwt_dwx_lebesgue': ('cwt_fused', 'shift_scatter'),
             'ssq_stft_hop8_abs': ('shift_scatter',),
             'ssqueeze_w': ('shift_scatter',),
             'ssqueeze_dwx': ('ssq_fused',),
             'ssq_stft_lebesgue': ('stft_conv', 'scatter_kv'),
             'ssq_cwt2_abs': ('cwt_bins2', 'scatter_kv'),
             'ssq_stft2_lebesgue': ('fsst2_conv', 'scatter_kv')}
    # kernels a path must not launch: get_w takes no bins kernel
    avoids = {'ssq_cwt_getw': ('cwt_bins', 'cwt_bins_batched', 'scatter_kv',
                               'ssq_fused')}
    launches = dict.fromkeys((name for name, _, _ in all_kernels), 0)
    for name, fn in calls.items():
        fn()                                  # plan memo + first launch
        torch.cuda.synchronize()
        out, counts = launches_of(all_kernels, fn)
        check(all(counts[kn] >= 1 for kn in needs[name])
              and not any(counts[kn] for kn in avoids.get(name, ())),
              "%s at N=%d launched its kernels: %s" % (name, N, counts))
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
            xh6, H, _, _, _ = stft_inputs(N, 'float32', x_np)
            Sx_p, _ = stft_conv_plain(xh6, H, None, N)
            check(out.shape == (n_rows, N) and rel_err(out, Sx_p) <= 2e-5,
                  "public stft: Sx (%d, %d), %.3g of max vs the plain path"
                  % (tuple(out.shape) + (rel_err(out, Sx_p),)))
            del Sx_p, xh6, H
        elif name == 'cwt':
            Wx_c = out[0]
            W_p, _ = cwt_fused_plain(*b3['args'])
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
            _, _, _, bins6, c6 = stft_inputs(N, 'float32', x_np)
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
            _, _, _, bins6, c6 = stft_inputs(N, 'float32', x_np)
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

    # ---- round trips -------------------------------------------------------
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
    del spec5, xh8, sc8, b8['args']
    torch.cuda.empty_cache()
    xh7, tab7 = b7['args'][0], b7['args'][1]
    Np2_7 = xh7.shape[0]
    b7_ms = cuda_ms(lambda: fsst2_conv(*b7['args']))
    b7_plain_ms = cuda_ms(lambda: fsst2_conv_plain(*b7['args']), reps=3)
    prods5 = tab7 * xh7
    b7_lib_ms = cuda_ms(lambda: torch.fft.ifft(prods5, dim=-1), reps=5)
    del prods5, xh7, tab7, b7['args']
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

    # each call's peak with only its own cached window tables and cuFFT
    # plans live; `ssqueeze`'s inputs (the get_w call's Wx and w) live only
    # while it is timed
    e2e = {}
    sq_in.clear()
    for name, fn in calls.items():
        _TABLE_CACHE.clear()
        _BANK_CACHE.clear()
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
    lg = n_up.bit_length() - 1
    # two length-n_up inverse DFTs per scale (W and dW) at the usual
    # 5 n log2 n FLOP, less one stage: the spectrum is zero above n_up/2,
    # so every pair of the first stage has a zero input. The four-step
    # design's own twiddle multiplies are not work the function needs.
    b1_flops = na * 2 * 5 * n_up * (lg - 1)
    b1_bound, b1_by = bound(b1_bytes, b1_flops)
    b2_bytes = na * N * (cb + 4) + na * rb + nbins * N * cb
    b2_bound, b2_by = bound(b2_bytes, 4 * n_valid)
    # B6 (bins mode): xh read, Sx and k written; two length-Np2 inverse
    # DFTs per row. The window tables and scratch are one design's.
    b6_bytes = Np2 * cb + n_rows * N * (cb + 4)
    b6_flops = 2 * n_rows * 5 * Np2 * np.log2(Np2)
    b6_bound, b6_by = bound(b6_bytes, b6_flops)
    # B3 (Wx only): xh and scales read, Wx written; one inverse DFT per
    # scale, less the zero-input first stage
    b3_bytes = n_xh3 * cb + na * rb + na * N * cb
    b3_flops = na * 5 * n_up * (lg - 1)
    b3_bound, b3_by = bound(b3_bytes, b3_flops)
    # B8: xh and scales read, W and k written; five inverse DFTs per scale,
    # less the zero-input first stage
    b8_bytes = n_xh8 * cb + na * rb + na * N * (cb + 4)
    b8_flops = na * 5 * 5 * n_up * (lg - 1)
    b8_bound, b8_by = bound(b8_bytes, b8_flops)
    # B7: xh read, V and k written; five length-Np2 inverse DFTs per row.
    # The five window tables and the scratch are one design's.
    b7_bytes = Np2_7 * cb + n_rows * N * (cb + 4)
    b7_flops = 5 * n_rows * 5 * Np2_7 * np.log2(Np2_7)
    b7_bound, b7_by = bound(b7_bytes, b7_flops)
    # B3b: B1's function over the batch
    b3b_bytes = n_xhb * cb + na * rb + B4N * na * N * (cb + 4)
    b3b_flops = B4N * na * 2 * 5 * n_up * (lg - 1)
    b3b_bound, b3b_by = bound(b3b_bytes, b3b_flops)
    # B4: Wx, dWx and const read, Tx written; per cell the phase ratio and
    # the bin map (~12 FLOP), per valid cell the accumulate (4 FLOP)
    b4_bytes = 2 * na * N * cb + na * rb + nbins * N * cb
    b4_flops = 12 * na * N + 4 * n_valid4
    b4_bound, b4_by = bound(b4_bytes, b4_flops)
    # at hop 8: the Sfs read too, nbins = the STFT's rows
    b4h['bytes'] = 2 * nr8 * ns8 * cb + 2 * nr8 * rb + nr8 * ns8 * cb
    b4h['bound'], b4h['by'] = bound(b4h['bytes'],
                                    12 * nr8 * ns8 + 4 * n_valid8)
    # B5: v, k, the mask and const read, out written; per valid cell the
    # multiply by const and the accumulate (4 FLOP)
    b5_bytes = na * N * (cb + 4 + 1) + na * rb + nbins * N * cb
    b5_bound, b5_by = bound(b5_bytes, 4 * n_valid5)

    for name, (ms, gb) in e2e.items():
        per = (", %.3f ms per transform" % (ms / B4N)
               if name == 'ssq_cwt_b4' else '')
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
          "bound %.3f by %s: %.3g B, %.3g FLOP; Np2=%d); B3 Wx only %.3f "
          "ms (plain %.3f, torch.fft.ifft DFT core %.3f, bound %.3f by %s: "
          "%.3g B, %.3g FLOP)"
          % (b6_ms, b6_sx_ms, b6_plain_ms, b6_lib_ms, b6_sx_lib_ms,
             b6_bound, b6_by, b6_bytes, b6_flops, Np2, b3_ms, b3_plain_ms,
             b3_lib_ms, b3_bound, b3_by, b3_bytes, b3_flops), flush=True)
    print("B3 Wx + dWx %.3f ms (torch.fft.ifft DFT core of the two planes "
          "%.3f)" % (b3d_ms, b3d_lib_ms), flush=True)
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
    print("main-path launches per kernel, summed over the %d public "
          "calls: %s" % (len(calls), launches), flush=True)
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
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
