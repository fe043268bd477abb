#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Smoke run of the PyTorch port (`ssqueezepy_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — `ssq_cwt` forward on a 1-D float32 signal
at the bench headline shape (N = 160000, the bench's 293-row
log-piecewise plan, white noise from a seed) and `issq_cwt` back — and:

  1. prints the card's name and power limit (nvidia-smi);
  2. builds every CUDA kernel from `ssqueezepy_tpu_torch/csrc/` (one nvcc
     per source, in parallel) and prints the build time;
  3. holds the fused CWT + bins kernel (B1) against its plain PyTorch
     version at the headline shape, float32 and float64;
  4. holds the reassignment scatter (B2) against its plain version on the
     same planes, and checks two runs are bit-identical;
  5. runs the public `ssq_cwt` at 160k with every launch counter set to 0
     just before, reads the counters just after (each kernel must have
     launched), and checks Tx against the plain path on the card;
  6. round-trips a chirp through `ssq_cwt`/`issq_cwt` (mad_rms < 0.1);
  7. times each kernel, its plain version and a library yardstick with
     CUDA events after warm-up, computes each kernel's bound from this
     run's shapes, and times the whole `ssq_cwt` with its peak memory;
  8. prints one `{"kernels": [...]}` line, then, as the last line,
     `{"ok": true, "device": {...}}`.

Any failed check exits non-zero before those lines. Without a CUDA
device, or without the package beside this script, it exits non-zero.
"""
import json
import os
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


def bins_criterion(Tx_k, Tx_p, what):
    m = float(Tx_p.abs().max())
    col = float((Tx_k.sum(-2) - Tx_p.sum(-2)).abs().max())
    e_k, e_p = float(Tx_k.abs().sum()), float(Tx_p.abs().sum())
    check(col < 1e-4 * m and abs(e_k - e_p) / e_p < 5e-3,
          "%s: Tx column sums %.3g of max, energy %.3g (bins criterion "
          "1e-4 / 5e-3)" % (what, col / m, abs(e_k - e_p) / e_p))


def main():
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, HERE)
    try:
        import ssqueezepy_tpu_torch as stq
        from ssqueezepy_tpu_torch.ops import _build
        from ssqueezepy_tpu_torch.ops.cwt_cuda import (
            cwt_bins, cwt_bins_plain, four_step)
        from ssqueezepy_tpu_torch.ops.ssq_cuda import (
            scatter_kv, scatter_kv_plain)
        from ssqueezepy_tpu_torch.ops.fft import rfft
        from ssqueezepy_tpu_torch.ops.pad import padsignal, pad_params
        from ssqueezepy_tpu_torch.models.cwt import resolve_wavelet
        from ssqueezepy_tpu_torch.models.ssqueezing import \
            _compute_associated_frequencies
        from ssqueezepy_tpu_torch.convert import plan_from_numpy
    except ImportError as e:
        fail("the port is not importable beside this script (%s)" % e)
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
    build_s = _build.build_all()
    print("built %s in %.2f s (nvcc, in parallel)"
          % (', '.join(_build.SOURCES), build_s), flush=True)

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
    x_np = np.random.default_rng(0).standard_normal(N).astype(np.float32)

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

    # ---- the main path through the public API ------------------------------
    x_dev = torch.as_tensor(x_np, device=dev)
    kw = dict(wavelet=spec, scales=scales, ssq_freqs=ssq_freqs)
    stq.ssq_cwt(x_dev, **kw)                  # plan memo + first launch
    torch.cuda.synchronize()
    cwt_bins.launches = scatter_kv.launches = 0
    Tx, Wx_pub, fr, sc_out = stq.ssq_cwt(x_dev, **kw)
    torch.cuda.synchronize()
    launches = {'cwt_bins': cwt_bins.launches,
                'scatter_kv': scatter_kv.launches}
    check(all(v >= 1 for v in launches.values()),
          "ssq_cwt at N=%d launched each kernel: %s" % (N, launches))
    check(Tx.shape == (nbins, N) and Wx_pub.shape == (na, N)
          and bool(torch.isfinite(torch.view_as_real(Tx)).all()),
          "ssq_cwt: Tx (%d, %d), Wx (%d, %d), finite" % (Tx.shape + Wx_pub.shape))
    # the same pipeline from the plain versions, on the card
    wv, xh, sc, c, gamma = kernel_inputs('float32')
    Wx_p, k_p = cwt_bins_plain(xh, sc, wv, n_up, n1, N, 1., True, params,
                               gamma, True)
    bins_criterion(Tx, scatter_kv_plain(Wx_p, k_p, c, nbins),
                   "public ssq_cwt vs plain path")
    del Wx_p, k_p, Wx_pub

    # ---- round trip (the verify skill's chirp) -----------------------------
    Nc = 19531
    tc = np.linspace(0, 6, Nc, endpoint=False)
    xc = np.cos(2 * np.pi * 2 * np.exp(tc / 2)).astype(np.float32)
    cwt_bins.launches = scatter_kv.launches = 0
    Txc, _, _, _ = stq.ssq_cwt(xc)
    xrec = stq.issq_cwt(Txc)
    torch.cuda.synchronize()
    rt_launches = (cwt_bins.launches, scatter_kv.launches)
    mad = float(stq.toolkit.mad_rms(xc, xrec))
    check(min(rt_launches) >= 1 and mad < 0.1,
          "issq_cwt round trip: mad_rms = %.4g (< 0.1), launches %s"
          % (mad, rt_launches))

    # ---- timings ---------------------------------------------------------
    torch.cuda.empty_cache()
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
    torch.cuda.empty_cache()

    cb, rb = Wx.element_size(), Wx.element_size() // 2
    del Wx, k, c, b1
    torch.cuda.empty_cache()
    reps = 10
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        stq.ssq_cwt(x_dev, **kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(reps):
        out = stq.ssq_cwt(x_dev, **kw)
    torch.cuda.synchronize()
    e2e_ms = (time.perf_counter() - t1) / reps * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del out

    # ---- bounds from this run's shapes -------------------------------------
    b1_bytes = xh.numel() * cb + sc.numel() * rb + na * N * (cb + 4)
    lg = n_up.bit_length() - 1
    # two length-n_up inverse DFTs per scale (W and dW) at the usual
    # 5 n log2 n FLOP, less one stage: the spectrum is zero above n_up/2,
    # so every pair of the first stage has a zero input. The four-step
    # design's own twiddle multiplies are not work the function needs.
    b1_flops = na * 2 * 5 * n_up * (lg - 1)
    b1_bound = max(b1_bytes / PEAK_BYTES_S, b1_flops / PEAK_F32_FLOP_S) * 1e3
    b1_by = 'operations' if b1_flops / PEAK_F32_FLOP_S > \
        b1_bytes / PEAK_BYTES_S else 'bytes'
    b2_bytes = na * N * (cb + 4) + na * rb + nbins * N * cb
    b2_flops = 4 * n_valid
    b2_bound = max(b2_bytes / PEAK_BYTES_S, b2_flops / PEAK_F32_FLOP_S) * 1e3
    b2_by = 'operations' if b2_flops / PEAK_F32_FLOP_S > \
        b2_bytes / PEAK_BYTES_S else 'bytes'

    print("ssq_cwt end to end at N=%d: %.3f ms/call (host clock, mean of "
          "%d after warm-up), peak device memory %.3f GB; card: %s"
          % (N, e2e_ms, reps, peak_gb, card), flush=True)
    print("B1 %.3f ms (plain %.3f, torch.fft.ifft DFT core %.3f, bound "
          "%.3f by %s: %.3g B, %.3g FLOP); B2 %.3f ms (plain %.3f, "
          "index_put_ %.3f, bound %.3f by %s: %.3g B, %d valid cells)"
          % (b1_ms, b1_plain_ms, b1_lib_ms, b1_bound, b1_by, b1_bytes,
             b1_flops, b2_ms, b2_plain_ms, b2_lib_ms, b2_bound, b2_by,
             b2_bytes, n_valid), flush=True)
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
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
