#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Where the time of a PyTorch port call goes, on one NVIDIA GPU.

    python3 scripts/torch_ssq_cwt_profile.py [--transform ssq_cwt]
        [--n 160000] [--calls 5]

Runs one of the bench calls on white noise in float32 — `ssq_cwt` (the
headline: the bench's 293-row log-piecewise plan and its ssq_freqs),
`cwt` (the same scales), `ssq_cwt2` (the same scales, no ssq_freqs),
`ssq_stft`, `stft` or `ssq_stft2` (n_fft = 598, hop 1), `ssq_cwt_b4`
(`ssq_cwt` on a (4, N) batch), `ssq_cwt_dwx` (`ssq_cwt` with
`get_dWx=True`), `ssq_stft_hop8` (`ssq_stft` at hop 8), `ssq_cwt_getw`
(`ssq_cwt` with `get_w=True`), `ssq_stft_hop8_abs` (`ssq_stft` at hop
8 with 'abs' squeezing) or `ssqueeze_dwx` (`ssqueeze` of the
`get_dWx=True` call's Wx and dWx) —
under `torch.profiler` after warm-up and prints one JSON line: device
time per kernel name (summed over the profiled calls, divided by the
call count), the wall time per call, and the device's idle share of
that wall time. Needs a CUDA device.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np


def main():
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import profile, ProfilerActivity
    ap = argparse.ArgumentParser()
    ap.add_argument('--transform', default='ssq_cwt',
                    choices=('ssq_cwt', 'cwt', 'ssq_stft', 'stft',
                             'ssq_cwt2', 'ssq_stft2', 'ssq_cwt_b4',
                             'ssq_cwt_dwx', 'ssq_stft_hop8', 'ssq_cwt_getw',
                             'ssq_stft_hop8_abs', 'ssqueeze_dwx'))
    ap.add_argument('--n', type=int, default=160000)
    ap.add_argument('--calls', type=int, default=5)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import ssqueezepy_tpu_torch as stq
    from ssqueezepy_tpu_torch.models.ssqueezing import \
        _compute_associated_frequencies

    N = a.n
    spec = ('gmw', {'dtype': 'float32'})
    wav = stq.Wavelet(spec)
    scales = stq.process_scales('log-piecewise', N, wav)[:300]
    freqs = _compute_associated_frequencies(
        scales, N, wav, 'log-piecewise', maprange='peak', was_padded=True,
        dt=1, transform='cwt')
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(N)
                        .astype(np.float32), device='cuda')
    xb = torch.as_tensor(np.random.default_rng(1).standard_normal((4, N))
                         .astype(np.float32), device='cuda')
    kw = dict(wavelet=spec, scales=scales, ssq_freqs=freqs)
    if a.transform == 'ssqueeze_dwx':
        _, Wx, _, _, dWx = stq.ssq_cwt(x, get_dWx=True, **kw)
    call = {
        'ssqueeze_dwx': lambda: stq.ssqueeze(
            Wx, dWx=dWx, gamma=10 * float(np.finfo(np.float32).eps),
            scales=scales, ssq_freqs=freqs, flipud=True),
        'ssq_cwt': lambda: stq.ssq_cwt(x, **kw),
        'ssq_cwt_b4': lambda: stq.ssq_cwt(xb, **kw),
        'ssq_cwt_dwx': lambda: stq.ssq_cwt(x, get_dWx=True, **kw),
        'ssq_stft_hop8': lambda: stq.ssq_stft(x, n_fft=598, hop_len=8),
        'ssq_cwt_getw': lambda: stq.ssq_cwt(x, get_w=True, **kw),
        'ssq_stft_hop8_abs': lambda: stq.ssq_stft(x, n_fft=598, hop_len=8,
                                                  squeezing='abs'),
        'cwt': lambda: stq.cwt(x, wavelet=spec, scales=scales),
        'ssq_stft': lambda: stq.ssq_stft(x, n_fft=598),
        'stft': lambda: stq.stft(x, n_fft=598),
        'ssq_cwt2': lambda: stq.ssq_cwt2(x, spec, scales=scales),
        'ssq_stft2': lambda: stq.ssq_stft2(x, n_fft=598)}[a.transform]
    for _ in range(3):
        call()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(a.calls):
            call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / a.calls

    # device-side events only (kernels, copies): the host ops that
    # launched them report the same time again
    per_kernel = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, 'self_device_time_total',
                         getattr(ev, 'self_cuda_time_total', 0))
        if ev.device_type == DeviceType.CUDA and dev_us > 0:
            per_kernel[ev.key[:80]] = dev_us / 1e3 / a.calls
    busy_ms = sum(per_kernel.values())
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({
        'card': smi, 'transform': a.transform, 'N': N, 'calls': a.calls,
        'wall_ms_per_call': wall_ms,
        'device_busy_ms_per_call': busy_ms,
        'device_idle_share': (1 - busy_ms / wall_ms) if wall_ms else None,
        'device_ms_per_call_by_kernel': dict(sorted(
            per_kernel.items(), key=lambda kv: -kv[1]))}))


if __name__ == '__main__':
    main()
