#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Host-clock time per call of the padded CWT calls, `ssq_stft` and the
reassignment from a phase transform, for one checkout of the port, on
one NVIDIA GPU: run it for two checkouts in turns (parent, change,
parent, change, ...) in one process each to compare them without the
order effects of a longer script.

    python3 scripts/torch_e2e_time.py [--root DIR] [--rounds 5]

`--root` names the checkout whose `ssqueezepy_tpu_torch` is imported
(default: the one holding this script). White noise from a seed at
N = 160000, float32: `ssq_cwt` (the bench's 293 log-piecewise scales and
their ssq_freqs), `cwt` (the same scales), `ssq_cwt(get_dWx=True)`,
`ssq_stft` (n_fft = 598), `stft` (n_fft = 598), `ssq_stft(hop_len=8)`,
`ssq_cwt(get_w=True)`, `ssqueeze` of that call's Wx and w
(`ssqueeze_w`) and of the `get_dWx` call's Wx and dWx (`ssqueeze_dwx`),
as `chip_smoke.py` calls them. Each call is warmed up 5 times, then
timed in `--rounds` rounds of 20 calls ending in a synchronize. Prints
one JSON object {"root": DIR, "card": ..., "<call>": [ms per call, one
per round], ...}. Needs a CUDA device.
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
    ap = argparse.ArgumentParser()
    ap.add_argument('--root', default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument('--rounds', type=int, default=5)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    os.environ.setdefault('SSQ_TPU_TORCH_CACHE',
                          os.path.join(root, 'build', 'plan_cache'))
    import ssqueezepy_tpu_torch as stq
    from ssqueezepy_tpu_torch.models.ssqueezing import \
        _compute_associated_frequencies

    N = 160000
    spec = ('gmw', {'dtype': 'float32'})
    wav = stq.Wavelet(spec)
    scales = stq.process_scales('log-piecewise', N, wav)[:300]
    freqs = _compute_associated_frequencies(
        scales, N, wav, 'log-piecewise', maprange='peak', was_padded=True,
        dt=1, transform='cwt')
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(N)
                        .astype(np.float32), device='cuda')
    kw = dict(wavelet=spec, scales=scales, ssq_freqs=freqs)
    calls = {
        'ssq_cwt': lambda: stq.ssq_cwt(x, **kw),
        'cwt': lambda: stq.cwt(x, wavelet=spec, scales=scales),
        'ssq_cwt_dwx': lambda: stq.ssq_cwt(x, get_dWx=True, **kw),
        'ssq_stft': lambda: stq.ssq_stft(x, n_fft=598),
        'stft': lambda: stq.stft(x, n_fft=598),
        'ssq_stft_hop8': lambda: stq.ssq_stft(x, n_fft=598, hop_len=8),
        'ssq_cwt_getw': lambda: stq.ssq_cwt(x, get_w=True, **kw),
        'ssqueeze_w': lambda: stq.ssqueeze(
            held[1], w=held[4], scales=scales, ssq_freqs=freqs,
            flipud=True),
        'ssqueeze_dwx': lambda: stq.ssqueeze(
            held_d[1], dWx=held_d[4], gamma=10 * float(np.finfo(
                np.float32).eps), scales=scales, ssq_freqs=freqs,
            flipud=True)}
    held = calls['ssq_cwt_getw']()
    held_d = calls['ssq_cwt_dwx']()
    out = {'root': a.root, 'card': subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip()}
    for name, fn in calls.items():
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        out[name] = []
        for _ in range(a.rounds):
            t0 = time.perf_counter()
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            out[name].append((time.perf_counter() - t0) / 20 * 1e3)
    print(json.dumps(out))


if __name__ == '__main__':
    main()
