#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Times each mode of the CWT kernel (`csrc/cwt_bins.cu`) at the bench
headline for several column counts per block, on one NVIDIA GPU.

    python3 scripts/torch_cwt_plan_sweep.py [--reps 10]

The launch plan (`ops/cwt_cuda.py::bins_plan`) takes P <= `_MAX_COLUMNS`
columns per block, halved until the block fits the shared-memory budget;
this script sets `_MAX_COLUMNS` to 2, 4, 8 and 16 and times B3 (Wx only,
1 plane; Wx and dWx, 2), B1 (bins mode, 2) and B8 (order 2, 5) with CUDA
events at N = 160000 (white noise from a seed,
float32, the bench's 293 log-piecewise scales), each beside the output
of the default plan (which must match bit for bit: a column's arithmetic
does not depend on P). Fewer columns per block mean less shared memory
per block, so more blocks per SM, but fewer sequences per radix pass
(bank conflicts where a half-warp covers fewer than 16). Prints one JSON
line per (mode, column cap) and the card's name and power limit. Needs a
CUDA device.
"""
import argparse
import json
import os
import subprocess
import sys

import numpy as np


def main():
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument('--reps', type=int, default=10)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import ssqueezepy_tpu_torch as stq
    from ssqueezepy_tpu_torch.convert import plan_from_numpy
    from ssqueezepy_tpu_torch.models.cwt import resolve_wavelet
    from ssqueezepy_tpu_torch.ops import cwt_cuda
    from ssqueezepy_tpu_torch.ops.fft import rfft
    from ssqueezepy_tpu_torch.ops.pad import pad_params, padsignal

    N, dev = 160000, torch.device('cuda')
    spec = ('gmw', {'dtype': 'float32'})
    scales = stq.process_scales('log-piecewise', N, stq.Wavelet(spec))[:300]
    params = plan_from_numpy(scales, None, spec, N)['params']
    wav = resolve_wavelet(spec, N=N)
    n_up, n1, _ = pad_params(N, 'reflect')
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(N)
                        .astype(np.float32), device=dev)
    xh = rfft(padsignal(x, 'reflect'))
    sc = torch.as_tensor(scales.ravel(), dtype=torch.float32, device=dev)
    gamma = 10 * float(np.finfo(np.float32).eps)
    modes = {
        'B3 Wx': (1, lambda: cwt_cuda.cwt_fused(xh, sc, wav, n_up, n1, N, 1.,
                                                False, True)),
        'B3 Wx+dWx': (2, lambda: cwt_cuda.cwt_fused(
            xh, sc, wav, n_up, n1, N, 1., True, True)),
        'B1': (2, lambda: cwt_cuda.cwt_bins(xh, sc, wav, n_up, n1, N, 1.,
                                            True, params, gamma, True)),
        'B8': (5, lambda: cwt_cuda.cwt_bins2(xh, sc, wav, n_up, n1, N, 1.,
                                             params, gamma, True)),
    }
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    default = cwt_cuda._MAX_COLUMNS
    for name, (planes, fn) in modes.items():
        ref = fn()
        for cap in (2, 4, 8, 16):
            cwt_cuda._MAX_COLUMNS = cap
            plan = cwt_cuda.bins_plan(n_up, 8, planes)
            out = fn()
            same = all((u is None and v is None) or torch.equal(u, v)
                       for u, v in zip(out, ref))
            del out
            for _ in range(2):
                fn()
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(a.reps):
                fn()
            t1.record()
            torch.cuda.synchronize()
            print(json.dumps({
                'mode': name, 'planes': planes, 'max_columns': cap,
                'P': [plan.P1, plan.P2], 'smem_bytes': plan.smem1,
                'ms': t0.elapsed_time(t1) / a.reps,
                'bit_identical_to_default_plan': same,
                'default_max_columns': default, 'card': card}), flush=True)
            cwt_cuda._MAX_COLUMNS = default
        del ref
        torch.cuda.empty_cache()


if __name__ == '__main__':
    main()
