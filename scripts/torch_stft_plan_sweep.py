#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Times each mode of the STFT table kernel (`csrc/stft_conv.cu`) at the
ssq_stft / ssq_stft2 headline for several launch plans, on one NVIDIA
GPU.

    python3 scripts/torch_stft_plan_sweep.py [--reps 10] [--modes 0,1,2,3]

The launch plan (`ops/stft_cuda.py::launch_plan`) fixes the columns per
block of each stage (P1, P2). This script replaces the plan's P1 and P2
(the shared memory follows; plans over the card's 227 KB per block are
skipped) and times B6 in its modes 0 (Sx), 1 (Sx + dSx) and 2 (bins)
and B7 (mode 3, FSST2) with CUDA events at N = 160000 (white noise from a
seed, float32, n_fft = 598: Np2 = 163840 = 320 x 512), each beside the
output of the default plan (which must match bit for bit: a column's
arithmetic does not depend on the plan). The two launches are
independent, so P1 is swept at the default P2, and P2 at the default P1.
Prints the card's name and power limit, then one JSON
line per plan. Needs a CUDA device.
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
    ap.add_argument('--modes', default='0,1,2,3')
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from ssqueezepy_tpu_torch.models.ssq_stft import fsst2_plan, stft_plan
    from ssqueezepy_tpu_torch.models.stft import signal_spectrum
    from ssqueezepy_tpu_torch.ops import stft_cuda
    from ssqueezepy_tpu_torch.ops.stft_conv import conv_bank, conv_table

    N, n_fft, dev = 160000, 598, torch.device('cuda')
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(N)
                        .astype(np.float32), device=dev)
    xh = signal_spectrum(x, n_fft, 'reflect')
    Np2 = xh.shape[0]
    gamma = 10 * float(np.finfo(np.float32).eps)
    sp = stft_plan(None, None, n_fft, n_fft, 1., 'float32')
    H = conv_table(sp.window, n_fft, Np2, True, 'float32', dev)
    Hd = conv_table(sp.diff_window, n_fft, Np2, True, 'float32', dev)
    bins = dict(Sfs=torch.as_tensor(sp.Sfs, device=dev), params=sp.params,
                flipud=False, gamma=gamma)
    fp = fsst2_plan(None, None, n_fft, n_fft, 1., 'float32')
    bank = conv_bank(fp.bank, n_fft, Np2, True, 'float32', dev)
    bins7 = dict(Sfs=torch.as_tensor(fp.Sfs, device=dev), params=fp.params,
                 flipud=False, gamma=gamma)
    modes = {
        0: (1, lambda: stft_cuda.stft_conv(xh, H, None, N)),
        1: (2, lambda: stft_cuda.stft_conv(xh, H, Hd, N)),
        2: (2, lambda: stft_cuda.stft_conv(xh, H, Hd, N, 1., bins)),
        3: (5, lambda: stft_cuda.fsst2_conv(xh, bank, N, 1., bins7)),
    }
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    default_plan = stft_cuda.launch_plan
    itemsize = xh.element_size()

    def timed(fn):
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
        return t0.elapsed_time(t1) / a.reps

    for mode in map(int, a.modes.split(',')):
        planes, fn = modes[mode]
        base = default_plan(Np2, itemsize, planes)
        ref = fn()
        ref_ms = timed(fn)
        plans = ([(P1, base.P2) for P1 in (1, 2, 4, 8, 16)] +
                 [(base.P1, P2) for P2 in (1, 2, 4, 8, 16)])
        for P1, P2 in plans:
            sm1 = (base.f1 + 2 * planes * P1 * base.S1) * itemsize
            sm2 = (base.f2 + 2 * planes * P2 * base.S2) * itemsize
            if max(sm1, sm2) > 227 * 1024:
                continue
            plan = base._replace(P1=P1, P2=P2, smem1=sm1, smem2=sm2)
            stft_cuda.launch_plan = lambda *args, plan=plan: plan
            try:
                out = fn()
                same = all(torch.equal(u, v) for u, v in zip(out, ref)
                           if u is not None)
                del out
                ms = timed(fn)
            finally:
                stft_cuda.launch_plan = default_plan
            print(json.dumps({
                'mode': mode, 'planes': planes, 'P1': P1, 'P2': P2,
                'smem_bytes': [sm1, sm2], 'ms': ms,
                'bit_identical_to_default_plan': same,
                'default_plan': [base.P1, base.P2],
                'default_ms': ref_ms, 'card': card}), flush=True)
        del ref
        torch.cuda.empty_cache()


if __name__ == '__main__':
    main()
