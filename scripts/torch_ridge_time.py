#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""CUDA-event time of the ridge DP kernels (`ridge_forward`,
`ridge_trace`) for one checkout of the port, on one NVIDIA GPU: run it
for two checkouts in turns (parent, change, change, parent), one process
each, to compare their kernels on one card.

    python3 scripts/torch_ridge_time.py [--root DIR] [--rounds 3]

`--root` names the checkout whose `ssqueezepy_tpu_torch` is imported
(default: the one holding this script). Input: the -log-normalized
energy of uniform noise with two planted wandering ridges, made on the
card from a seed, time-major (1, 160000, 293) float32, the row
coordinates log-spaced (the main path's `extract_ridges` shape). Each
kernel is warmed up once, then timed in `--rounds` rounds of 3 launches
(`chip_smoke.py` 12f times the current checkout's other plans: 16 CTAs,
the per-column floor). Prints one JSON object
{"root", "card", "shape", "forward_ms": [per round], "trace_ms": [...],
"pe_sha256", "ridge_sha256"}: the digests of pe and the ridge show
that two checkouts compute the same outputs. Needs a CUDA device.
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys


def inputs(T, F, seed):
    import torch
    g = torch.Generator(device='cuda').manual_seed(seed)
    E = torch.rand((1, T, F), generator=g, device='cuda') * 0.05
    t = torch.arange(T, device='cuda')
    for amp, c, w, p in ((1., .3, .2, 3000.), (.6, .7, .1, 5000.)):
        r = (F * (c + w * torch.sin(2 * torch.pi * t / p))).long()
        E[0, t, r.clamp(0, F - 1)] += amp
    eps = float(torch.finfo(torch.float32).eps)
    e = -torch.log(E / E.amax(-1, keepdim=True) + eps)
    v = torch.log(torch.logspace(0, 2.477, F, device='cuda'))
    return e.contiguous(), v


def rounds_ms(fn, rounds, reps=3):
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        out.append(t0.elapsed_time(t1) / reps)
    return out


def main():
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument('--root', default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument('--rounds', type=int, default=3)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, os.path.abspath(a.root))
    from ssqueezepy_tpu_torch.ops import ridge_cuda as rc
    T, F = 160000, 293
    eps = float(torch.finfo(torch.float32).eps)
    e, v = inputs(T, F, 0)
    out = {'root': a.root, 'card': subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip(), 'shape': [1, T, F]}
    out['forward_ms'] = rounds_ms(lambda: rc.ridge_forward(e, v, 2.),
                                  a.rounds)
    pe = rc.ridge_forward(e, v, 2.)
    out['trace_ms'] = rounds_ms(lambda: rc.ridge_trace(pe, e, v, 2., eps),
                                a.rounds)
    r = rc.ridge_trace(pe, e, v, 2., eps)
    torch.cuda.synchronize()
    out['pe_sha256'] = hashlib.sha256(pe.cpu().numpy().tobytes()).hexdigest()
    out['ridge_sha256'] = hashlib.sha256(
        r.cpu().numpy().tobytes()).hexdigest()
    print(json.dumps(out))


if __name__ == '__main__':
    main()
