#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""CUDA-event time of the ridge DP kernels (`ridge_forward`,
`ridge_trace`) for one checkout of the port, on one NVIDIA GPU: run it
for two checkouts in turns (parent, change, change, parent), one process
each, to compare their kernels on one card.

    python3 scripts/torch_ridge_time.py [--root DIR] [--rounds 3]
        [--shape main|tiled] [--input planted|chirps|noise|constant]

`--root` names the checkout whose `ssqueezepy_tpu_torch` is imported
(default: the one holding this script). `--shape main` (the default):
(1, 160000, 293) float32, the main path's `extract_ridges` shape, on the
resident mode; `--shape tiled`: (1, 1250, 16385) float32, `chip_smoke.py`
12j's, on the row-tiled mode. Inputs, made on the card from a seed,
time-major: `planted` (the default) the -log-normalized energy of
uniform noise with two planted wandering ridges, the row coordinates
log-spaced (main) or linear on [0, 0.5] (tiled); at the tiled shape
also `chirps` and `noise`, `extract_ridges`' energy of `ssq_stft(x,
n_fft=32768, hop_len=128)` of 12j's two chirps or of white noise at N =
160000 with its `ssq_freqs`, and `constant`, e = 1.5 everywhere with
penalty 0 (the tiled forward's worst case: every pair kept); penalty 2
otherwise. Each kernel is warmed up once, then timed in `--rounds`
rounds of 3 launches (`chip_smoke.py` 12f and 12j time the current
checkout's other plans). Prints one JSON object {"root", "card",
"shape", "input", "forward_ms": [per round], "trace_ms": [...],
"pe_sha256", "ridge_sha256"}: the digests of pe and the ridge show that
two checkouts compute the same outputs. Needs a CUDA device.
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys

import numpy as np


def planted(T, F, seed, log_v):
    import torch
    g = torch.Generator(device='cuda').manual_seed(seed)
    E = torch.rand((1, T, F), generator=g, device='cuda') * 0.05
    t = torch.arange(T, device='cuda')
    for amp, c, w, p in ((1., .3, .2, 3000.), (.6, .7, .1, 5000.)):
        r = (F * (c + w * torch.sin(2 * torch.pi * t / p))).long()
        E[0, t, r.clamp(0, F - 1)] += amp
    eps = float(torch.finfo(torch.float32).eps)
    e = -torch.log(E / E.amax(-1, keepdim=True) + eps)
    v = (torch.log(torch.logspace(0, 2.477, F, device='cuda')) if log_v
         else torch.linspace(0, .5, F, device='cuda'))
    return e.contiguous(), v


def stft_energy(signal):
    """`extract_ridges`' first DP input on 12j's `ssq_stft` of the two
    chirps or of white noise (seed 8), and its `ssq_freqs`."""
    import torch
    import ssqueezepy_tpu_torch as stq
    from ssqueezepy_tpu_torch.models.ridge_extraction import _normalized
    N = 160000
    if signal == 'chirps':
        ts = stq.TestSignals(N=N)
        x = ts.lchirp(N, .0125 * N, .075 * N)[0] + \
            ts.echirp(N, .125 * N, .375 * N)[0]
        x = torch.as_tensor(x.astype(np.float32), device='cuda')
    else:
        x = torch.randn(N, generator=torch.Generator(
            device='cuda').manual_seed(8), device='cuda')
    Tx, _, sf, _ = stq.ssq_stft(x, n_fft=32768, hop_len=128)
    a = Tx.abs()
    eps = float(np.finfo(np.float32).eps)
    e = _normalized((a * a)[None], eps, torch.float32)
    return e.contiguous(), torch.as_tensor(np.asarray(sf, np.float32),
                                           device='cuda')


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
    ap.add_argument('--shape', choices=('main', 'tiled'), default='main')
    ap.add_argument('--input', default='planted',
                    choices=('planted', 'chirps', 'noise', 'constant'))
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    if a.shape == 'main' and a.input != 'planted':
        sys.exit("--shape main takes --input planted only")
    sys.path.insert(0, os.path.abspath(a.root))
    from ssqueezepy_tpu_torch.ops import ridge_cuda as rc
    T, F = (160000, 293) if a.shape == 'main' else (1250, 16385)
    eps = float(torch.finfo(torch.float32).eps)
    pen = 2.
    if a.input in ('chirps', 'noise'):
        e, v = stft_energy(a.input)
    else:
        e, v = planted(T, F, 0, a.shape == 'main')
        if a.input == 'constant':
            e.fill_(1.5)
            pen = 0.
    assert e.shape == (1, T, F)
    out = {'root': a.root, 'card': subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip(), 'shape': [1, T, F], 'input': a.input}
    out['forward_ms'] = rounds_ms(lambda: rc.ridge_forward(e, v, pen),
                                  a.rounds)
    pe = rc.ridge_forward(e, v, pen)
    out['trace_ms'] = rounds_ms(lambda: rc.ridge_trace(pe, e, v, pen, eps),
                                a.rounds)
    r = rc.ridge_trace(pe, e, v, pen, eps)
    torch.cuda.synchronize()
    out['pe_sha256'] = hashlib.sha256(pe.cpu().numpy().tobytes()).hexdigest()
    out['ridge_sha256'] = hashlib.sha256(
        r.cpu().numpy().tobytes()).hexdigest()
    print(json.dumps(out))


if __name__ == '__main__':
    main()
