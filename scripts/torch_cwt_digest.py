#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Digests of every output of the CWT kernel (`csrc/cwt_bins.cu`: B1 and
B3b in bins mode, B3 with one plane and with two, in the L1 and L2 norm,
B8 in order-2 mode and, where the checkout has it (`cwt_w2`), in its w2
mode, one signal and a batch, on both DFT engines; and, where the
checkout has the wavelet table (`wavelet_table`), every mode again with
the order-1 GMW read from its table, keys "... table <kernel> ..."; and,
where the checkout prunes stage 1 to each scale's support
(`stage1_rows`), every run again with stage 1 unpruned through the
private hook `_launch(..., klims=...)`, keys "... <kernel> unpruned
..."), so
that two checkouts of the port can be compared bit for bit on one NVIDIA
GPU; and, with `--time`, the kernels' times at the headline.

    python3 scripts/torch_cwt_digest.py [--root DIR] [--time] > out.json

`--root` names the checkout whose `ssqueezepy_tpu_torch` is imported
(default: the one holding this script). The inputs are white noise from
a seed, reflect-padded to a power of two (the radix-4 engine): N = 160000
(n_up = 262144, the bench's 293 log-piecewise scales) in float32, and
N = 10000 (n_up = 32768) and 1000 (n_up = 2048) in float32 and float64
with their own log-piecewise scales; and unpadded (n_up = N, the mixed
engine, keys "<N> <dtype> unpadded ..."): N = 160000 = 400 x 400 in
float32 (the 293 scales) and 99225 = 315 x 315 in float64; a batch
stacks the spectrum with those of seeds N + 1 and N + 2. Prints one JSON
object {"<N> <dtype> <kernel> <output>": sha256 of the bytes, ...} with
the card's name and power limit; `--time` adds "<kernel> ms" at N =
160000 reflect-padded (CUDA events, mean of 20 after 3 warm-up launches),
the unpruned runs' as "<kernel> unpruned ms".
Needs a CUDA device.
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys

import numpy as np


def main():
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument('--root', default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument('--time', action='store_true')
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, os.path.abspath(a.root))
    import ssqueezepy_tpu_torch as stq
    from ssqueezepy_tpu_torch.convert import plan_from_numpy
    from ssqueezepy_tpu_torch.models.cwt import resolve_wavelet
    from ssqueezepy_tpu_torch.ops import cwt_cuda
    from ssqueezepy_tpu_torch.ops.cwt_cuda import (cwt_bins, cwt_bins2,
                                                   cwt_fused)
    from ssqueezepy_tpu_torch.ops.fft import rfft
    from ssqueezepy_tpu_torch.ops.pad import pad_params, padsignal

    def digest(t):
        return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()
                              ).hexdigest()

    def ms(fn, reps=20, warm=3):
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

    dev = torch.device('cuda')
    out = {'card': subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip()}
    cases = [(160000, 'float32', 'reflect')] + [
        (N, dtype, 'reflect') for N in (10000, 1000)
        for dtype in ('float32', 'float64')] + [
        (160000, 'float32', None), (99225, 'float64', None)]
    for N, dtype, padtype in cases:
        tdt = getattr(torch, dtype)
        spec = ('gmw', {'dtype': dtype})
        wv = resolve_wavelet(spec, N=N)
        scales = stq.process_scales('log-piecewise', N, wv)
        if N == 160000:
            scales = scales[:300]
        plan = plan_from_numpy(scales, None, spec, N,
                               padded=padtype is not None)
        sc = torch.as_tensor(plan['scales'].ravel(), dtype=tdt, device=dev)
        n_up, n1 = ((N, 0) if padtype is None
                    else pad_params(N, padtype)[:2])

        def spectrum(seed):
            x = torch.as_tensor(np.random.default_rng(seed).standard_normal(
                N), dtype=tdt, device=dev)
            return rfft(x if padtype is None
                        else padsignal(x, padtype)).contiguous()

        gamma = 10 * float(np.finfo(dtype).eps)
        runs = {
            'B1': (('Wx', 'k'), lambda z: cwt_bins(
                z, sc, wv, n_up, n1, N, 1., True, plan['params'], gamma,
                True)),
            'B3 Wx only': (('Wx',), lambda z: cwt_fused(
                z, sc, wv, n_up, n1, N, 1., False, True)[:1]),
            'B3 Wx + dWx': (('Wx', 'dWx'), lambda z: cwt_fused(
                z, sc, wv, n_up, n1, N, 1., True, True)),
            'B3 L2': (('Wx',), lambda z: cwt_fused(
                z, sc, wv, n_up, n1, N, 1., False, False)[:1]),
            'B8': (('W', 'k'), lambda z: cwt_bins2(
                z, sc, wv, n_up, n1, N, 1., plan['params'], gamma, True)),
        }
        if hasattr(cwt_cuda, 'cwt_w2'):
            runs['B8 w2'] = (('W', 'w2'), lambda z: cwt_cuda.cwt_w2(
                z, sc, wv, n_up, n1, N, 1., gamma))
        if hasattr(cwt_cuda, 'wavelet_table'):
            wt = resolve_wavelet(('gmw', {'order': 1, 'dtype': dtype}), N=N)
            runs.update({
                'table B1': (('Wx', 'k'), lambda z: cwt_bins(
                    z, sc, wt, n_up, n1, N, 1., True, plan['params'],
                    gamma, True)),
                'table B3 Wx only': (('Wx',), lambda z: cwt_fused(
                    z, sc, wt, n_up, n1, N, 1., False, True)[:1]),
                'table B3 Wx + dWx': (('Wx', 'dWx'), lambda z: cwt_fused(
                    z, sc, wt, n_up, n1, N, 1., True, True)),
                'table B8': (('W', 'k'), lambda z: cwt_bins2(
                    z, sc, wt, n_up, n1, N, 1., plan['params'], gamma,
                    True)),
                'table B8 w2': (('W', 'w2'), lambda z: cwt_cuda.cwt_w2(
                    z, sc, wt, n_up, n1, N, 1., gamma))})
        if hasattr(cwt_cuda, 'stage1_rows'):
            # the same launches with stage 1 unpruned (the private hook of
            # `_launch`: every row's limit rows0), keys "... unpruned ..."
            full = torch.full((len(sc),), cwt_cuda.stage1_rows(n_up),
                              dtype=torch.int32, device=dev)

            def hook(wrapper, out_mode, wv, *args, **kw):
                return lambda z: cwt_cuda._launch(
                    wrapper, out_mode, z, sc, wv, n_up, n1, N, 1., *args,
                    klims=full, **kw)
            c = cwt_cuda
            bins = (True, plan['params'], gamma, True)
            for tag, w in (('', wv), ('table ', wt)):
                for kernel, f in (
                        ('B1', hook(cwt_bins, c._OUT_BINS, w, *bins)),
                        ('B3 Wx only', hook(cwt_fused, c._OUT_W, w, True)),
                        ('B3 Wx + dWx', hook(cwt_fused, c._OUT_W_DW, w,
                                             True)),
                        ('B3 L2', hook(cwt_fused, c._OUT_W, w, False)),
                        ('B8', hook(cwt_bins2, c._OUT_BINS2, w, *bins)),
                        ('B8 w2', hook(c.cwt_w2, c._OUT_W2, w, True,
                                       gamma=gamma))):
                    if tag + kernel in runs:
                        runs[tag + kernel + ' unpruned'] = (
                            runs[tag + kernel][0], f)
        xh = spectrum(N)
        xb = torch.stack([xh, spectrum(N + 1), spectrum(N + 2)])
        tag = '' if padtype else 'unpadded '
        for kernel, (names, run) in runs.items():
            for key, z in (('%d %s %s' % (N, dtype, tag), xh),
                           ('3x%d %s %s' % (N, dtype, tag), xb)):
                outs = run(z)
                for name, o in zip(names, outs):
                    out[key + '%s %s' % (kernel, name)] = digest(o)
                del outs
            torch.cuda.empty_cache()
        if a.time and N == 160000 and padtype:
            for kernel, (_, run) in runs.items():
                out['%s ms' % kernel] = ms(lambda: run(xh))
        del xh, xb
        torch.cuda.empty_cache()
    print(json.dumps(out, indent=1))


if __name__ == '__main__':
    main()
