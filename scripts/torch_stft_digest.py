#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Digests of every output of the STFT table kernel (`csrc/stft_conv.cu`:
B6 in its modes 0 Sx, 1 Sx + dSx, 2 Sx + bins, and B7), so that two
checkouts of the port can be compared bit for bit on one NVIDIA GPU.

    python3 scripts/torch_stft_digest.py [--root DIR] > digests.json

`--root` names the checkout whose `ssqueezepy_tpu_torch` is imported
(default: the one holding this script). The inputs are white noise from a
seed at N = 160000 (n_fft = 598, Np2 = 163840 = 5 x 2^15) in float32 and
at N = 10000 (Np2 = 12288 = 3 x 2^12), 9000 (n_fft = 128, 9 x 2^10) and
7000 (n_fft = 256, 15 x 2^9) in float32 and float64. Prints one JSON
object {"<N> <dtype> <output>": sha256 of the bytes, ...} with the card's
name and power limit. Needs a CUDA device.
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
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, os.path.abspath(a.root))
    from ssqueezepy_tpu_torch.models.ssq_stft import fsst2_plan, stft_plan
    from ssqueezepy_tpu_torch.models.stft import signal_spectrum
    from ssqueezepy_tpu_torch.ops.stft_conv import conv_bank, conv_table
    from ssqueezepy_tpu_torch.ops.stft_cuda import fsst2_conv, stft_conv

    def digest(t):
        return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()
                              ).hexdigest()

    dev = torch.device('cuda')
    out = {'card': subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip()}
    cases = [(160000, 598, 'float32')] + [
        (N, n_fft, dtype) for N, n_fft in ((10000, 598), (9000, 128),
                                           (7000, 256))
        for dtype in ('float32', 'float64')]
    for N, n_fft, dtype in cases:
        x = np.random.default_rng(N).standard_normal(N)
        xh = signal_spectrum(torch.as_tensor(x, dtype=getattr(torch, dtype),
                                             device=dev), n_fft, 'reflect')
        gamma = 10 * float(np.finfo(dtype).eps)
        sp = stft_plan(None, None, n_fft, n_fft, 1., dtype)
        H = conv_table(sp.window, n_fft, xh.shape[0], True, dtype, dev)
        Hd = conv_table(sp.diff_window, n_fft, xh.shape[0], True, dtype, dev)
        bins = dict(Sfs=torch.as_tensor(sp.Sfs, device=dev),
                    params=sp.params, flipud=False, gamma=gamma)
        key = '%d %s ' % (N, dtype)
        out[key + 'mode 0 Sx'] = digest(stft_conv(xh, H, None, N)[0])
        Sx, dSx = stft_conv(xh, H, Hd, N, 2.)
        out[key + 'mode 1 Sx'], out[key + 'mode 1 dSx'] = map(digest,
                                                              (Sx, dSx))
        Sx, k = stft_conv(xh, H, Hd, N, 1., bins)
        out[key + 'mode 2 Sx'], out[key + 'mode 2 k'] = map(digest, (Sx, k))
        del H, Hd, Sx, dSx, k
        fp = fsst2_plan(None, None, n_fft, n_fft, 1., dtype)
        bank = conv_bank(fp.bank, n_fft, xh.shape[0], True, dtype, dev)
        bins7 = dict(Sfs=torch.as_tensor(fp.Sfs, device=dev),
                     params=fp.params, flipud=False, gamma=gamma)
        V, k = fsst2_conv(xh, bank, N, 1., bins7)
        out[key + 'B7 V'], out[key + 'B7 k'] = map(digest, (V, k))
        del bank, V, k
        torch.cuda.empty_cache()
    print(json.dumps(out, indent=1))


if __name__ == '__main__':
    main()
