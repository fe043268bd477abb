#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Digests of every output of the STFT table kernel (`csrc/stft_conv.cu`:
B6 in its modes 0 Sx, 1 Sx + dSx, 2 Sx + bins, and B7; and B7's w2 mode
where the checkout has it, `fsst2_w`), so that two checkouts of the port
can be compared bit for bit on one NVIDIA GPU.

    python3 scripts/torch_stft_digest.py [--root DIR] > digests.json

`--root` names the checkout whose `ssqueezepy_tpu_torch` is imported
(default: the one holding this script). The inputs are white noise from a
seed at N = 160000 (n_fft = 598, Np2 = 163840 = 5 x 2^15) in float32 and
at N = 10000 (Np2 = 12288 = 3 x 2^12), 9000 (n_fft = 128, 9 x 2^10) and
7000 (n_fft = 256, 15 x 2^9) in float32 and float64. Prints one JSON
object {"<N> <dtype> <output>": sha256 of the bytes, ...} with the card's
name and power limit. Needs a CUDA device.

Where the checkout's kernel takes a batch of spectra (it counts on
`stft_conv.batched_launches`), each case also runs a batch: the spectrum
above stacked with those of seeds N + 1 (and N + 2 below 160000), keys
"<B>x<N> <dtype> <output>", and "... rows equal" says whether each row of
every batched output is bit-identical to its spectrum launched alone.

The tables above are the full ones (`conv_table`, `conv_bank`) in every
checkout. Where the checkout has the band plan (`ops/stft_conv.py::
stft_tables`), each float32 case also runs every mode on the banded
tables that the public calls take, under the keys "<N> float32 banded
<mode> <output>" (and "<B>x<N> float32 banded ..." for the batch).
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
    from ssqueezepy_tpu_torch.ops import stft_conv as tables
    from ssqueezepy_tpu_torch.ops.stft_conv import conv_bank, conv_table
    from ssqueezepy_tpu_torch.ops import stft_cuda
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
    batched = hasattr(stft_conv, 'batched_launches')

    def spectrum(seed, N, n_fft, dtype):
        x = np.random.default_rng(seed).standard_normal(N)
        return signal_spectrum(torch.as_tensor(
            x, dtype=getattr(torch, dtype), device=dev), n_fft, 'reflect')

    for N, n_fft, dtype in cases:
        xh = spectrum(N, N, n_fft, dtype)
        gamma = 10 * float(np.finfo(dtype).eps)
        sp = stft_plan(None, None, n_fft, n_fft, 1., dtype)
        H = conv_table(sp.window, n_fft, xh.shape[0], True, dtype, dev)
        Hd = conv_table(sp.diff_window, n_fft, xh.shape[0], True, dtype, dev)
        bins = dict(Sfs=torch.as_tensor(sp.Sfs, device=dev),
                    params=sp.params, flipud=False, gamma=gamma)
        fp = fsst2_plan(None, None, n_fft, n_fft, 1., dtype)
        bank = conv_bank(fp.bank, n_fft, xh.shape[0], True, dtype, dev)
        bins7 = dict(Sfs=torch.as_tensor(fp.Sfs, device=dev),
                     params=fp.params, flipud=False, gamma=gamma)
        def modes(H, Hd, bank):
            runs = (('mode 0', ('Sx',), lambda z: stft_conv(z, H, None,
                                                            N)[:1]),
                    ('mode 1', ('Sx', 'dSx'), lambda z: stft_conv(
                        z, H, Hd, N, 2.)),
                    ('mode 2', ('Sx', 'k'), lambda z: stft_conv(
                        z, H, Hd, N, 1., bins)),
                    ('B7', ('V', 'k'), lambda z: fsst2_conv(z, bank, N, 1.,
                                                            bins7)))
            if hasattr(stft_cuda, 'fsst2_w'):
                runs += (('B7 w2', ('V', 'w2'), lambda z: stft_cuda.fsst2_w(
                    z, bank, N, 1., bins7['Sfs'], gamma)),)
            return runs

        sets = [('', modes(H, Hd, bank))]
        if hasattr(tables, 'stft_tables') and dtype == 'float32':
            sets.append(('banded ', modes(
                *tables.stft_tables(sp.window, sp.diff_window, n_fft,
                                    xh.shape[0], True, dtype, dev),
                tables.fsst2_tables(fp.bank, n_fft, xh.shape[0], True,
                                    dtype, dev))))
        for tag, runs in sets:
            key = '%d %s %s' % (N, dtype, tag)
            for mode, names, run in runs:
                for name, o in zip(names, run(xh)):
                    out[key + '%s %s' % (mode, name)] = digest(o)
            if batched:
                B = 2 if N == 160000 else 3
                xb = torch.stack([xh] + [spectrum(N + b, N, n_fft, dtype)
                                         for b in range(1, B)])
                keyb, same = '%dx%d %s %s' % (B, N, dtype, tag), True
                for mode, names, run in runs:
                    outs = run(xb)
                    for name, o in zip(names, outs):
                        out[keyb + '%s %s' % (mode, name)] = digest(o)
                    for b in range(B):
                        same = same and all(
                            torch.equal(o[b], o1) for o, o1 in
                            zip(outs, run(xb[b].contiguous())))
                    del outs
                out[keyb + 'rows equal'] = same
                del xb
        del H, Hd, bank, sets
        torch.cuda.empty_cache()
    print(json.dumps(out, indent=1))


if __name__ == '__main__':
    main()
