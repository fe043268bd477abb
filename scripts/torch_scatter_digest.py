#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Digests of every output of the reassignment scatters
(`csrc/scatter_kv.cu`: B2 `scatter_kv` and B5 `shift_scatter` with mask
and const, mask only, const only and neither), so that two checkouts of
the port can be compared bit for bit on one NVIDIA GPU.

    python3 scripts/torch_scatter_digest.py [--root DIR] > digests.json

`--root` names the checkout whose `ssqueezepy_tpu_torch` is imported
(default: the one holding this script); only the wrappers' public
signatures are used, so any version of the port can be digested. The
inputs are made on the card from a seed: white-noise values with 293
rows, bins over [-3, 296) for B2 and [-588, 588) for B5 (so some are
wrapped and some dropped), a mask with 20% of cells false and a per-row
const, at N = 160000 (the headline), 10000 and 7001, in float32 and
float64, for one signal and for a batch (2 signals at the headline, 3
otherwise). Prints one JSON object {"<N> <dtype> <B> <kernel>": sha256 of
the output's bytes, ...} with the card's name and power limit. Needs a
CUDA device.
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys


def main():
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument('--root', default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, os.path.abspath(a.root))
    from ssqueezepy_tpu_torch.ops.ssq_cuda import scatter_kv, shift_scatter

    def digest(t):
        return hashlib.sha256(torch.view_as_real(t).contiguous().cpu()
                              .numpy().tobytes()).hexdigest()

    dev = torch.device('cuda')
    out = {'card': subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip()}
    na = nbins = 293
    for N in (160000, 10000, 7001):
        for dtype, cdt in (('float32', torch.complex64),
                           ('float64', torch.complex128)):
            for B in (1, 2 if N == 160000 else 3):
                shape = (na, N) if B == 1 else (B, na, N)
                g = torch.Generator(device=dev).manual_seed(N + B)
                v = torch.randn(shape, dtype=cdt, device=dev, generator=g)
                k2 = torch.randint(-3, nbins + 3, shape, dtype=torch.int32,
                                   device=dev, generator=g)
                k5 = torch.randint(-2 * nbins - 2, 2 * nbins + 2, shape,
                                   dtype=torch.int32, device=dev,
                                   generator=g)
                valid = torch.rand(shape, device=dev, generator=g) > .2
                c = torch.rand(na, dtype=getattr(torch, dtype), device=dev,
                               generator=g) + .5
                key = '%d %s %d ' % (N, dtype, B)
                out[key + 'B2'] = digest(scatter_kv(v, k2, c, nbins))
                for name, vd, cc in (('mask const', valid, c),
                                     ('mask', valid, None),
                                     ('const', None, c),
                                     ('neither', None, None)):
                    out[key + 'B5 ' + name] = digest(
                        shift_scatter(v, k5, vd, nbins, cc))
                del v, k2, k5, valid, c
                torch.cuda.empty_cache()
    print(json.dumps(out, indent=1))


if __name__ == '__main__':
    main()
