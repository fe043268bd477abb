#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Compare the launch plans of the CWT and STFT kernels of two checkouts
of the port, on the CPU (no card, no nvcc).

    python3 scripts/torch_plan_compare.py --old DIR [--new DIR]

For every length the kernels take up to 2^22 (each n_up >= 4 whose prime
factors are at most 7, `ops/cwt_cuda.py::bins_plan`; each Np2 =
2^a * {1, 3, 5, 9, 15}, `ops/stft_cuda.py::launch_plan`), in complex64
and complex128 and for 1, 2 and 5 planes, it builds the plan with each
checkout's functions and prints one JSON object: how many plans the old
checkout builds, how many of them the new one builds alike, which differ,
and which lengths only one of the two takes. `--new` defaults to the
checkout holding this script.
"""
import argparse
import importlib
import json
import os
import sys


def _load(root):
    for name in [m for m in sys.modules
                 if m.split('.')[0] == 'ssqueezepy_tpu_torch']:
        del sys.modules[name]
    sys.path.insert(0, os.path.abspath(root))
    try:
        return (importlib.import_module('ssqueezepy_tpu_torch.ops.cwt_cuda'),
                importlib.import_module('ssqueezepy_tpu_torch.ops.stft_cuda'))
    finally:
        sys.path.pop(0)


def _smooth7(n):
    for p in (2, 3, 5, 7):
        while n % p == 0:
            n //= p
    return n == 1


def _plans(cwt, stft):
    out = {}
    cwt_lens = [n for n in range(4, (1 << 22) + 1) if _smooth7(n)]
    stft_lens = sorted(odd << lg for lg in range(23) for odd in
                       (1, 3, 5, 9, 15) if 4 <= odd << lg <= 1 << 22)
    for kind, lens, plan in (('cwt', cwt_lens, cwt.bins_plan),
                             ('stft', stft_lens, stft.launch_plan)):
        for n in lens:
            for itemsize in (8, 16):
                for planes in (1, 2, 5):
                    try:
                        p = tuple(plan(n, itemsize, planes))
                    except NotImplementedError:
                        p = None
                    out['%s %d %d %d' % (kind, n, itemsize, planes)] = p
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--old', required=True)
    ap.add_argument('--new', default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    a = ap.parse_args()
    old = _plans(*_load(a.old))
    new = _plans(*_load(a.new))
    built = [k for k, p in old.items() if p is not None]
    print(json.dumps({
        'old': os.path.abspath(a.old), 'new': os.path.abspath(a.new),
        'plans built by old': len(built),
        'of them built alike by new': sum(old[k] == new[k] for k in built),
        'differ': [k for k in built if old[k] != new[k]],
        'only new builds': [k for k in old if old[k] is None
                            and new[k] is not None],
        'only old builds': [k for k in old if new[k] is None
                            and old[k] is not None]}, indent=1))


if __name__ == '__main__':
    main()
