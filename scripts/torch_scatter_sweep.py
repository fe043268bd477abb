#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Times the reassignment kernels (`csrc/scatter_kv.cu`: B2, the four
instantiations of B5 and B4, the fused reassignment) at the ssq_cwt
headline on one NVIDIA GPU, and shows how the compiled kernels address
memory.

    python3 scripts/torch_scatter_sweep.py [--reps 20] [--root DIR]
        [--columns 8,16,32 --stages 2,3,4,6,8] [--sass]

`--root` names the checkout whose `ssqueezepy_tpu_torch` is built and
timed (default: the one holding this script). The inputs are made on the
card from a seed: (293, 160000) planes of values, bins over [-1, 293)
and a mask with 5% of cells false, and a (4, 293, 160000) batch for B2.
Each kernel is timed through its public wrapper (`ops/ssq_cuda.py::
scatter_kv`, `shift_scatter`) with CUDA events, the mean of `--reps`
launches after two, so any version of the port can be timed; B2 in
complex64 also on bins that load it differently (every cell dropped,
every cell in one bin, random), and the host's microseconds per call of
B2 and B5 on (8, 64) planes, where the launch and not the kernel sets the
time (wall clock over 2000 calls). B4 (`ssq_fused`) runs on white-noise
planes of Wx and dWx: at the headline (293, 160000) over a log-piecewise
grid of 293 bins with flipud, in complex64 and complex128, and at
`ssq_stft`'s hop-8 shape (300, 20000) over a linear grid of 300 bins
with a per-row Sfs. Each line is one JSON object with the time, the
bytes per second reached on the bytes the function must move (inputs
read once, output written once) and the card's name and power limit.

`--columns` and `--stages` also time B2 and B5 (mask and const) in
complex64, B2 in complex128 and every B4 run at each given count of
columns per block and of ring stages that fits, through the C entry
points of this version's library (`tc`, `stages`), with the shared bytes
per block and the blocks per SM the runtime grants (`scatter_occupancy`),
each output checked bit for bit against the plan's. `--sass` first prints one
line per kernel with its SASS memory instruction counts (`cuobjdump
-sass`): shared (LDS/STS), generic (LD/ST), global (LDG/STG) and
asynchronous-copy (LDGSTS) accesses. Needs a CUDA device.
"""
import argparse
import collections
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time


def sass_counts(lib):
    """{kernel: {opcode: count}} of the memory instructions in `lib`."""
    tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    text = subprocess.run([tool, '-sass', lib], capture_output=True,
                          text=True, timeout=300).stdout
    out, name = {}, None
    keep = ('LDS', 'STS', 'LD', 'ST', 'LDG', 'STG', 'LDGSTS', 'LDGDEPBAR',
            'DEPBAR', 'ATOMS')
    for line in text.splitlines():
        m = re.match(r'\s*Function : (\S+)', line)
        if m:
            name = m.group(1)
            out[name] = collections.Counter()
            continue
        m = re.match(r'\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)',
                     line)
        if name is not None and m and m.group(1) in keep:
            out[name][m.group(1)] += 1
    return out


def main():
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--root', default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument('--columns', default='')
    ap.add_argument('--stages', default='3')
    ap.add_argument('--sass', action='store_true')
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, os.path.abspath(a.root))
    from ssqueezepy_tpu_torch.ops import _build, ssq_cuda

    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({'root': os.path.abspath(a.root), 'card': card}),
          flush=True)
    lib = _build.load('scatter_kv')
    if a.sass:
        for name, cnt in sass_counts(_build._target('scatter_kv')).items():
            print(json.dumps({'kernel': name, 'sass': dict(cnt)}),
                  flush=True)

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

    def report(**kw):
        kw['TB_per_s'] = kw['bytes'] / kw['ms'] / 1e9
        kw['card'] = card
        print(json.dumps(kw), flush=True)

    na = nbins = 293
    N, dev = 160000, torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(0)
    vs = torch.randn((8, 64), dtype=torch.complex64, device=dev, generator=g)
    ks = torch.randint(-1, nbins, (8, 64), dtype=torch.int32, device=dev,
                       generator=g)
    cs = torch.rand(8, device=dev, generator=g)
    ms = ks >= 0
    for what, fn in (('B2', lambda: ssq_cuda.scatter_kv(vs, ks, cs, nbins)),
                     ('B5 mask + const', lambda: ssq_cuda.shift_scatter(
                         vs, ks, ms, nbins, cs))):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        torch.cuda.synchronize()
        print(json.dumps({'kernel': what, 'shape': [8, 64],
                          'host_us_per_call': (time.perf_counter() - t0)
                          / 2000 * 1e6, 'card': card}), flush=True)
    del vs, ks, cs, ms
    k = torch.randint(-1, nbins, (na, N), dtype=torch.int32, device=dev,
                      generator=g)
    valid = torch.rand((na, N), device=dev, generator=g) >= .05
    columns = [int(c) for c in a.columns.split(',') if c]
    stages = [int(c) for c in a.stages.split(',') if c]
    for cdt in (torch.complex64, torch.complex128):
        v = torch.randn((na, N), dtype=cdt, device=dev, generator=g)
        c = torch.rand(na, dtype=v.real.dtype, device=dev, generator=g) + .5
        it, f64 = v.element_size(), int(cdt == torch.complex128)
        out_bytes = nbins * N * it
        # (name, kind, call, bytes read, mask, const)
        runs = [('B2', 0, lambda: ssq_cuda.scatter_kv(v, k, c, nbins),
                 na * N * (it + 4) + na * c.element_size(), None, c),
                ('B5 mask + const', 1,
                 lambda: ssq_cuda.shift_scatter(v, k, valid, nbins, c),
                 na * N * (it + 5) + na * c.element_size(), valid, c)]
        if cdt == torch.complex64:
            runs += [
                ('B5 mask', 2,
                 lambda: ssq_cuda.shift_scatter(v, k, valid, nbins),
                 na * N * (it + 5), valid, None),
                ('B5 const', 3,
                 lambda: ssq_cuda.shift_scatter(v, k, None, nbins, c),
                 na * N * (it + 4) + na * c.element_size(), None, c),
                ('B5 neither', 4,
                 lambda: ssq_cuda.shift_scatter(v, k, None, nbins),
                 na * N * (it + 4), None, None)]
        for what, kind, fn, nread, vd, cc in runs:
            report(kernel=what, dtype=str(cdt), shape=[na, N], ms=timed(fn),
                   bytes=nread + out_bytes)
            if not columns or (kind > 1 or (kind == 1 and f64)):
                continue
            ref = fn()
            for tc, st in ((tc, st) for tc in columns for st in stages):
                granted, smem = ctypes.c_int(0), ctypes.c_int(0)
                if lib.scatter_occupancy(kind, f64, nbins, tc, st,
                                         ctypes.byref(granted),
                                         ctypes.byref(smem)) != 0:
                    continue
                out = torch.empty_like(ref)
                stream = torch.cuda.current_stream().cuda_stream
                if kind == 0:
                    entry = lib.scatter_kv_f64 if f64 else lib.scatter_kv_f32
                    call = (lambda: entry(v.data_ptr(), k.data_ptr(),
                                          c.data_ptr(), 1, na, N, nbins, tc,
                                          st, out.data_ptr(), stream))
                else:
                    entry = lib.shift_scatter_f32
                    call = (lambda: entry(v.data_ptr(), k.data_ptr(),
                                          vd.data_ptr(), cc.data_ptr(), 1,
                                          na, N, nbins, tc, st,
                                          out.data_ptr(), stream))
                _build.check(call(), what)
                report(kernel=what, dtype=str(cdt), shape=[na, N],
                       columns=tc, stages=st, smem_bytes=smem.value,
                       blocks_per_sm=granted.value, ms=timed(call),
                       bytes=nread + out_bytes,
                       bit_identical_to_plan=torch.equal(out, ref))
                del out
            del ref
        if cdt == torch.complex64:
            nbytes = na * N * (it + 4) + na * 4 + out_bytes
            for what, kb in (('every cell dropped', torch.full_like(k, -1)),
                             ('every cell in bin 0', torch.zeros_like(k)),
                             ('random bins', k)):
                report(kernel='B2', dtype=str(cdt), shape=[na, N],
                       bins=what, bytes=nbytes,
                       ms=timed(lambda: ssq_cuda.scatter_kv(v, kb, c,
                                                            nbins)))
            B = 4
            vb = torch.randn((B, na, N), dtype=cdt, device=dev, generator=g)
            kb = torch.randint(-1, nbins, (B, na, N), dtype=torch.int32,
                               device=dev, generator=g)
            report(kernel='B2', dtype=str(cdt), shape=[B, na, N],
                   bytes=B * (na * N * (it + 4) + out_bytes) + na * 4,
                   ms=timed(lambda: ssq_cuda.scatter_kv(vb, kb, c, nbins)))
            del vb, kb
        del v, c
        torch.cuda.empty_cache()
    b4_runs(ssq_cuda, lib, timed, report, columns, stages)


def b4_runs(ssq_cuda, lib, timed, report, columns, stages):
    """B4 through its public wrapper and, for each (columns, stages),
    through this version's C entry point (kind 5 without Sfs, 6 with)."""
    import torch
    from ssqueezepy_tpu_torch.ops import _build
    from ssqueezepy_tpu_torch.ops.ssq_kernels import ssq_bin_params
    from torch_scatter_digest import grid
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(4)
    for what, cdt, na, N, mode, flipud, with_sfs in (
            ('B4', torch.complex64, 293, 160000, 'log-piecewise', True,
             False),
            ('B4', torch.complex128, 293, 160000, 'log-piecewise', True,
             False),
            ('B4 Sfs', torch.complex64, 300, 20000, 'lin', False, True)):
        nbins = na
        v = torch.randn((na, N), dtype=cdt, device=dev, generator=g)
        dv = torch.randn((na, N), dtype=cdt, device=dev, generator=g)
        c = torch.rand(na, dtype=v.real.dtype, device=dev, generator=g) + .5
        sfs = (torch.linspace(0, .5, na, dtype=c.dtype, device=dev)
               if with_sfs else None)
        params = ssq_bin_params(grid(mode, nbins), mode != 'lin')
        it, f64 = v.element_size(), int(cdt == torch.complex128)
        nbytes = (2 * na * N * it + na * c.element_size() * (1 + with_sfs)
                  + nbins * N * it)

        def fn():
            return ssq_cuda.ssq_fused(v, dv, c, params, .1, flipud, sfs)
        report(kernel=what, dtype=str(cdt), shape=[na, N], mode=mode,
               ms=timed(fn), bytes=nbytes)
        if not columns:
            continue
        from ssqueezepy_tpu_torch.ops.cwt_cuda import _MODES, _bin_args
        ref = fn()
        a0, d0, a1, d1, idx1 = _bin_args(params)
        entry = lib.ssq_fused_f64 if f64 else lib.ssq_fused_f32
        for tc, st in ((tc, st) for tc in columns for st in stages):
            granted, smem = ctypes.c_int(0), ctypes.c_int(0)
            if lib.scatter_occupancy(5 + with_sfs, f64, nbins, tc, st,
                                     ctypes.byref(granted),
                                     ctypes.byref(smem)) != 0:
                continue
            out = torch.empty_like(ref)
            ip = (ctypes.c_int * 10)(1, na, N, nbins, tc, st,
                                     _MODES[mode], int(idx1), nbins - 1,
                                     int(flipud))
            dp = (ctypes.c_double * 5)(.1, a0, d0, a1, d1)
            stream = torch.cuda.current_stream().cuda_stream
            call = (lambda: entry(v.data_ptr(), dv.data_ptr(),
                                  c.data_ptr(), None if sfs is None
                                  else sfs.data_ptr(), ip, dp,
                                  out.data_ptr(), stream))
            _build.check(call(), what)
            report(kernel=what, dtype=str(cdt), shape=[na, N], mode=mode,
                   columns=tc, stages=st, smem_bytes=smem.value,
                   blocks_per_sm=granted.value, ms=timed(call),
                   bytes=nbytes, bit_identical_to_plan=torch.equal(out, ref))
            del out
        del v, dv, c, ref
        torch.cuda.empty_cache()


if __name__ == '__main__':
    main()
