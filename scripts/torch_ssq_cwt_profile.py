#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Where the time of a PyTorch port call goes, on one NVIDIA GPU.

    python3 scripts/torch_ssq_cwt_profile.py [--transform ssq_cwt]
        [--n 160000] [--calls 5] [--backward]

Runs one of the bench calls on white noise in float32 — `ssq_cwt` (the
headline: the bench's 293-row log-piecewise plan and its ssq_freqs),
`cwt` (the same scales), `ssq_cwt2` (the same scales, no ssq_freqs),
`ssq_stft`, `stft` or `ssq_stft2` (n_fft = 598, hop 1), `ssq_cwt_b4`
(`ssq_cwt` on a (4, N) batch), `ssq_cwt_dwx` (`ssq_cwt` with
`get_dWx=True`), `ssq_stft_hop8` (`ssq_stft` at hop 8), `ssq_cwt_getw`
(`ssq_cwt` with `get_w=True`), `ssq_stft_hop8_abs` (`ssq_stft` at hop
8 with 'abs' squeezing), `ssqueeze_dwx` (`ssqueeze` of the
`get_dWx=True` call's Wx and dWx), or `stft_b4`, `ssq_stft_b4`,
`ssq_stft_hop8_b4`, `ssq_stft_hop8_abs_b4`, `ssq_stft2_b4`,
`ssq_cwt2_b4` (those calls on the (4, N) batch), `ssq_cwt_padnone`,
`ssq_cwt_padnone_b4`, `cwt_padnone`, `ssq_cwt2_padnone` (`padtype=None`,
the same scales, no ssq_freqs: n_up = N on the CWT kernel's mixed engine
at N = 160000), `cwt_rpadded` (`cwt(rpadded=True)`), `ssq_cwt_numeric`
(`ssq_cwt(difftype='numeric', get_w=True)`, the same scales),
`ssq_cwt2_getw`, `ssq_cwt2_getw_padnone`, `ssq_stft2_getw` or
`ssq_stft2_getw_b4` (the order-2 calls with `get_w=True`: the w2 modes
of B8 and B7, then B5), or with another wavelet at its own
log-piecewise scales (at most 300) `ssq_cwt_cmhat`, `ssq_cwt_gmw_order1`,
`ssq_cwt_morlet`, `ssq_cwt_order01` (`order=(0, 1)`, the GMW's scales),
`cwt_hhhat`, `ssq_cwt_bump_b4`, `ssq_cwt2_morlet`,
`ssq_cwt2_cmhat_getw`, `cwt_custom` (a Gaussian bump at w = 4 as a
function, at cmhat's scales), or one `process` of a streaming plan at
chunk 4096 on chunks already on the card (`--n` unused): `stream_ssq_cwt97`
(`StreamingSSQCWT`, 97 scales geomspace(1, 64), history = lookahead =
2048), `stream_ssq_cwt97_b4` (the same on a (4, 4096) batch),
`stream_ssq_cwt181` (181 scales geomspace(1, 512), history = lookahead
= 8192), `stream_multirate181` (`StreamingMultirateSSQCWT`, the 181),
`stream_ssq_stft512` (`StreamingSSQSTFT`, n_fft = 512), or a 160000-sample
record through a made `StreamingSSQCWT(10000, 'gmw', N=160000)`
(`stream_ssq_cwt_160k`, its chunks and finalize) —
under `torch.profiler` after warm-up and prints one JSON line: device
time per kernel name (summed over the profiled calls, divided by the
call count), the wall time per call, the device's idle share of that
wall time, and the host's top-level torch operator calls per call (an
`aten::` op not inside another: what the host dispatches). With
`--backward` each profiled call is the forward with the signal requiring
grad (for `ssqueeze_dwx`, its Wx) and the backward of sum |out|^2 of its
first output (Tx, Wx or Sx): the kernels' forward and the torch ops of
their autograd Functions' backward (the streaming plans are
forward-only). Needs a CUDA device.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np


def _gauss4(w):
    """A user's wavelet: a real Gaussian bump at w = 4."""
    return (-(w - 4.) ** 2).exp() * (w > 0)


# name: (call of (package, x, batch, scales), the wavelet whose own
# scales it takes)
_WAVELET_CALLS = {
    'ssq_cwt_cmhat': (lambda s, x, xb, sc: s.ssq_cwt(x, 'cmhat', scales=sc),
                      'cmhat'),
    'ssq_cwt_gmw_order1': (lambda s, x, xb, sc: s.ssq_cwt(
        x, ('gmw', {'order': 1}), scales=sc), ('gmw', {'order': 1})),
    'ssq_cwt_morlet': (lambda s, x, xb, sc: s.ssq_cwt(x, 'morlet',
                                                      scales=sc), 'morlet'),
    'ssq_cwt_order01': (lambda s, x, xb, sc: s.ssq_cwt(x, order=(0, 1),
                                                       scales=sc), 'gmw'),
    'cwt_hhhat': (lambda s, x, xb, sc: s.cwt(x, 'hhhat', scales=sc),
                  'hhhat'),
    'ssq_cwt_bump_b4': (lambda s, x, xb, sc: s.ssq_cwt(xb, 'bump',
                                                       scales=sc), 'bump'),
    'ssq_cwt2_morlet': (lambda s, x, xb, sc: s.ssq_cwt2(x, 'morlet',
                                                        scales=sc),
                        'morlet'),
    'ssq_cwt2_cmhat_getw': (lambda s, x, xb, sc: s.ssq_cwt2(
        x, 'cmhat', scales=sc, get_w=True), 'cmhat'),
    'cwt_custom': (lambda s, x, xb, sc: s.cwt(x, _gauss4, scales=sc),
                   'cmhat'),
}

_G32 = ('gmw', {'dtype': 'float32'})
_SC97 = dict(scales=np.geomspace(1., 64., 97).reshape(-1, 1), nv=None,
             N=65536, history=2048, lookahead=2048)
# name: (the plan of `stq`, the batch it streams)
_STREAM_PLANS = {
    'stream_ssq_cwt97': (lambda s: s.StreamingSSQCWT(4096, _G32, **_SC97),
                         1),
    'stream_ssq_cwt97_b4': (lambda s: s.StreamingSSQCWT(4096, _G32,
                                                        **_SC97), 4),
    'stream_ssq_cwt181': (lambda s: s.StreamingSSQCWT(
        4096, _G32, scales=np.geomspace(1., 512., 181).reshape(-1, 1),
        nv=None, N=65536, history=8192, lookahead=8192), 1),
    'stream_multirate181': (lambda s: s.StreamingMultirateSSQCWT(
        4096, _G32, scales=np.geomspace(1., 512., 181).reshape(-1, 1),
        nv=None, N=65536), 1),
    'stream_ssq_stft512': (lambda s: s.StreamingSSQSTFT(
        4096, n_fft=512, dtype='float32'), 1),
}


def main():
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import profile, ProfilerActivity
    ap = argparse.ArgumentParser()
    ap.add_argument('--transform', default='ssq_cwt',
                    choices=('ssq_cwt', 'cwt', 'ssq_stft', 'stft',
                             'ssq_cwt2', 'ssq_stft2', 'ssq_cwt_b4',
                             'ssq_cwt_dwx', 'ssq_stft_hop8', 'ssq_cwt_getw',
                             'ssq_stft_hop8_abs', 'ssqueeze_dwx',
                             'stft_b4', 'ssq_stft_b4', 'ssq_stft_hop8_b4',
                             'ssq_stft_hop8_abs_b4', 'ssq_stft2_b4',
                             'ssq_cwt2_b4', 'ssq_cwt_padnone',
                             'ssq_cwt_padnone_b4', 'cwt_padnone',
                             'cwt_rpadded', 'ssq_cwt_numeric',
                             'ssq_cwt2_padnone', 'ssq_cwt2_getw',
                             'ssq_cwt2_getw_padnone', 'ssq_stft2_getw',
                             'ssq_stft2_getw_b4', 'stream_ssq_cwt_160k')
                    + tuple(_WAVELET_CALLS) + tuple(_STREAM_PLANS))
    ap.add_argument('--n', type=int, default=160000)
    ap.add_argument('--calls', type=int, default=5)
    ap.add_argument('--backward', action='store_true')
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    os.environ.setdefault('SSQ_TPU_TORCH_CACHE',
                          os.path.join(root, 'build', 'plan_cache'))
    import ssqueezepy_tpu_torch as stq
    from ssqueezepy_tpu_torch.models.ssqueezing import \
        _compute_associated_frequencies

    N = a.n
    spec = ('gmw', {'dtype': 'float32'})
    wav = stq.Wavelet(spec)
    scales = stq.process_scales('log-piecewise', N, wav)[:300]
    freqs = _compute_associated_frequencies(
        scales, N, wav, 'log-piecewise', maprange='peak', was_padded=True,
        dt=1, transform='cwt')
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(N)
                        .astype(np.float32), device='cuda')
    xb = torch.as_tensor(np.random.default_rng(1).standard_normal((4, N))
                         .astype(np.float32), device='cuda')
    kw = dict(wavelet=spec, scales=scales, ssq_freqs=freqs)
    if a.transform in _WAVELET_CALLS:
        fn, wspec = _WAVELET_CALLS[a.transform]
        wsc = scales if wspec == 'gmw' else stq.process_scales(
            'log-piecewise', N, stq.Wavelet(wspec))[:300]
        call = lambda: fn(stq, x, xb, wsc)         # noqa: E731
    if a.transform in _STREAM_PLANS:
        make, b = _STREAM_PLANS[a.transform]
        plan = make(stq)
        chunks = torch.as_tensor(np.random.default_rng(2).standard_normal(
            (8, b, 4096)).astype(np.float32), device='cuda')
        if b == 1:
            chunks = chunks[:, 0]
        step = iter(range(1 << 62))
        call = lambda: plan.process(chunks[next(step) % 8])  # noqa: E731
    if a.transform == 'stream_ssq_cwt_160k':
        from ssqueezepy_tpu_torch.streaming import _drive
        plan160 = stq.StreamingSSQCWT(10000, 'gmw', N=160000)
        x160 = torch.as_tensor(np.random.default_rng(0).standard_normal(
            160000).astype(np.float32), device='cuda')

        def call():
            plan160.reset()
            return _drive(plan160, x160, 10000)
    if a.transform == 'ssqueeze_dwx':
        _, Wx, _, _, dWx = stq.ssq_cwt(x, get_dWx=True, **kw)
    calls = {
        'ssqueeze_dwx': lambda: stq.ssqueeze(
            Wx, dWx=dWx, gamma=10 * float(np.finfo(np.float32).eps),
            scales=scales, ssq_freqs=freqs, flipud=True),
        'ssq_cwt': lambda: stq.ssq_cwt(x, **kw),
        'ssq_cwt_b4': lambda: stq.ssq_cwt(xb, **kw),
        'ssq_cwt_dwx': lambda: stq.ssq_cwt(x, get_dWx=True, **kw),
        'ssq_stft_hop8': lambda: stq.ssq_stft(x, n_fft=598, hop_len=8),
        'ssq_cwt_getw': lambda: stq.ssq_cwt(x, get_w=True, **kw),
        'ssq_stft_hop8_abs': lambda: stq.ssq_stft(x, n_fft=598, hop_len=8,
                                                  squeezing='abs'),
        'cwt': lambda: stq.cwt(x, wavelet=spec, scales=scales),
        'ssq_stft': lambda: stq.ssq_stft(x, n_fft=598),
        'stft': lambda: stq.stft(x, n_fft=598),
        'ssq_cwt2': lambda: stq.ssq_cwt2(x, spec, scales=scales),
        'ssq_stft2': lambda: stq.ssq_stft2(x, n_fft=598),
        'stft_b4': lambda: stq.stft(xb, n_fft=598),
        'ssq_stft_b4': lambda: stq.ssq_stft(xb, n_fft=598),
        'ssq_stft_hop8_b4': lambda: stq.ssq_stft(xb, n_fft=598, hop_len=8),
        'ssq_stft_hop8_abs_b4': lambda: stq.ssq_stft(
            xb, n_fft=598, hop_len=8, squeezing='abs'),
        'ssq_stft2_b4': lambda: stq.ssq_stft2(xb, n_fft=598),
        'ssq_cwt2_b4': lambda: stq.ssq_cwt2(xb, spec, scales=scales),
        'ssq_cwt_padnone': lambda: stq.ssq_cwt(x, wavelet=spec, scales=scales,
                                               padtype=None),
        'ssq_cwt_padnone_b4': lambda: stq.ssq_cwt(
            xb, wavelet=spec, scales=scales, padtype=None),
        'cwt_padnone': lambda: stq.cwt(x, wavelet=spec, scales=scales,
                                       padtype=None),
        'cwt_rpadded': lambda: stq.cwt(x, wavelet=spec, scales=scales,
                                       rpadded=True),
        'ssq_cwt_numeric': lambda: stq.ssq_cwt(
            x, wavelet=spec, scales=scales, difftype='numeric', get_w=True),
        'ssq_cwt2_padnone': lambda: stq.ssq_cwt2(x, spec, scales=scales,
                                                 padtype=None),
        'ssq_cwt2_getw': lambda: stq.ssq_cwt2(x, spec, scales=scales,
                                              get_w=True),
        'ssq_cwt2_getw_padnone': lambda: stq.ssq_cwt2(
            x, spec, scales=scales, padtype=None, get_w=True),
        'ssq_stft2_getw': lambda: stq.ssq_stft2(x, n_fft=598, get_w=True),
        'ssq_stft2_getw_b4': lambda: stq.ssq_stft2(xb, n_fft=598,
                                                   get_w=True),
    }
    if a.transform in calls:
        call = calls[a.transform]
    if a.backward:
        if a.transform in _STREAM_PLANS or a.transform.startswith('stream'):
            sys.exit("the streaming plans are forward-only")
        for t in (x, xb) + ((Wx,) if a.transform == 'ssqueeze_dwx' else ()):
            t.requires_grad_()
        forward = call

        def call():
            out = forward()
            plane = out[0] if isinstance(out, tuple) else out
            (plane.real ** 2 + plane.imag ** 2).sum().backward()
    for _ in range(3):
        call()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(a.calls):
            call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / a.calls

    # device-side events only (kernels, copies): the host ops that
    # launched them report the same time again
    per_kernel = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, 'self_device_time_total',
                         getattr(ev, 'self_cuda_time_total', 0))
        if ev.device_type == DeviceType.CUDA and dev_us > 0:
            per_kernel[ev.key[:80]] = dev_us / 1e3 / a.calls
    busy_ms = sum(per_kernel.values())
    host_ops = sum(1 for ev in prof.events() if ev.name.startswith('aten::')
                   and (ev.cpu_parent is None or
                        not ev.cpu_parent.name.startswith('aten::')))
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({
        'card': smi, 'transform': a.transform, 'N': N, 'calls': a.calls,
        'backward': a.backward,
        'wall_ms_per_call': wall_ms,
        'device_busy_ms_per_call': busy_ms,
        'device_idle_share': (1 - busy_ms / wall_ms) if wall_ms else None,
        'host_aten_ops_per_call': host_ops / a.calls,
        'device_ms_per_call_by_kernel': dict(sorted(
            per_kernel.items(), key=lambda kv: -kv[1]))}))


if __name__ == '__main__':
    main()
