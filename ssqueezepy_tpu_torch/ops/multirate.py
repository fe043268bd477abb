# -*- coding: utf-8 -*-
"""Multirate primitives: halfband decimation and interpolation.

Counterpart of `ssqueezepy_tpu/ops/multirate.py`, the octave cascade of
the multirate streaming CWT (`streaming_multirate.py`). The halfband FIR
is a Kaiser-windowed sinc with exact zeros at even offsets from its
centre, linear phase with group delay ``(taps - 1) / 2`` samples; its
design is host numpy, cached. The filtering is
`torch.nn.functional.conv1d` on the signal's device, as the JAX package
runs it through `lax.conv_general_dilated`, outside any kernel of its
own. On a CUDA device cuDNN runs it with TF32 off (full float32
products) and its deterministic algorithms, so a stream repeats bit for
bit.
"""
import functools

import numpy as np
import torch

__all__ = ['halfband_fir', 'conv_valid', 'decimate2', 'interp2']


@functools.lru_cache(maxsize=8)
def halfband_fir(taps=63, beta=9.0):
    """Linear-phase halfband lowpass (cutoff pi/2). `taps` must be odd
    with (taps+1) % 4 == 0 so every second off-center tap is a true
    zero. Normalized to unit DC gain; h[center] = 0.5."""
    taps = int(taps)
    if taps % 2 == 0 or (taps + 1) % 4:
        raise ValueError("taps must be odd with taps+1 divisible by 4")
    c = (taps - 1) // 2
    n = np.arange(taps) - c
    h = 0.5 * np.sinc(n / 2.0)
    h *= np.kaiser(taps, beta)
    # exact halfband zeros (the window leaves ~1e-17 there)
    h[(n % 2 == 0) & (n != 0)] = 0.0
    h /= h.sum()
    return h


_FIR = {}


def _fir(h, dtype, device):
    """The (1, 1, taps) conv1d weight of the FIR `h` (numpy), flipped as
    the JAX package flips it for its convolution (h is symmetric, so the
    flip changes nothing), kept per (h, dtype, device): a per-call upload
    would block the host until the stream drains."""
    key = (h.tobytes(), len(h), dtype, str(device))
    k = _FIR.get(key)
    if k is None:
        k = _FIR[key] = torch.as_tensor(h[::-1].copy(), dtype=dtype,
                                        device=device).reshape(1, 1, -1)
    return k


def _conv(x, k):
    """'valid' correlation of each row of `x` (..., n) with the taps `k`:
    conv1d over the rows as a batch, TF32 off, deterministic on cuDNN."""
    shape = x.shape
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                    benchmark=False, deterministic=True,
                                    allow_tf32=False):
        y = torch.nn.functional.conv1d(x.reshape(-1, 1, shape[-1]), k)
    return y.reshape(shape[:-1] + (y.shape[-1],))


def conv_valid(x, h):
    """'valid' correlation-style FIR along the last axis:
    ``y[i] = sum_k h[k] * x[i + k]``, out length n - len(h) + 1.
    x: (..., n) real tensor; h: numpy (taps,)."""
    return _conv(x, _fir(h, x.dtype, x.device))


def decimate2(x, taps=63):
    """Halfband-filter + downsample-by-2 along the last axis:
    ``y[m] = (h * x)[2m]`` with ``(h*x)[i] = sum_k h[k] x[i+k]`` (group
    delay (taps-1)/2 samples at the input rate). Out length:
    (n - taps + 1 + 1) // 2."""
    return conv_valid(x, halfband_fir(taps))[..., ::2]


def interp2(x, n_out=None, taps=63):
    """Upsample-by-2 along the last axis: zero-stuff to 2n - 1 samples
    (no trailing zero, as `lhs_dilation=2` dilates), then the 'valid'
    correlation with 2 h, out length 2n - 1 - taps + 1 (the same
    (taps-1)/2 output-rate group delay). `n_out` crops the valid
    length."""
    n = x.shape[-1]
    u = x.new_zeros(x.shape[:-1] + (2 * n - 1,))
    u[..., ::2] = x
    y = _conv(u, _fir(2.0 * halfband_fir(taps), x.dtype, x.device))
    if n_out is not None:
        y = y[..., :n_out]
    return y
