# -*- coding: utf-8 -*-
"""FFTs over `torch.fft`, for the transforms that lie outside any
kernel: the forward FFT of the padded signal, and the plain versions of
the kernels. Counterpart of the dispatching API of
`ssqueezepy_tpu/ops/fft.py` (its matmul engine existed for the TPU and
is not ported). `out_range` slices the output along `axis`.
"""
import torch

__all__ = ['fft', 'ifft', 'rfft']


def _slice_axis(z, axis, out_range):
    if out_range is None:
        return z
    return z.narrow(axis, out_range[0], out_range[1] - out_range[0])


def fft(z, axis=-1, n=None, out_range=None):
    return _slice_axis(torch.fft.fft(z, n=n, dim=axis), axis, out_range)


def ifft(z, axis=-1, n=None, out_range=None):
    return _slice_axis(torch.fft.ifft(z, n=n, dim=axis), axis, out_range)


def rfft(x, axis=-1):
    """Real-input FFT -> first n//2+1 bins (numpy `rfft` convention)."""
    return torch.fft.rfft(x, dim=axis)
