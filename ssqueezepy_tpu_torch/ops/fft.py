# -*- coding: utf-8 -*-
"""FFTs over `torch.fft`, for the transforms that lie outside any
kernel: the forward FFT of the padded signal, the inverse STFT, and the
plain versions of the kernels. Counterpart of the dispatching API of
`ssqueezepy_tpu/ops/fft.py` (its matmul engine existed for the TPU and
is not ported). `out_range` slices the output along `axis`.
"""
import torch

__all__ = ['fft', 'ifft', 'rfft', 'irfft', 'fftshift', 'ifftshift',
           'next_fft_len']


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


def irfft(z, n=None, axis=-1):
    """Inverse of `rfft` (numpy `irfft` convention)."""
    return torch.fft.irfft(z, n=n, dim=axis)


def fftshift(x, axes=-1):
    return torch.fft.fftshift(x, dim=axes)


def ifftshift(x, axes=-1):
    return torch.fft.ifftshift(x, dim=axes)


def next_fft_len(n):
    """Smallest length >= n of the form 2^a * {1, 3, 5, 9, 15}: the
    transform length of the hop-1 STFT (copy of `_next_fft_len` in
    `ssqueezepy_tpu/ops/stft_conv.py`)."""
    best = 1 << (n - 1).bit_length()
    for mult in (3, 5, 9, 15):
        a = 1
        while mult * a < n:
            a <<= 1
        if mult * a >= n:
            best = min(best, mult * a)
    return best
