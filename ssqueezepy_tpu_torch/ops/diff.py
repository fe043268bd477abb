# -*- coding: utf-8 -*-
"""Frequency-domain (trigonometric) differentiation.

Counterpart of `ssqueezepy_tpu/ops/diff.py`: ifft(fft(A) * 1j * xi * fs)
along the last axis, by `torch.fft` on A's device.
"""
import numpy as np
import torch

from .pad import padsignal, pad_params
from ..utils.common import p2up
from ..models.wavelets import _xifn

__all__ = ['trigdiff']


def trigdiff(A, fs=1., padtype=None, rpadded=None, N=None, n1=None,
             window=None, transform='cwt'):
    """Differentiate the rows of `A` (2-D or 3-D, complex; a tensor or a
    numpy array, which comes back as numpy) in the frequency domain;
    `A` is padded by `padtype` ('reflect' unless `rpadded`) first, and
    the result unpadded to length `N` from `n1` (by default the left pad
    of `p2up(N)`)."""
    if transform == 'stft':
        raise NotImplementedError("`transform='stft'` is currently not "
                                  "supported.")
    was_numpy = not isinstance(A, torch.Tensor)
    A = torch.as_tensor(np.asarray(A) if was_numpy else A)
    if not A.is_complex():
        A = A.to(torch.complex128 if A.dtype == torch.float64
                 else torch.complex64)
    if rpadded and N is None:
        raise ValueError("must pass `N` if `rpadded`")
    rpadded = rpadded or False
    padtype = padtype or ('reflect' if not rpadded else None)

    if padtype is not None:
        _, n1, _ = pad_params(A.shape[-1], padtype)
        A = torch.complex(padsignal(A.real.contiguous(), padtype),
                          padsignal(A.imag.contiguous(), padtype))

    rdt = A.real.dtype
    xi = torch.as_tensor(_xifn(1., A.shape[-1], np.float64),
                         device=A.device).to(rdt) * torch.as_tensor(
                             fs, dtype=rdt, device=A.device)
    Ah = torch.fft.fft(A, dim=-1)
    dAh = torch.complex(-Ah.imag * xi, Ah.real * xi)   # * 1j * xi * fs
    A_diff = torch.fft.ifft(dAh, dim=-1)

    if rpadded or padtype is not None:
        if N is None:
            N = A.shape[-1]
        if n1 is None:
            _, n1, _ = p2up(N)
        A_diff = A_diff[..., n1:n1 + N]
    return A_diff.cpu().numpy() if was_numpy else A_diff
