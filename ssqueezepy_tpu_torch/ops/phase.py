# -*- coding: utf-8 -*-
"""Phase transforms (instantaneous-frequency estimates).

    w_cwt[a, b]  = |Im(dWx / Wx)| / 2pi           (inf where |Wx|^2 < gamma^2)
    w_stft[k, u] = |Sfs[k] - Im(dSx / Sx) / 2pi|  (inf where |Sx|^2 < gamma^2)

Counterpart of `phase_transform_w` and `phase_stft` in
`ssqueezepy_tpu/ops/phase.py`, over native complex tensors; and of
`cdiv2` (`ssqueezepy_tpu/ops/complexlib.py`), the regularized complex
divide of the second-order estimates.
"""
import torch

from ..utils.common import EPS32, EPS64

__all__ = ['phase_transform_w', 'phase_stft', 'cmul', 'cdiv', 'div_tiny']

_TWO_PI = 6.283185307179586


def div_tiny(dtype):
    """The additive regularizer of `cdiv` for a real or complex torch
    `dtype`: 1e3 x its smallest normal (as `ssqueezepy_tpu/models/
    ssq_cwt2.py`)."""
    return torch.finfo(dtype).tiny * 1e3


def cmul(a, b):
    """a * b over complex tensors, on their real and imaginary parts
    (the JAX package's split-complex product, term by term)."""
    ar, ai, br, bi = a.real, a.imag, b.real, b.imag
    return torch.complex(ar * br - ai * bi, ar * bi + ai * br)


def cdiv(a, b, tiny):
    """a / b with the denominator |b|^2 + tiny."""
    ar, ai, br, bi = a.real, a.imag, b.real, b.imag
    d = br * br + bi * bi + tiny
    return torch.complex((ar * br + ai * bi) / d, (ai * br - ar * bi) / d)


def _imag_ratio_over_2pi(Wx, dWx):
    """Im(dWx / Wx) / 2pi without complex division:
    (B*C - A*D) / ((C^2 + D^2) * 2pi), A+iB = dWx, C+iD = Wx."""
    A, B = dWx.real, dWx.imag
    C, D = Wx.real, Wx.imag
    return (B * C - A * D) / ((C * C + D * D) * _TWO_PI)


def phase_transform_w(Wx, dWx, gamma, Sfs=None):
    """Phase transform with gamma gating (-> inf). `Sfs` (n_rows,), when
    given, is the per-row STFT frequency the estimate is offset from."""
    w = _imag_ratio_over_2pi(Wx, dWx)
    if Sfs is None:
        w = torch.abs(w)
    else:
        shape = [1] * w.dim()
        shape[-2] = -1
        w = torch.abs(Sfs.to(w.dtype).reshape(shape) - w)
    C, D = Wx.real, Wx.imag
    small = (C * C + D * D) < torch.tensor(gamma, dtype=w.dtype) ** 2
    return torch.where(small, torch.full_like(w, float('inf')), w)


def phase_stft(Sx, dSx, Sfs, gamma=None):
    """STFT phase transform; `gamma` defaults to 10 * machine epsilon."""
    if gamma is None:
        gamma = 10 * (EPS64 if Sx.dtype == torch.complex128 else EPS32)
    return phase_transform_w(Sx, dSx, gamma, Sfs=torch.as_tensor(
        Sfs, device=Sx.device))
