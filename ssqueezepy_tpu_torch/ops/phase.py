# -*- coding: utf-8 -*-
"""CWT phase transform (instantaneous-frequency estimate).

    w[a, b] = |Im(dWx / Wx)| / 2pi      (inf where |Wx|^2 < gamma^2)

Counterpart of `phase_transform_w` in `ssqueezepy_tpu/ops/phase.py`,
over native complex tensors.
"""
import torch

__all__ = ['phase_transform_w']

_TWO_PI = 6.283185307179586


def _imag_ratio_over_2pi(Wx, dWx):
    """Im(dWx / Wx) / 2pi without complex division:
    (B*C - A*D) / ((C^2 + D^2) * 2pi), A+iB = dWx, C+iD = Wx."""
    A, B = dWx.real, dWx.imag
    C, D = Wx.real, Wx.imag
    return (B * C - A * D) / ((C * C + D * D) * _TWO_PI)


def phase_transform_w(Wx, dWx, gamma):
    """Phase transform with gamma gating (-> inf)."""
    w = torch.abs(_imag_ratio_over_2pi(Wx, dWx))
    C, D = Wx.real, Wx.imag
    small = (C * C + D * D) < torch.tensor(gamma, dtype=w.dtype) ** 2
    return torch.where(small, torch.full_like(w, float('inf')), w)
