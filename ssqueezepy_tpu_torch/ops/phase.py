# -*- coding: utf-8 -*-
"""Phase transforms (instantaneous-frequency estimates).

    w_cwt[a, b]  = |Im(dWx / Wx)| / 2pi           (inf where |Wx|^2 < gamma^2)
    w_stft[k, u] = |Sfs[k] - Im(dSx / Sx) / 2pi|  (inf where |Sx|^2 < gamma^2)

Counterpart of `phase_transform_w`, `phase_cwt`, `phase_cwt_num` and
`phase_stft` in `ssqueezepy_tpu/ops/phase.py`, over native complex
tensors, on their device (the JAX package runs `phase_cwt_num` in numpy
on the host; here it is the same elementwise arithmetic as torch ops);
and of
`cdiv2` (`ssqueezepy_tpu/ops/complexlib.py`), the regularized complex
divide of the second-order estimates.
"""
import math

import torch

from ..utils.common import EPS32, EPS64

__all__ = ['phase_transform_w', 'phase_cwt', 'phase_cwt_num', 'phase_stft',
           'cmul', 'cdiv', 'div_tiny']

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


def _unwrap(p):
    """`np.unwrap` of phases `p` along the last axis (period 2pi)."""
    dd = torch.diff(p, dim=-1)
    ddmod = torch.remainder(dd + math.pi, 2 * math.pi) - math.pi
    ddmod = torch.where((ddmod == -math.pi) & (dd > 0),
                        torch.full_like(ddmod, math.pi), ddmod)
    corr = torch.where(dd.abs() < math.pi, torch.zeros_like(dd), ddmod - dd)
    return torch.cat([p[..., :1], p[..., 1:] + torch.cumsum(corr, dim=-1)],
                     dim=-1)


def phase_cwt(Wx, dWx, difftype='trig', gamma=None, parallel=None):
    """CWT phase transform. 'trig' from the derivative `dWx`
    (`phase_transform_w`); 'phase' from forward differences of the
    unwrapped angle of `Wx` along time, the last column the whole span
    u[..., -1] - u[..., 0], inf where |Wx| < gamma. `gamma` defaults to
    the square root of machine epsilon; `parallel` is ignored, as in the
    JAX package."""
    if gamma is None:
        gamma = math.sqrt(EPS64 if Wx.dtype == torch.complex128 else EPS32)
    if difftype == 'trig':
        return phase_transform_w(Wx, dWx, gamma)
    if difftype == 'phase':
        u = _unwrap(torch.angle(Wx))
        w = torch.cat([torch.diff(u, dim=-1), u[..., -1:] - u[..., :1]],
                      dim=-1).abs() / (2 * math.pi)
        return torch.where(Wx.abs() < gamma,
                           torch.full_like(w, float('inf')), w)
    raise ValueError(f"unsupported `difftype` '{difftype}'; must be one of "
                     "'trig', 'phase'.")


def phase_cwt_num(Wx, dt, difforder=4, gamma=None):
    """CWT phase transform by numeric differentiation along time: first
    (forward), second or fourth order finite differences, wrapping
    around the row's ends, w = |Im(dWx / Wx)| / 2pi with dWx the
    difference over `dt`, inf where |Wx| < gamma (default 10 * machine
    epsilon). `Wx` (na, n) is expected padded by 4 samples each side, as
    `ssq_cwt(difftype='numeric')` passes it."""
    if difforder not in (1, 2, 4):
        raise ValueError("`difforder` must be one of: 1, 2, 4 "
                         "(got %s)" % difforder)
    if difforder in (2, 4):
        Wxr = torch.cat([Wx[..., -2:], Wx, Wx[..., :2]], dim=-1)
    if difforder == 1:
        w = torch.cat([Wx[..., 1:] - Wx[..., :-1],
                       Wx[..., :1] - Wx[..., -1:]], dim=-1)
        w = w / dt
    elif difforder == 2:
        w = -Wxr[..., 4:] + 4 * Wxr[..., 3:-1] - 3 * Wxr[..., 2:-2]
        w = w / (2 * dt)
    else:
        w = -Wxr[..., 4:]
        w = w + Wxr[..., 3:-1] * 8
        w = w - Wxr[..., 1:-3] * 8
        w = w + Wxr[..., 0:-4]
        w = w / (12 * dt)
    # zero-magnitude cells divide to inf / nan here; the gate masks them
    w = (-1j * w / Wx).real / (2 * math.pi)
    if not gamma:
        gamma = 10 * (EPS64 if Wx.dtype == torch.complex128 else EPS32)
    w = torch.where(Wx.abs() < gamma, torch.full_like(w, float('inf')), w)
    return w.abs()


def phase_stft(Sx, dSx, Sfs, gamma=None, parallel=None):
    """STFT phase transform; `gamma` defaults to 10 * machine epsilon;
    `parallel` is ignored, as in the JAX package."""
    if gamma is None:
        gamma = 10 * (EPS64 if Sx.dtype == torch.complex128 else EPS32)
    return phase_transform_w(Sx, dSx, gamma, Sfs=torch.as_tensor(
        Sfs, device=Sx.device))
