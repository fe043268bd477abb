# -*- coding: utf-8 -*-
"""Generalized Morse Wavelets (GMW), zeroth order.

Counterpart of `ssqueezepy_tpu/models/gmw.py`. Each factory returns a
pure function ``fn(w, xp)`` of radian frequency: ``xp=np`` evaluates on
the host in float64 (scale searches, admissibility integrals — the same
arithmetic as the JAX package, so the plans agree), ``xp=torch``
evaluates a tensor in its own dtype and on its own device (the plain
filterbank synthesis). Both branches work in log space, which keeps the
L2 ('energy') normalization finite in float32.

The CUDA kernel `csrc/cwt_bins.cu` synthesizes the same closed forms
in-kernel from `fn.kernel_params`; order > 0 waits for ROADMAP item A2b.
"""
import numpy as np
import torch
from scipy.special import gammaln as gammaln_fn

from ..utils.common import pi
from ..configs import gdefaults

__all__ = ['gmw', 'gmw_l1', 'gmw_l2', 'morsefreq']


def _check_args(gamma=None, beta=None, norm=None, order=None,
                allow_zerobeta=True):
    """GMW parameter validation (ssqueezepy's rejection set)."""
    if gamma is not None and gamma <= 0:
        raise ValueError("GMW `gamma` must exceed 0; got %r" % gamma)
    if beta is not None and beta < 0:
        raise ValueError("GMW `beta` cannot be negative; got %r" % beta)
    if beta == 0 and not allow_zerobeta:
        raise ValueError("`beta` of zero is only supported by "
                         "`morsewave` (the analytic lowpass case); "
                         "got %r here" % beta)
    if norm is not None and norm not in ('bandpass', 'energy'):
        raise ValueError("GMW `norm` is 'bandpass' or 'energy'; got %r"
                         % norm)
    if order is not None:
        if not isinstance(order, (int, float)) or \
                float(order) != int(order):
            raise TypeError("GMW `order` must be an integer; got %r"
                            % (order,))
        if order < 0:
            raise ValueError("GMW `order` cannot be negative; got %r"
                             % order)


def gmw(gamma=None, beta=None, norm=None, order=None, centered_scale=None):
    """Generalized Morse Wavelet factory; returns ``fn(w, xp=torch)``.
    L1 ('bandpass', frequency-domain peak value 2) and L2 ('energy')
    normalizations at order 0."""
    kw = gdefaults('gmw', gamma=gamma, beta=beta, norm=norm, order=order,
                   centered_scale=centered_scale)
    gamma, beta = float(kw['gamma']), float(kw['beta'])
    norm, k = kw['norm'], int(kw['order'])
    centered_scale = bool(kw['centered_scale'])
    _check_args(gamma=gamma, beta=beta, norm=norm, order=k,
                allow_zerobeta=False)
    if k != 0:
        raise NotImplementedError(
            "GMW order > 0 is not ported yet (ROADMAP.md queue A, A2b)")

    fn = (gmw_l1(gamma, beta, centered_scale) if norm == 'bandpass' else
          gmw_l2(gamma, beta, centered_scale))
    fn.config = dict(gamma=gamma, beta=beta, norm=norm, order=k,
                     centered_scale=centered_scale)
    fn.qualname = 'gmw_l1' if norm == 'bandpass' else 'gmw_l2'
    return fn


def _make_fn(logconst, amp, gamma, beta, wc, centered_scale):
    """``amp * exp(logconst + beta ln w - w^gamma)`` for w > 0, else 0."""
    def fn(w, xp=torch):
        if xp is np:
            w = np.asarray(w)
            if centered_scale:
                w = w * np.asarray(np.asarray(wc, w.dtype))
            w_nonneg = (w >= 0)
            w = w * w_nonneg
            logw = np.log(np.where(w > 0, w, 1))
            out = amp * np.exp(np.asarray(np.asarray(logconst, w.dtype))
                               + beta * logw - w ** gamma)
            return np.where(w > 0, out, 0).astype(w.dtype)
        if centered_scale:
            w = w * wc
        w = w * (w >= 0)
        pos = w > 0
        logw = torch.log(torch.where(pos, w, torch.ones_like(w)))
        out = amp * torch.exp(logconst + beta * logw - w ** gamma)
        return torch.where(pos, out, torch.zeros_like(out))

    fn.kernel_params = dict(logconst=float(logconst), amp=float(amp),
                            gamma=float(gamma), beta=float(beta),
                            wc=float(wc) if centered_scale else 1.0)
    return fn


def gmw_l1(gamma=3., beta=60., centered_scale=False):
    """L1(bandpass)-normalized GMW:
    ``psih(w) = 2 exp(-beta ln wc + wc^gamma + beta ln w - w^gamma)``."""
    _check_args(gamma=gamma, beta=beta, allow_zerobeta=False)
    wc = morsefreq(gamma, beta)
    wcl = float(np.log(wc))
    const = float(-beta * wcl + wc ** gamma)
    return _make_fn(const, 2., gamma, beta, wc, centered_scale)


def gmw_l2(gamma=3., beta=60., centered_scale=False):
    """L2(energy)-normalized GMW:
    ``psih(w) = sqrt(2 pi gamma 2^r / Gamma(r)) w^beta exp(-w^gamma)``,
    r = (2 beta + 1)/gamma."""
    _check_args(gamma=gamma, beta=beta, allow_zerobeta=False)
    wc = morsefreq(gamma, beta)
    r = (2 * beta + 1) / gamma
    logconst = float(0.5 * (np.log(2 * pi * gamma) + r * np.log(2)
                            - gammaln_fn(r)))
    return _make_fn(logconst, 1., gamma, beta, wc, centered_scale)


def morsefreq(gamma, beta):
    """GMW peak frequency (radian)."""
    return (beta / gamma) ** (1 / gamma)
