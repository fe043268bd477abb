# -*- coding: utf-8 -*-
"""Experimental: scale <-> frequency converters and the generic phase
synchrosqueezing of a precomputed transform.

Counterpart of `ssqueezepy_tpu/experimental.py`. The converters are host
numpy on the port's `cwt_scalebounds`, `center_frequency` and
`Wavelet.filterbank_np`. `phase_transform` and `phase_ssqueeze` take a
CWT or STFT (numpy or a tensor, moved to `device`) and run on the port's
phase transforms (`ops/phase.py`: `phase_cwt`, `phase_cwt_num`,
`phase_stft`; `ops/diff.py::trigdiff` for a missing CWT derivative) and
its `ssqueeze` (on the card the fused phase + bins + scatter kernel B4
from (Wx, dWx), the generic scatter B5 from an explicit w).
"""
import warnings

import numpy as np
import torch

from .models.ssqueezing import ssqueeze
from .models.wavelets import Wavelet, center_frequency
from .ops.diff import trigdiff
from .ops.phase import phase_cwt, phase_cwt_num, phase_stft
from .utils.common import EPS32, EPS64, p2up, resolve_device, to_device
from .utils.cwt_utils import cwt_scalebounds

__all__ = ['freq_to_scale', 'scale_to_freq', 'phase_ssqueeze',
           'phase_transform']


def _cf_curve(wavelet, search_scales, N, kind):
    """Center frequency (radians, clipped to [0, pi]) at each scale."""
    cfs = np.array([center_frequency(wavelet, float(s), N, kind=kind)
                    for s in search_scales])
    return np.clip(cfs, 0., np.pi)


def freq_to_scale(freqs, wavelet, N, fs=1, n_search_scales=None, kind='peak',
                  base=2):
    """Frequencies (cycles, <= fs/2, ascending endpoints) -> a log-spaced
    scale grid whose wavelet center frequencies span the requested range.
    Approximate: endpoints are matched on a dense search curve, interior
    points follow the log spacing."""
    fr = np.asarray(freqs, np.float64) / fs
    if fr.min() < 0:
        raise AssertionError("frequencies must be positive")
    if fr.max() > 0.5:
        raise AssertionError("max frequency cannot exceed fs/2")
    if not (fr[-1] == fr.max() and fr[0] == fr.min()):
        raise AssertionError("`freqs` must be ordered: first sample = min, "
                             "last sample = max")

    M = len(fr)
    n_search = n_search_scales or 10 * M
    lo, hi = cwt_scalebounds(wavelet, N, preset='maximal',
                             use_padded_N=False)
    logb = lambda v: np.log(v) / np.log(base)
    grid = np.logspace(logb(lo), logb(hi), n_search, base=base)

    f_of_s = _cf_curve(wavelet, grid, N, kind) / (2 * np.pi)
    # scales at which the curve comes closest to the requested endpoints;
    # frequency decreases with scale, so fmax -> smallest scale
    s_at_fmax = grid[np.abs(f_of_s - fr.max()).argmin()]
    s_at_fmin = grid[np.abs(f_of_s - fr.min()).argmin()]
    return np.logspace(logb(s_at_fmin), logb(s_at_fmax), M, base=base)


def scale_to_freq(scales, wavelet, N, fs=1, padtype='reflect'):
    """Scales -> frequencies (cycles) via the freq-domain filterbank's
    peak bins on the padded grid."""
    scales = np.atleast_1d(np.asarray(scales, np.float64)).squeeze()
    if scales.ndim == 0:
        scales = scales[None]
    wavelet = Wavelet._init_if_not_isinstance(wavelet)

    Np = p2up(N)[0] if padtype is not None else N
    psih = wavelet.filterbank_np(scales, N=Np, nohalf=True)
    peak = np.argmax(psih, axis=-1)

    # ill-behaved rows peak at dc or in the negative-frequency half;
    # snap them to the nearest valid bin (1 for the large-scale tail,
    # Nyquist for the small-scale head)
    bad = (peak == 0) | (peak > Np // 2)
    if bad.any():
        warnings.warn("found potentially ill-behaved wavelets (peak "
                      "indices at negative freqs or at dc); snapping to "
                      "bin 1 / Nyquist")
        tail = np.arange(len(peak)) > len(peak) // 2
        peak = np.where(bad, np.where(tail, 1, Np // 2), peak)

    f = peak / Np
    assert f.min() >= 0 and f.max() <= 0.5, (f.min(), f.max())
    return f * fs


def _phase_cwt_leg(Wx, dWx, difftype, difforder, gamma, fs, rpadded,
                   padtype, N, n1, get_w):
    """CWT leg of the unified phase transform: derive `dWx` spectrally if
    absent; optionally materialize the explicit phase plane `w`."""
    if N is None and not rpadded:
        N = Wx.shape[-1]
    if n1 is None:
        n1 = p2up(N)[1]
    if dWx is None:
        dWx = trigdiff(Wx, fs, padtype, rpadded, N=N, n1=n1,
                       transform='cwt')
    if not get_w:
        return None, Wx, dWx
    if difftype == 'trig':
        return phase_cwt(Wx, dWx, 'trig', gamma), Wx, dWx
    if difftype == 'phase':
        return phase_cwt(Wx, None, 'phase', gamma), Wx, dWx
    Wx = Wx[..., n1 - 4:n1 + N + 4]
    return phase_cwt_num(Wx, 1 / fs, difforder, gamma), Wx, dWx


def phase_transform(Wx, dWx=None, difftype='trig', difforder=4, gamma=None,
                    fs=1., Sfs=None, rpadded=False, padtype='reflect',
                    N=None, n1=None, get_w=False, transform='cwt',
                    device='cuda'):
    """Unified CWT & STFT SSQ phase transform on precomputed transforms
    (`Wx`, `dWx` complex, numpy or tensors, moved to `device`). Returns
    (w or None, Wx, dWx, Sfs, gamma)."""
    if transform == 'stft' and dWx is None:
        raise NotImplementedError("STFT `phase_transform` needs `dWx`.")
    if rpadded and N is None:
        raise ValueError("`rpadded=True` requires `N`")
    device = resolve_device(device)
    Wx = to_device(Wx, device)
    if dWx is not None:
        dWx = to_device(dWx, device)
    if Wx.dim() > 2 and get_w:
        raise NotImplementedError("`get_w=True` unsupported with batched "
                                  "input.")
    double = Wx.dtype in (torch.complex128, torch.float64)
    if gamma is None:
        gamma = 10 * (EPS64 if double else EPS32)

    if transform == 'cwt':
        w, Wx, dWx = _phase_cwt_leg(Wx, dWx, difftype, difforder, gamma,
                                    fs, rpadded, padtype, N, n1, get_w)
        Sfs = None
    else:
        if Sfs is None:
            Sfs = np.linspace(0, .5 * fs, Wx.shape[-2],
                              dtype=np.float64 if double else np.float32)
        w = phase_stft(Wx, dWx, Sfs, gamma) if get_w else None

    return w, Wx, dWx, Sfs, gamma


def phase_ssqueeze(Wx, dWx=None, ssq_freqs=None, scales=None, Sfs=None,
                   fs=1., t=None, squeezing='sum', maprange=None,
                   wavelet=None, gamma=None, was_padded=True, flipud=False,
                   rpadded=False, padtype=None, N=None, n1=None,
                   difftype=None, difforder=None, get_w=False,
                   get_dWx=False, transform='cwt', device='cuda'):
    """Run the phase transform then `ssqueeze` on an arbitrary CWT/STFT-
    like `Wx` (the generic entry point for user-supplied transforms).
    Returns (Tx, Wx, ssq_freqs, scales, Sfs, w, dWx): Tx, Wx, w and dWx
    tensors on `device`, w and dWx None where not asked for."""
    w, Wx, dWx, Sfs, gamma = phase_transform(
        Wx, dWx, difftype or 'trig', difforder=difforder, gamma=gamma,
        rpadded=rpadded, padtype=padtype, N=N, n1=n1, get_w=get_w, fs=fs,
        transform=transform, device=device)

    if w is not None and not get_dWx:
        dWx = None
    maprange = maprange or ('peak' if transform == 'cwt' else 'maximal')

    Tx, ssq_freqs = ssqueeze(Wx, w, ssq_freqs, scales, Sfs, fs=fs, t=t,
                             squeezing=squeezing, maprange=maprange,
                             wavelet=wavelet, gamma=gamma,
                             was_padded=was_padded, flipud=flipud, dWx=dWx,
                             transform=transform, device=device)
    return Tx, Wx, ssq_freqs, scales, Sfs, w, dWx
