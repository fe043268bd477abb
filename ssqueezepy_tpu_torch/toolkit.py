# -*- coding: utf-8 -*-
"""Small analysis helpers: the reconstruction metric, stepped-frequency
test tones, the indices of a maximum and a linear band picker that draws
the band (`lin_band`, through `visuals`). Counterpart of
`ssqueezepy_tpu/toolkit.py`. Host numpy; a tensor argument is brought to
the host."""
import numpy as np
import torch

__all__ = ['lin_band', 'cos_f', 'sin_f', 'mad_rms', 'where_amax']


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def mad_rms(x, xrec):
    """Mean absolute deviation of the reconstruction, normalized by the
    signal's RMS — the library-wide round-trip accuracy criterion."""
    x = _host(x)
    err = np.mean(np.abs(_host(xrec) - x))
    rms = np.sqrt(np.mean(np.square(x)))
    return err / rms


def _stepped_tone(trig, freqs, N, phi, endpoint):
    """One `trig` oscillation per frequency, each spanning a unit-time
    segment of `N` samples; segments are laid end to end so the i-th
    rides the time interval [i, i+1)."""
    freqs = np.atleast_1d(np.asarray(freqs, np.float64))
    M = len(freqs)
    tau = np.linspace(0., 1., N, endpoint=endpoint)          # (N,)
    seg_t = tau[None, :] + np.arange(M)[:, None]             # (M, N)
    phases = 2 * np.pi * freqs[:, None] * (seg_t + phi)
    return trig(phases).ravel()


def cos_f(freqs, N=128, phi=0, endpoint=False):
    """Concatenated unit-time cosine segments, one per frequency."""
    return _stepped_tone(np.cos, freqs, N, phi, endpoint)


def sin_f(freqs, N=128, phi=0, endpoint=False):
    """Concatenated unit-time sine segments, one per frequency."""
    return _stepped_tone(np.sin, freqs, N, phi, endpoint)


def where_amax(x):
    """Indices (per axis) of every element attaining max |x|."""
    mag = np.abs(_host(x))
    return np.nonzero(mag == mag.max())


def _linear_band_geometry(shape, slope, offset, bw):
    """Row-index curve `cc` and half-width `cw` of a linear band through
    an (na, N) time-frequency plane: row = slope * (t + offset) * na
    with t in [0, 1], constant half-width bw * na (`issq_cwt(Tx, cc=...,
    cw=...)` inverts the band)."""
    na, N = shape
    t = np.linspace(0., 1., N)
    cc = (slope * na * (t + offset)).astype(np.int32)
    cw = np.full(N, int(bw * na), np.int32)
    return cc, cw


def lin_band(Tx, slope, offset, bw=.025, **kw):
    """Plot |Tx| with a linear band overlaid and return the band's
    (curve centers, half-widths) for masked component inversion
    (`issq_cwt(Tx, cc=..., cw=...)`). `Tx` numpy or a tensor on any
    device."""
    from . import visuals
    Tx = _host(Tx)
    cc, cw = _linear_band_geometry(Tx.shape, slope, offset, bw)

    visuals.imshow(Tx, abs=1, aspect='auto', show=0, **kw)
    visuals.plot(cc + cw, color='r')
    visuals.plot(cc - cw, color='r', show=1)
    return cc, cw
