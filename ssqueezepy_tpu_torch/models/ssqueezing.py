# -*- coding: utf-8 -*-
"""Synchrosqueezing: the standalone `ssqueeze` and the plan pieces (the
associated frequency grid, argument checks, the natural bins).

Counterpart of `ssqueeze`, `_compute_associated_frequencies`,
`_check_ssqueezing_args` and `_natural_bins` in
`ssqueezepy_tpu/models/ssqueezing.py` (the plan pieces are host numpy,
once per plan). `ssqueeze` reassigns from (Wx, dWx) with 'sum'
squeezing through the fused phase + bins + scatter kernel
(`ops/ssq_kernels.py::ssqueeze_fast`); from a precomputed `w`, or with
'lebesgue', 'abs' or a callable squeezing, it takes the phase transform
of the raw Wx and scatters the squeezed values through the generic
scatter (`ops/ssq_kernels.py::indexed_sum_onfly`).
"""
from types import FunctionType

import numpy as np
import torch

from ..ops.phase import phase_transform_w
from ..ops.ssq_cuda import scatter_rule
from ..ops.ssq_kernels import indexed_sum_onfly, ssqueeze_fast
from ..utils.common import (NOTE, WARN, pi, p2up, assert_is_one_of,
                            resolve_device, to_device)
from ..utils.cwt_utils import (logscale_transition_idx, process_scales,
                               infer_scaletype, _process_fs_and_t)

__all__ = ['ssqueeze', '_apply_squeezing', '_compute_associated_frequencies',
           '_check_ssqueezing_args', '_natural_bins']


def ssqueeze(Wx, w=None, ssq_freqs=None, scales=None, Sfs=None, fs=None,
             t=None, squeezing='sum', maprange='maximal', wavelet=None,
             gamma=None, was_padded=True, flipud=False, dWx=None,
             transform='cwt', device='cuda'):
    """Synchrosqueeze a CWT or STFT from its derivative or from a phase
    transform.

    `Wx`, `dWx` complex (na, N) or (B, na, N), `w` real of Wx's shape
    (inf marks a dropped cell), tensors or numpy, moved to `device`;
    without `w`, `gamma` gates |Wx| <= gamma. `squeezing` is 'sum',
    'lebesgue', 'abs' or a function of Wx. For `transform='cwt'` the
    squeeze constant comes from `scales`; for 'stft' from the (linear)
    `ssq_freqs`, and `Sfs` (na,) offsets the phase transform. Returns
    (Tx, ssq_freqs): Tx (nbins, N) or (B, nbins, N), numpy if `Wx` was
    numpy, else a tensor on `device`; ssq_freqs reversed for the CWT or
    with `flipud`."""
    device = resolve_device(device)
    was_numpy = not isinstance(Wx, torch.Tensor)
    if w is None and (dWx is None or gamma is None):
        raise ValueError("if `w` is None, `dWx` and `gamma` must not be.")
    if w is not None and (bool(w.min() < 0) if isinstance(w, torch.Tensor)
                          else np.asarray(w).min() < 0):
        raise ValueError("found negatives in `w`")
    _check_ssqueezing_args(squeezing, maprange, transform=transform,
                           wavelet=wavelet)
    if scales is None and transform == 'cwt':
        raise ValueError("`scales` can't be None if `transform == 'cwt'`")

    Wx = to_device(Wx, device)
    if dWx is not None:
        dWx = to_device(dWx, device)
    N = Wx.shape[-1]
    dt, *_ = _process_fs_and_t(fs, t, N)

    if transform == 'cwt':
        scales, cwt_scaletype, _, nv = process_scales(scales, N,
                                                      get_params=True)
    else:
        cwt_scaletype, nv = None, None

    if not isinstance(ssq_freqs, np.ndarray):
        ssq_scaletype = (ssq_freqs if isinstance(ssq_freqs, str)
                         else cwt_scaletype)
        if ((maprange == 'maximal' or isinstance(maprange, tuple)) and
                ssq_scaletype == 'log-piecewise'):
            raise ValueError("can't have `ssq_scaletype = log-piecewise` or "
                             "tuple with `maprange = 'maximal'` "
                             "(got %s)" % str(maprange))
        ssq_freqs = _compute_associated_frequencies(
            scales, N, wavelet, ssq_scaletype, maprange, was_padded, dt,
            transform)
    elif transform == 'stft':
        ssq_scaletype = 'linear'
    else:
        ssq_scaletype, _ = infer_scaletype(ssq_freqs)

    # squeeze constant: log(2)/nv (a per-row array for log-piecewise) or
    # the linear scale step over each scale; the STFT's grid step
    if transform == 'cwt':
        if cwt_scaletype.startswith('log'):
            const = np.log(2) / nv
        else:
            const = ((scales[1] - scales[0]) / scales).squeeze()
    else:
        const = float(ssq_freqs[1] - ssq_freqs[0])

    logscale = bool(ssq_scaletype.startswith('log'))
    Sfs = Sfs if transform == 'stft' else None
    scatter_rule(len(ssq_freqs), 2 * Wx.real.element_size())
    if w is None and squeezing == 'sum':
        Tx = ssqueeze_fast(Wx, dWx, ssq_freqs, const, logscale, flipud,
                           gamma, Sfs=Sfs, device=device)
    else:
        # the phase transform sees the raw Wx (a squeezed plane carries
        # no usable phase); only the scattered values are squeezed
        if w is None:
            if Sfs is not None:
                Sfs = torch.as_tensor(Sfs).to(dtype=Wx.real.dtype,
                                              device=device)
            w = phase_transform_w(Wx, dWx, gamma, Sfs=Sfs)
        Tx = indexed_sum_onfly(_apply_squeezing(Wx, squeezing), w,
                               ssq_freqs, const, logscale, flipud,
                               device=device)

    # `scales` go high -> low
    if (transform == 'cwt' and not flipud) or flipud:
        ssq_freqs = ssq_freqs[::-1].copy()
    if was_numpy:
        Tx = Tx.cpu().numpy()
    return Tx, ssq_freqs


def _apply_squeezing(Wx, squeezing):
    """The values the scatter sums: Wx for 'sum', 1/na everywhere for
    'lebesgue', |Wx| for 'abs', `squeezing(Wx)` for a function (each as a
    complex tensor of Wx's type)."""
    if squeezing == 'sum':
        return Wx
    if squeezing == 'lebesgue':
        return torch.full_like(Wx, 1. / Wx.shape[-2])
    if squeezing == 'abs':
        return Wx.abs().to(Wx.dtype)
    return torch.as_tensor(squeezing(Wx), device=Wx.device).to(Wx.dtype)


def _compute_associated_frequencies(scales, N, wavelet, ssq_scaletype,
                                    maprange, was_padded=True, dt=1,
                                    transform='cwt'):
    """Frequency grid the reassigned energy lands on — one entry per
    scale row, spaced per `ssq_scaletype`, endpoints per `maprange`.

    'log' rides a single exponential ramp between the endpoints;
    'log-piecewise' joins two ramps at the scale-downsampling transition
    (the knee frequency is the wavelet's center frequency at the
    transition scale); 'linear' is an even grid.
    """
    lo, hi = _freq_endpoints(maprange, dt, N, wavelet, scales, was_padded)
    na = len(scales)
    pos = np.arange(na) / (na - 1)        # output-grid coordinate in [0,1]

    if ssq_scaletype == 'log-piecewise':
        cut = logscale_transition_idx(scales)
        if cut is not None:
            knee = _center_freq_hz(wavelet, N, maprange, dt, scales[cut],
                                   was_padded)
            j = na - cut - 1              # knee position in the grid
            seg_lo = lo * (knee / lo) ** (pos[:j] / pos[j])
            seg_hi = knee * (hi / knee) ** ((pos[j:] - pos[j])
                                            / (1 - pos[j]))
            grid = np.hstack([seg_lo, seg_hi])
            found = logscale_transition_idx(grid.reshape(-1, 1))
            if found is None or (na - found) != cut:
                raise AssertionError(
                    "piecewise ssq grid knee landed at %s, expected %s "
                    "(scale transition %d)" % (found, na - cut, cut))
            return grid
        ssq_scaletype = 'log'             # no transition -> plain ramp

    if ssq_scaletype.startswith('log'):
        return lo * (hi / lo) ** pos
    if transform == 'cwt':
        return np.linspace(lo, hi, na)
    return np.linspace(0, .5, na) / dt


def _freq_endpoints(maprange, dt, N, wavelet, scales, was_padded):
    """(lowest, highest) grid frequency in cycles per unit time."""
    if isinstance(maprange, (tuple, list)):
        return maprange[0], maprange[1]
    if maprange == 'maximal':
        return 1 / (N * dt), 1 / (2 * dt)
    return (_center_freq_hz(wavelet, N, maprange, dt, scales[-1],
                            was_padded),
            _center_freq_hz(wavelet, N, maprange, dt, scales[0],
                            was_padded))


def _center_freq_hz(wavelet, N, kind, dt, scale, was_padded):
    """Wavelet center frequency at `scale`, rad/sample -> Hz, measured at
    the padded length when the transform ran padded."""
    from .wavelets import center_frequency
    n_eff = p2up(N)[0] if was_padded else N
    w_peak = center_frequency(wavelet, N=n_eff,
                              scale=float(np.asarray(scale).squeeze()),
                              kind=kind,
                              **(dict(force_int=True) if kind == 'energy'
                                 else {}))
    return w_peak / (2 * pi) / dt


def _check_ssqueezing_args(squeezing, maprange=None, wavelet=None,
                           difftype=None, difforder=None, get_w=None,
                           transform='cwt'):
    """Validation of the synchrosqueezing options; returns difforder."""
    if transform not in ('cwt', 'stft'):
        raise ValueError("`transform` must be one of: cwt, stft "
                         "(got %s)" % transform)
    if not isinstance(squeezing, (str, FunctionType)):
        raise TypeError("`squeezing` must be string or function "
                        "(got %s)" % type(squeezing))
    elif isinstance(squeezing, str):
        assert_is_one_of(squeezing, 'squeezing', ('sum', 'lebesgue', 'abs'))

    if maprange is not None:
        if isinstance(maprange, (tuple, list)):
            if not all(isinstance(m, (float, int)) for m in maprange):
                raise ValueError("all elements of `maprange` must be "
                                 "float or int")
        elif isinstance(maprange, str):
            assert_is_one_of(maprange, 'maprange',
                             ('maximal', 'peak', 'energy'))
        else:
            raise TypeError("`maprange` must be str, tuple, or list "
                            "(got %s)" % type(maprange))
        if isinstance(maprange, str) and maprange != 'maximal':
            if transform != 'cwt':
                NOTE("string `maprange` currently only functional with "
                     "`transform='cwt'`")
            elif wavelet is None:
                raise ValueError(f"maprange='{maprange}' requires `wavelet`")

    if difftype is not None:
        if difftype not in ('trig', 'phase', 'numeric'):
            raise ValueError("`difftype` must be one of: trig, phase, "
                             "numeric (got %s)" % difftype)
        elif difftype != 'trig' and not get_w:
            raise ValueError("`difftype != 'trig'` requires `get_w = True`")

    if difforder is not None:
        if difftype != 'numeric':
            WARN("`difforder` is ignored if `difftype != 'numeric'")
        elif difforder not in (1, 2, 4):
            raise ValueError("`difforder` must be one of: 1, 2, 4 "
                             "(got %s)" % difforder)
    elif difftype == 'numeric':
        difforder = 4
    return difforder


def _natural_bins(transform, scales, ssq_freqs, params, flipud, na, dt):
    """Per-row expected bin: the bin each scale's associated frequency
    falls in (identity for the library's own CWT grids with flipud)."""
    try:
        v = np.asarray(ssq_freqs).squeeze()
        nbins = params['omax'] + 1
        if transform == 'cwt' and scales is not None and len(v) == na:
            # scales high->low map to bins low->high: natural ~ reversed
            base = np.arange(na - 1, -1, -1)
        else:
            base = np.arange(na)
        base = np.clip(base, 0, nbins - 1)
        if flipud:
            base = (nbins - 1) - base
        return base.astype(np.int32)
    except Exception:
        return None
