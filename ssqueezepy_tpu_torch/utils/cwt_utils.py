# -*- coding: utf-8 -*-
"""Scale selection and parameter engine (host numpy, once per plan).

Counterpart of `ssqueezepy_tpu/utils/cwt_utils.py`. All of this is
data-independent bookkeeping; the numeric cutoffs and ladders are
ssqueezepy's behavior contract and are kept verbatim, so the port's plan
equals the JAX package's bit for bit. The redundancy scan of
`find_downsampling_scale` is the pure-Python one.
"""
import numpy as np
from scipy import integrate

from .common import WARN, pi, p2up, assert_is_one_of
from ..configs import get_config
from ..ops.search import find_maximum, find_first_occurrence, min_neglect_idx

__all__ = [
    'adm_ssq', 'cwt_scalebounds', 'process_scales', 'infer_scaletype',
    'make_scales', 'logscale_transition_idx', 'nv_from_scales',
    'find_min_scale', 'find_max_scale', 'find_downsampling_scale',
    'integrate_analytic', 'find_max_scale_alt', '_process_fs_and_t',
]


def _freq_fn(wavelet):
    """Numpy frequency-domain evaluator of a (possibly spec'd) wavelet."""
    from ..models.wavelets import Wavelet
    return Wavelet._init_if_not_isinstance(wavelet).evaluate_np


def _real_if_close(z, tol=1e-15):
    return z.real if abs(getattr(z, 'imag', 0)) < tol else z


def adm_ssq(wavelet):
    """Synchrosqueezing admissibility constant
    ``integral(conj(psih(w)) / w, w=0..inf)``."""
    psih = _freq_fn(wavelet)
    return _real_if_close(integrate_analytic(lambda w: np.conj(psih(w)) / w))


# Escalation ladder for the upper integration bound: (grid multiplier,
# upper limit) — ssqueezepy's convergence heuristic, a behavior spec.
_INT_LADDER = ((1, 1), (1, 20), (4, 80), (8, 160))


def integrate_analytic(int_fn, nowarn=False):
    """Trapezoid integral over (0, inf) of an analytic-wavelet-derived
    function (zero for w<0, unimodal, decaying). The [1e-15, 0.1) head is
    integrated on a log grid; the tail on successively longer/denser
    linear grids until the sampled mass demonstrably decays."""
    head_w = np.logspace(-15, -1, 1000)
    head = integrate.trapezoid(int_fn(head_w), head_w)

    tail_vals = tail_w = None
    for mult, upper in _INT_LADDER:
        n = 10000 * mult
        # ascending grid on [0.1, upper); built descending then flipped so
        # the endpoint exclusion lands at the *low* end
        w = np.linspace(upper, .1, n, endpoint=False)[::-1].copy()
        vals = int_fn(w)
        mag = np.abs(vals)
        apex = int(np.argmax(mag))
        stop = min_neglect_idx(mag[apex:], th=1e-15) + apex
        converged = (n - stop > 1000 * mult) and mag.sum() > 1e-5
        if converged:
            tail_vals, tail_w = vals[:stop], w[:stop]
            break

    if tail_vals is None:
        if abs(head) < 1e-5:
            raise Exception("Could not find converging or non-negligibly"
                            "-valued bounds of integration for `int_fn`")
        if not nowarn:
            WARN("Integrated only from 1e-15 to 0.1 in logspace")
        tail_vals, tail_w = vals[:stop], w[:stop]
    return integrate.trapezoid(tail_vals, tail_w) + head


# (min_cutoff, max_cutoff, cutoff) defaults — the well-behaved band
_CUTOFF_DEFAULTS = (.6, .8, -.5)


def cwt_scalebounds(wavelet, N, preset=None, min_cutoff=None, max_cutoff=None,
                    cutoff=None, bin_loc=None, bin_amp=None,
                    use_padded_N=True):
    """(min_scale, max_scale) over which `wavelet` is well-behaved.
    Presets 'maximal' / 'minimal' / 'naive'."""
    d_min, d_max, d_cut = _CUTOFF_DEFAULTS

    if preset is not None:
        if any(v is not None for v in (min_cutoff, max_cutoff, cutoff)):
            WARN("`preset` will override `min_cutoff, max_cutoff, cutoff`")
        elif preset == 'minimal' and (bin_amp is not None or
                                      bin_loc is not None):
            WARN("`preset='minimal'` ignores `bin_amp` & `bin_loc`")
        assert_is_one_of(preset, 'preset', ('maximal', 'minimal', 'naive'))
        if preset == 'minimal':
            min_cutoff, max_cutoff, cutoff = d_min, d_max, d_cut
        else:  # 'naive' / 'maximal'
            min_cutoff = max_cutoff = None
            if preset == 'maximal':
                cutoff = d_cut
    else:
        if min_cutoff is None:
            min_cutoff = d_min
        elif min_cutoff <= 0:
            raise ValueError("`min_cutoff` must be >0 (got %s)" % min_cutoff)
        if max_cutoff is None:
            max_cutoff = d_max
        elif max_cutoff < min_cutoff:
            raise ValueError("must have `max_cutoff > min_cutoff` "
                             "(got %s, %s)" % (max_cutoff, min_cutoff))

    if preset == 'naive':
        return 1, N

    if preset == 'maximal':
        bin_loc = bin_loc or 2
        bin_amp = bin_amp or 1
    if cutoff is None:
        cutoff = d_cut

    M = p2up(N)[0] if use_padded_N else N
    lo = find_min_scale(wavelet, cutoff=cutoff)
    hi = (find_max_scale(wavelet, M, bin_loc=bin_loc, bin_amp=bin_amp)
          if preset == 'maximal' else
          find_max_scale_alt(wavelet, M, min_cutoff=min_cutoff,
                             max_cutoff=max_cutoff))
    return lo, hi


def find_min_scale(wavelet, cutoff=1):
    """Smallest well-behaved scale: where the sampled spectrum first drops
    to `|cutoff| * peak` — searched right of the peak for cutoff>0, left
    of it otherwise."""
    psih = _freq_fn(wavelet)
    w_apex, apex = find_maximum(psih)
    lo, hi = ((w_apex, 10 * w_apex) if cutoff > 0 else (0, w_apex))
    w_at_cut, _ = find_first_occurrence(psih, value=abs(cutoff) * apex,
                                        step_start=lo, step_limit=hi)
    return w_at_cut / pi


def find_max_scale(wavelet, N, bin_loc=1, bin_amp=1):
    """Largest scale: the one placing amplitude `bin_amp`-of-max at DFT
    bin `bin_loc`."""
    from ..models.wavelets import Wavelet, center_frequency
    wavelet = Wavelet._init_if_not_isinstance(wavelet)

    # anchor at the continuous-time peak-center scale, then rescale so the
    # left-tail crossing lands on the requested bin
    wc = center_frequency(wavelet, kind='peak-ct', N=N)
    s_anchor = (4 / pi) * wc

    spec = wavelet.filterbank_np(np.array([s_anchor]), N=N,
                                 nohalf=True)[0][:N // 2 + 1]
    grid = wavelet.xifn_np(s_anchor, N)
    apex = int(np.argmax(spec))
    left_tail = np.where(spec[:apex] < spec.max() * bin_amp)[0]
    w_tail = grid[left_tail[-1]]
    return s_anchor * (w_tail / grid[bin_loc])


def find_max_scale_alt(wavelet, N, min_cutoff=.1, max_cutoff=.8):
    """'minimal'-preset max scale: the coarsest frequency spacing whose
    grid lands (near-)symmetric points about the spectral peak inside the
    [min_cutoff, max_cutoff]*peak band."""
    if max_cutoff <= 0 or min_cutoff <= 0:
        raise ValueError("`max_cutoff` and `min_cutoff` must be positive "
                         "(got %s, %s)" % (max_cutoff, min_cutoff))
    elif max_cutoff <= min_cutoff:
        raise ValueError("must have `max_cutoff > min_cutoff` "
                         "(got %s, %s)" % (max_cutoff, min_cutoff))

    psih = _freq_fn(wavelet)
    w_apex, apex = find_maximum(psih)
    w_at_cut, _ = find_first_occurrence(psih, value=min_cutoff * apex,
                                        step_start=0, step_limit=w_apex)

    # candidate left-band frequencies at 1/N resolution; a spacing of
    # 2*(peak - w) puts w and its mirror on-grid while skipping the peak
    cand = np.arange(w_at_cut, w_apex, step=1 / N)
    spacing = 2 * (w_apex - cand[:-1])
    frac = (cand[:-1] / spacing) % 1
    # near-integer division counts show as a wrap in the fractional part
    wraps = np.where(np.diff(frac) < -.8)[0]
    if len(wraps) == 0:
        raise Exception("Failed to find sufficiently-integer xi divisions; "
                        "try widening (min_cutoff, max_cutoff)")
    chosen = spacing[wraps[0] + 1]
    return chosen / (pi / (N / 2))  # in units of one DFT-bin spacing


def _as_posint(g, name=''):
    if not (g > 0 and float(g).is_integer()):
        raise ValueError(f"'{name}' must be a positive integer (got {g})")
    return int(g)


def _scales_from_spec(spec, N, wavelet, nv, get_params, use_padded_N):
    """'log[-piecewise]' / 'linear' [+':preset'] string -> scales array."""
    preset = None
    if ':' in spec:
        spec, preset = spec.split(':')
    elif spec == 'log-piecewise':
        preset = 'maximal'
    assert_is_one_of(spec, 'scales', ('log', 'log-piecewise', 'linear'))
    if wavelet is None:
        raise ValueError("must set `wavelet` if `scales` isn't array")
    if nv is None:
        nv = 32
    if not isinstance(nv, np.ndarray):
        nv = _as_posint(nv, 'nv')

    lo, hi = cwt_scalebounds(wavelet, N=N, preset=preset,
                             use_padded_N=use_padded_N)
    scales = make_scales(N, lo, hi, nv=nv, scaletype=spec, wavelet=wavelet)
    return (scales, spec, len(scales), nv) if get_params else scales


def _scales_from_array(arr, nv, get_params):
    """Validate a user scales array and classify its spacing."""
    arr = arr if isinstance(arr, np.ndarray) else np.asarray(arr, np.float64)
    if arr.squeeze().ndim != 1:
        raise ValueError("`scales`, if array, must be 1D "
                         "(got shape %s)" % str(arr.shape))
    kind, nv_inferred = infer_scaletype(arr)
    if kind == 'log':
        if nv is not None and nv_inferred != nv:
            raise Exception("`nv` used in `scales` differs from `nv` "
                            "passed (%s != %s)" % (nv_inferred, nv))
        nv = nv_inferred
    elif kind == 'log-piecewise':
        nv = nv_inferred
    arr = arr.reshape(-1, 1)
    return (arr, kind, len(arr), nv) if get_params else arr


def process_scales(scales, N, wavelet=None, nv=None, get_params=False,
                   use_padded_N=True):
    """String spec -> generated scales; array -> validated (na,1) array.
    With `get_params`: (scales, scaletype, na, nv)."""
    if isinstance(scales, str):
        return _scales_from_spec(scales, N, wavelet, nv, get_params,
                                 use_padded_N)
    if hasattr(scales, 'ndim'):
        return _scales_from_array(np.asarray(scales), nv, get_params)
    raise TypeError("`scales` must be a string or array "
                    "(got %s)" % type(scales))


def infer_scaletype(scales):
    """'linear' | 'log' | 'log-piecewise' (+nv) from an array."""
    scales = np.asarray(scales).reshape(-1, 1)
    if scales.dtype not in (np.float32, np.float64):
        raise TypeError("`scales.dtype` must be np.float32 or np.float64 "
                        "(got %s)" % scales.dtype)

    # flatness-of-second-difference thresholds (f64 / f32 precision floors)
    th_log = 4e-15 if scales.dtype == np.float64 else 8e-7
    log_curv = np.mean(np.abs(np.diff(np.log(scales), 2, axis=0)))
    if log_curv < th_log:
        nv = 1 / np.diff(np.log2(scales), axis=0)[0].squeeze()
        return 'log', int(np.round(nv))

    lin_curv = np.mean(np.abs(np.diff(scales, 2, axis=0)))
    if lin_curv < th_log * 1e3:
        return 'linear', None

    if logscale_transition_idx(scales) is not None:
        return 'log-piecewise', nv_from_scales(scales)

    raise ValueError("could not infer `scaletype` from `scales`; "
                     "must be linear or exponential (got diff(scales)="
                     "%s..." % np.diff(scales, axis=0)[:4])


def make_scales(N, min_scale=None, max_scale=None, nv=32, scaletype='log',
                wavelet=None, downsample=None):
    """Build scales array; 'log-piecewise' downsamples redundant high
    scales past `find_downsampling_scale`."""
    if scaletype == 'log-piecewise' and wavelet is None:
        raise ValueError("must pass `wavelet` for "
                         "`scaletype == 'log-piecewise'`")
    if min_scale is None and max_scale is None and wavelet is not None:
        min_scale, max_scale = cwt_scalebounds(wavelet, N, use_padded_N=True)
    else:
        min_scale = min_scale or 1
        max_scale = max_scale or N
    if downsample is None:
        downsample = get_config().downsample
    downsample = int(downsample)

    # voice grid: na log-steps of 2**(1/nv) from min_scale
    na = int(np.ceil(nv * np.log2(max_scale / min_scale)))
    pow_lo = int(np.floor(nv * np.log2(min_scale)))
    powers = np.arange(pow_lo, pow_lo + na)

    if scaletype == 'log':
        scales = 2 ** (powers / nv)
    elif scaletype == 'log-piecewise':
        scales = 2 ** (powers / nv)
        split = find_downsampling_scale(wavelet, scales)
        if split is not None:
            # `+downsample-1` so the coarse tail continues from the fine
            # head at the downsampled rate
            scales = np.hstack([scales[:split],
                                scales[split + downsample - 1::downsample]])
    elif scaletype == 'linear':
        lo, hi = 2 ** (pow_lo / nv), 2 ** ((pow_lo + na) / nv)
        scales = np.linspace(lo, hi, int(np.ceil(hi / lo)))
    else:
        raise ValueError("`scaletype` must be 'log' or 'linear'; "
                         "got: %s" % scaletype)
    return scales.reshape(-1, 1)


def logscale_transition_idx(scales):
    """Split index of a two-piece log scale array, else None."""
    scales = np.asarray(scales)
    curv = np.abs(np.diff(np.log(scales), 2, axis=0))
    spike = float(curv.max())
    at = int(np.argmax(curv))
    rest = curv.copy()
    rest[at] = 0

    # exactly one spike (>100x the mean), everything else at precision floor
    th = 1e-14 if scales.dtype == np.float64 else 1e-6
    if spike <= 100 * np.abs(rest).mean():
        return None
    if np.any(np.abs(rest) >= th):
        return None
    return at + 2


def nv_from_scales(scales):
    """Per-scale `nv` array (length len(scales))."""
    scales = np.asarray(scales).reshape(-1, 1)
    inv_step = 1 / np.diff(np.log2(scales), axis=0)
    nv = np.vstack([inv_step[:1], inv_step])
    split = logscale_transition_idx(scales)
    if split is not None:
        jump = int(np.argmax(np.abs(np.diff(nv, axis=0)))) + 1
        assert jump == split, "%s != %s" % (jump, split)
    return nv


def find_downsampling_scale(wavelet, scales, span=5, tol=3, method='sum',
                            nonzero_th=.02, nonzero_tol=4., N=None):
    """Index of the first scale where freq-domain wavelets become
    excessively redundant: scanning `span`-row windows, a window is
    redundant when its rows are (a) narrow (few above-threshold bins per
    row) and (b) bunched (row peaks within `tol` bins of the window's
    joint peak, reduced per `method`)."""
    assert_is_one_of(method, 'method', ('any', 'all', 'sum'))
    from ..models.wavelets import Wavelet

    N = N or 2048
    if isinstance(wavelet, np.ndarray):
        Psih = wavelet
    else:
        wavelet = Wavelet._init_if_not_isinstance(wavelet)
        Psih = wavelet.filterbank_np(np.asarray(scales).squeeze(), N=N,
                                     nohalf=True)
    if len(Psih) != len(scales):
        raise ValueError("len(Psih) != len(scales) (%s != %s)"
                         % (len(Psih), len(scales)))

    Psih = Psih[:, :Psih.shape[1] // 2]  # analytic: right half is zero
    n_windows = len(Psih) - span - 1
    if n_windows <= 0:
        return None

    # per-row stats once, window tests by moving sum
    row_max = Psih.max(axis=1, keepdims=True)
    wide_bins = (Psih > nonzero_th * row_max).sum(axis=1)

    hit = None
    for w0 in range(n_windows):
        rows = Psih[w0:w0 + span]
        if wide_bins[w0:w0 + span].sum() / span > nonzero_tol:
            continue  # rows too wide — not yet redundant territory
        ridx, peak_cols = np.where(rows == row_max[w0:w0 + span])
        joint = int(np.argmax(np.prod(rows, 0)))
        spread = np.abs(peak_cols - joint)
        bunched = ((method == 'any' and spread.max() < tol) or
                   (method == 'all' and not np.all(spread > tol)) or
                   (method == 'sum' and spread.sum() < tol))
        if bunched:
            hit = w0
            break

    # a hit on the very last window is indistinguishable from "never"
    return hit if (hit is not None and hit < n_windows - 1) else None


def _process_fs_and_t(fs, t, N):
    """(dt, fs, t) from sampling rate or time vector."""
    if fs is not None and t is not None:
        WARN("`t` will override `fs` (both were passed)")
    if t is not None:
        if len(t) != N:
            raise Exception("`t` must be of same length as `x` "
                            "(%s != %s)" % (len(t), N))
        if not (np.mean(np.abs(np.diff(t, 2, axis=0))) < 1e-7):
            raise Exception("Time vector `t` must be uniformly sampled.")
        fs = 1 / (t[1] - t[0])
    elif fs is None:
        fs = 1
    elif fs <= 0:
        raise ValueError("`fs` must be > 0")
    return 1 / fs, fs, t
