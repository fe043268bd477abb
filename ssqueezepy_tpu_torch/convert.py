# -*- coding: utf-8 -*-
"""Plans carried across from the JAX package.

The synchrosqueezed transforms have no learned weights: what crosses from
`ssqueezepy_tpu` is their host plans as numpy arrays — for the CWT the
scales and the ssq frequency grid, for the STFT the window, its
derivative window, the row frequencies Sfs, the ssq grid and the bin
map, for the second-order STFT the five-window bank. `plan_from_numpy`,
`stft_plan_from_numpy` and `fsst2_plan_from_numpy` build this package's
plans from those arrays, so both packages can be fed identical plans;
`ssq_cwt` accepts the CWT arrays directly as `scales=` and `ssq_freqs=`,
`ssq_stft` the window and grid as `window=` and `ssq_freqs=`.
"""
import numpy as np

from .models.cwt import resolve_wavelet
from .models.ssq_cwt import _build_ssq_cwt_plan
from .models.ssq_stft import Fsst2Plan, StftPlan
from .ops.ssq_kernels import ssq_bin_params

__all__ = ['plan_from_numpy', 'stft_plan_from_numpy', 'fsst2_plan_from_numpy']


def plan_from_numpy(scales, ssq_freqs, wavelet_spec, N, maprange='peak',
                    dt=1., padded=True):
    """Port plan from numpy `scales` (na,) or (na, 1) and `ssq_freqs`
    (nbins,) (or None, to compute the grid here). Returns a dict with
    `scales` (na, 1), `ssq_freqs`, `const` (squeeze constant: per row, or
    a scalar for 'log' grids) and `params` (bin map)."""
    wavelet = resolve_wavelet(wavelet_spec, l1_norm=True, N=N)
    ssq = None if ssq_freqs is None else np.asarray(ssq_freqs)
    plan = _build_ssq_cwt_plan(wavelet, N, np.asarray(scales).reshape(-1, 1),
                               None, ssq, maprange, padded, dt)
    return plan._asdict()


def _lin_grid(Sfs, ssq_freqs, params):
    Sfs = np.asarray(Sfs)
    ssq = Sfs if ssq_freqs is None else np.asarray(ssq_freqs)
    own = ssq_bin_params(ssq, logscale=False)
    if params is not None and dict(params) != own:
        raise ValueError("bin params %r differ from those of ssq_freqs %r"
                         % (dict(params), own))
    return Sfs, ssq, float(ssq[1] - ssq[0]), own


def stft_plan_from_numpy(window, diff_window, Sfs, ssq_freqs=None,
                         params=None):
    """Port `StftPlan` (see `models/ssq_stft.py`) from numpy `window` and
    `diff_window` (n_fft,), `Sfs` (n_rows,) and `ssq_freqs` (nbins,;
    default Sfs). `params`, the JAX plan's bin map, must equal the one
    computed here from `ssq_freqs` (it raises otherwise)."""
    return StftPlan(np.asarray(window), np.asarray(diff_window),
                    *_lin_grid(Sfs, ssq_freqs, params))


def fsst2_plan_from_numpy(bank, Sfs, ssq_freqs=None, params=None):
    """Port `Fsst2Plan` (see `models/ssq_stft.py`) from the JAX package's
    five-window bank `_fsst2_bank(...)` (5, n_fft), `Sfs` and `ssq_freqs`
    (default Sfs); `params` as for `stft_plan_from_numpy`."""
    bank = np.asarray(bank, np.float64)
    if bank.ndim != 2 or bank.shape[0] != 5:
        raise ValueError("bank must be (5, n_fft) (got %s)" % (bank.shape,))
    return Fsst2Plan(bank, *_lin_grid(Sfs, ssq_freqs, params))
