# -*- coding: utf-8 -*-
"""Plans carried across from the JAX package.

The synchrosqueezed CWT has no learned weights: what crosses from
`ssqueezepy_tpu` is its host plan — the scales and the ssq frequency
grid as numpy arrays. `plan_from_numpy` builds this package's plan from
those arrays, so both packages can be fed one identical plan; `ssq_cwt`
accepts the same arrays directly as `scales=` and `ssq_freqs=`.
"""
import numpy as np

from .models.cwt import resolve_wavelet
from .models.ssq_cwt import _build_ssq_cwt_plan

__all__ = ['plan_from_numpy']


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
