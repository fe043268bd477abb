# -*- coding: utf-8 -*-
"""Synchrosqueezing bin map and the plain reassignment scatter.

Counterpart of `ssq_bin_params`, `compute_bins` and `_scatter_xla` in
`ssqueezepy_tpu/ops/ssq_kernels.py`. The bin-map parameters are host
numpy (once per plan); `compute_bins` and `scatter_plain` are plain
PyTorch — the latter is the plain version of the CUDA kernel in
`ops/ssq_cuda.py`.
"""
import numpy as np
import torch

from ..utils.common import WARN, EPS64

__all__ = ['ssq_bin_params', 'compute_bins', 'scatter_plain']


def _ensure_nonzero_nonnegative(name, x, silent=False):
    if x < EPS64:
        if not silent:
            WARN("computed `%s` (%.2e) is below EPS64; will set to EPS64. "
                 "Advised to check `ssq_freqs`." % (name, x))
        x = EPS64
    return x


def ssq_bin_params(ssq_freqs, logscale):
    """dict of bin-map params from the ssq frequency grid: 'lin' (vmin,
    dv), 'log' (vlmin, dvl) or 'log-piecewise' (two log segments joined
    at idx1), plus omax = len(ssq_freqs) - 1."""
    from ..utils.cwt_utils import logscale_transition_idx
    v = np.asarray(ssq_freqs).squeeze()
    if not logscale:
        dv = float(v[1] - v[0])
        dv = _ensure_nonzero_nonnegative('dv', dv)
        return dict(mode='lin', vmin=float(v[0]), dv=dv, omax=len(v) - 1)

    idx = logscale_transition_idx(v.reshape(-1, 1))
    vlmin = float(np.log2(v[0]))
    if idx is None:
        dvl = float(np.log2(v[1]) - np.log2(v[0]))
        dvl = _ensure_nonzero_nonnegative('dvl', dvl)
        return dict(mode='log', vlmin=vlmin, dvl=dvl, omax=len(v) - 1)

    vlmin0, vlmin1 = vlmin, float(np.log2(v[idx - 1]))
    dvl0 = float(np.log2(v[1]) - np.log2(v[0]))
    dvl1 = float(np.log2(v[idx]) - np.log2(v[idx - 1]))
    dvl0 = _ensure_nonzero_nonnegative('dvl0', dvl0, silent=True)
    dvl1 = _ensure_nonzero_nonnegative('dvl1', dvl1)
    return dict(mode='log-piecewise', vlmin0=vlmin0, vlmin1=vlmin1,
                dvl0=dvl0, dvl1=dvl1, idx1=int(idx - 1), omax=len(v) - 1)


def compute_bins(w, params, flipud=False):
    """int32 bin indices from phase-transform values `w` (inf = invalid);
    returns (k, valid). Rounds half to even, as the reference does."""
    omax = params['omax']
    if params['mode'] == 'lin':
        k = torch.clamp_max(torch.round(torch.clamp_min(
            (w - params['vmin']) / params['dv'], 0)), omax)
    elif params['mode'] == 'log':
        wl = torch.log2(w)
        k = torch.clamp_max(torch.round(torch.clamp_min(
            (wl - params['vlmin']) / params['dvl'], 0)), omax)
    else:  # log-piecewise (two segments)
        wl = torch.log2(w)
        k_hi = torch.clamp_max(
            torch.round((wl - params['vlmin1']) / params['dvl1'])
            + params['idx1'], omax)
        k_lo = torch.clamp_min(
            torch.round((wl - params['vlmin0']) / params['dvl0']), 0)
        k = torch.where(wl > params['vlmin1'], k_hi, k_lo)

    valid = torch.isfinite(w)
    k = torch.where(valid, k, torch.zeros_like(k)).to(torch.int32)
    if flipud:
        k = omax - k
    return k, valid


def scatter_plain(v, k, nbins):
    """out[k[i,j], j] += v[i,j] over complex `v`; entries with k outside
    [0, nbins) are dropped."""
    valid = (k >= 0) & (k < nbins)
    cols = torch.arange(v.shape[-1], device=v.device).expand(k.shape)
    out = torch.zeros((nbins, v.shape[-1]), dtype=v.dtype, device=v.device)
    out.index_put_((k[valid].long(), cols[valid]), v[valid],
                   accumulate=True)
    return out
