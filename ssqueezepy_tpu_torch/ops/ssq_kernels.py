# -*- coding: utf-8 -*-
"""Synchrosqueezing bin map, the plain reassignment scatter, the fused
reassignment from (Wx, dWx) and the reassignment from a phase transform.

Counterpart of `ssq_bin_params`, `compute_bins`, `_broadcast_const`,
`_scatter_xla`, `_dispatch_scatter`, `ssqueeze_fast`, `indexed_sum_onfly`,
`indexed_sum` and the `find_closest` family in
`ssqueezepy_tpu/ops/ssq_kernels.py`. The bin-map parameters are host numpy
(once per plan); `compute_bins` and `scatter_plain` are plain PyTorch, the
building blocks of the plain versions of the CUDA kernels in
`ops/ssq_cuda.py`. `ssqueeze_fast` runs the fused phase + bins + scatter
kernel (`ops/ssq_cuda.py::ssq_fused`); `indexed_sum_onfly` bins a given
phase transform w on the device (elementwise torch ops) and runs the
generic scatter (`ops/ssq_cuda.py::shift_scatter`): on CUDA tensors the
kernels, on CPU tensors their plain versions. `find_closest*` are host
numpy.
"""
import functools

import numpy as np
import torch

from ..utils.common import WARN, EPS64, resolve_device, to_device

__all__ = ['ssq_bin_params', 'compute_bins', 'scatter_plain',
           'ssqueeze_fast', 'indexed_sum_onfly', 'indexed_sum',
           'find_closest', 'find_closest_smart', 'find_closest_brute',
           'find_closest_log', 'find_closest_lin']


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


@functools.lru_cache(maxsize=64)
def _divisor(v, dtype, device):
    """`v` as a 0-dim tensor: torch divides by a Python number on a CUDA
    tensor as a multiply by its reciprocal, a bit off the quotient, where
    the kernels' bin map divides; by a tensor it divides as they do."""
    return torch.tensor(v, dtype=dtype, device=device)


def compute_bins(w, params, flipud=False):
    """int32 bin indices from phase-transform values `w` (inf = invalid);
    returns (k, valid). Rounds half to even, as the reference does, and
    divides as the kernels' bin map does (`csrc/bins.cuh::bin_of`), so
    the bins of a kernel's w are its k."""
    omax = params['omax']

    def div(x, v):
        return x / _divisor(float(v), x.dtype, x.device)
    if params['mode'] == 'lin':
        k = torch.clamp_max(torch.round(torch.clamp_min(
            div(w - params['vmin'], params['dv']), 0)), omax)
    elif params['mode'] == 'log':
        wl = torch.log2(w)
        k = torch.clamp_max(torch.round(torch.clamp_min(
            div(wl - params['vlmin'], params['dvl']), 0)), omax)
    else:  # log-piecewise (two segments)
        wl = torch.log2(w)
        k_hi = torch.clamp_max(
            torch.round(div(wl - params['vlmin1'], params['dvl1']))
            + params['idx1'], omax)
        k_lo = torch.clamp_min(
            torch.round(div(wl - params['vlmin0'], params['dvl0'])), 0)
        k = torch.where(wl > params['vlmin1'], k_hi, k_lo)

    valid = torch.isfinite(w)
    k = torch.where(valid, k, torch.zeros_like(k)).to(torch.int32)
    if flipud:
        k = omax - k
    return k, valid


def scatter_plain(v, k, nbins):
    """out[k[i,j], j] += v[i,j] over complex `v` (na, N), or per signal of
    a (B, na, N) batch; entries with k outside [0, nbins) are dropped."""
    if v.dim() == 3:
        return torch.stack([scatter_plain(vb, kb, nbins)
                            for vb, kb in zip(v, k)])
    valid = (k >= 0) & (k < nbins)
    cols = torch.arange(v.shape[-1], device=v.device).expand(k.shape)
    out = torch.zeros((nbins, v.shape[-1]), dtype=v.dtype, device=v.device)
    out.index_put_((k[valid].long(), cols[valid]), v[valid],
                   accumulate=True)
    return out


def _broadcast_const(const, na, dtype, device):
    """The squeeze constant as a contiguous (na,) tensor: a scalar ('log'
    and STFT grids) is broadcast to every row."""
    if isinstance(const, torch.Tensor):
        c = const.to(dtype=dtype, device=device).reshape(-1)
    else:
        c = torch.as_tensor(np.asarray(const, np.float64).reshape(-1),
                            dtype=dtype, device=device)
    if c.numel() == 1:
        c = c.expand(na)
    if c.shape != (na,):
        raise ValueError("const must be a scalar or have one entry per row "
                         "(%d), got %d" % (na, c.numel()))
    return c.contiguous()


def ssqueeze_fast(Wx, dWx, ssq_freqs, const, logscale=False, flipud=False,
                  gamma=None, Sfs=None, params=None, out=None,
                  natural_bins=None, device='cuda'):
    """Fused phase transform + bin map + scatter-add: Tx (nbins, N) from
    complex Wx, dWx (na, N), or (B, nbins, N) from (B, na, N) batches
    (tensors or numpy, moved to `device`), a tensor on `device`. `const`
    the squeeze constant (scalar or (na,)); `Sfs` (na,), when given, the
    STFT row frequencies the phase transform is offset from; `params` from
    `ssq_bin_params` (else built from `ssq_freqs` and `logscale`). `gamma`
    is required: it gates |Wx| <= gamma. `out` is ignored and
    `natural_bins` has no effect (the JAX package's parameters, at its
    positions: there they pick the TPU scatter's layout)."""
    from .ssq_cuda import ssq_fused
    if gamma is None:
        raise ValueError("`gamma` is required")
    device = resolve_device(device)
    Wx = to_device(Wx, device)
    dWx = to_device(dWx, device)
    if params is None:
        params = ssq_bin_params(np.asarray(ssq_freqs), logscale)
    rdt = Wx.real.dtype
    na = Wx.shape[-2]
    c = _broadcast_const(const, na, rdt, Wx.device)
    if Sfs is not None:
        Sfs = torch.as_tensor(Sfs).to(dtype=rdt, device=Wx.device)
        Sfs = Sfs.reshape(-1).contiguous()
    return ssq_fused(Wx.contiguous(), dWx.contiguous(), c, params,
                     float(gamma), bool(flipud), Sfs)


def _dispatch_scatter(v, k, valid, nbins, const=None):
    """out[k, j] += v[i, j] (* const[i]) over the valid cells, negative k
    wrapped once: the generic scatter (B5) on v's device."""
    from .ssq_cuda import shift_scatter
    return shift_scatter(v, k, valid, nbins, const)


def indexed_sum_onfly(Wx, w, ssq_freqs, const=1, logscale=False,
                      flipud=False, out=None, parallel=None, params=None,
                      natural_bins=None, device='cuda'):
    """Scatter-add of complex Wx (na, N), or a (B, na, N) batch, by the
    bins of a precomputed phase transform `w` (real, Wx's shape; inf marks
    a dropped cell): Tx[k(w[i, j]), j] += Wx[i, j] * const[i]. `const` a
    scalar or (na,); `params` from `ssq_bin_params` (else built from
    `ssq_freqs` and `logscale`). Tensors or numpy, moved to `device`;
    returns a tensor on `device`. `out` and `parallel` are ignored and
    `natural_bins` has no effect, as in the JAX package."""
    device = resolve_device(device)
    Wx = to_device(Wx, device)
    w = to_device(w, device)
    if params is None:
        params = ssq_bin_params(np.asarray(ssq_freqs), logscale)
    k, valid = compute_bins(w, params, flipud)
    c = _broadcast_const(const, Wx.shape[-2], Wx.real.dtype, Wx.device)
    return _dispatch_scatter(Wx.contiguous(), k.contiguous(),
                             valid.contiguous(), params['omax'] + 1, c)


def indexed_sum(a, k, parallel=None, device='cuda'):
    """out[k[i, j], j] += a[i, j] over complex `a` (na, N) and int bins
    `k`, nbins = na, a negative k wrapped once; returns numpy. `parallel`
    is ignored, as in the JAX package."""
    device = resolve_device(device)
    a = to_device(a, device)
    if not a.is_complex():
        a = a.to(torch.complex128 if a.dtype == torch.float64
                 else torch.complex64)
    k = to_device(k, device).to(torch.int32)
    out = _dispatch_scatter(a.contiguous(), k.contiguous(), None,
                            a.shape[0])
    return out.cpu().numpy()


def find_closest(a, v, logscale=False, parallel=None, smart=None):
    """argmin(|a[i, j] - v|) over v for each element of 2-D `a` (host
    numpy); by the bin map of `v` where `smart` is false, or where it is
    None and `parallel` is given."""
    a, v = np.asarray(a), np.asarray(v).squeeze()
    if smart is None and parallel is None:
        smart = True
    if smart:
        return (find_closest_smart(np.log2(a), np.log2(v)) if logscale
                else find_closest_smart(a, v))
    if logscale:
        return find_closest_log(a, v)
    return find_closest_lin(a, v)


def find_closest_smart(a, v):
    """Exact argmin through a sorted search."""
    sidx = v.argsort()
    v_s = v[sidx]
    idx = np.searchsorted(v_s, a)
    idx[idx == len(v)] = len(v) - 1
    idx0 = (idx - 1).clip(min=0)
    m = np.abs(a - v_s[idx]) >= np.abs(v_s[idx0] - a)
    m[idx == 0] = 0
    idx[m] -= 1
    return sidx[idx]


def find_closest_brute(a, v):
    """Exhaustive argmin."""
    return np.argmin(np.abs(a[..., None] - v), axis=-1)


def find_closest_log(a, v):
    """The 'log' bin map of grid `v` applied to `a`."""
    k, _ = compute_bins(to_device(np.asarray(a), 'cpu'),
                        ssq_bin_params(v, logscale=True))
    return k.numpy()


def find_closest_lin(a, v):
    """The 'lin' bin map of grid `v` applied to `a`."""
    k, _ = compute_bins(to_device(np.asarray(a), 'cpu'),
                        ssq_bin_params(v, logscale=False))
    return k.numpy()
