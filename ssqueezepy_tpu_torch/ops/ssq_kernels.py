# -*- coding: utf-8 -*-
"""Synchrosqueezing bin map, the plain reassignment scatter and the fused
reassignment from (Wx, dWx).

Counterpart of `ssq_bin_params`, `compute_bins`, `_broadcast_const`,
`_scatter_xla` and `ssqueeze_fast` in `ssqueezepy_tpu/ops/ssq_kernels.py`.
The bin-map parameters are host numpy (once per plan); `compute_bins` and
`scatter_plain` are plain PyTorch, the building blocks of the plain
versions of the CUDA kernels in `ops/ssq_cuda.py`. `ssqueeze_fast` runs
the fused phase + bins + scatter kernel (`ops/ssq_cuda.py::ssq_fused`):
on CUDA tensors the kernel, on CPU tensors its plain version.
"""
import numpy as np
import torch

from ..utils.common import WARN, EPS64, resolve_device

__all__ = ['ssq_bin_params', 'compute_bins', 'scatter_plain',
           'ssqueeze_fast']


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
                  gamma=None, Sfs=None, params=None, device='cuda'):
    """Fused phase transform + bin map + scatter-add: Tx (nbins, N) from
    complex Wx, dWx (na, N), or (B, nbins, N) from (B, na, N) batches
    (tensors or numpy, moved to `device`), a tensor on `device`. `const`
    the squeeze constant (scalar or (na,)); `Sfs` (na,), when given, the
    STFT row frequencies the phase transform is offset from; `params` from
    `ssq_bin_params` (else built from `ssq_freqs` and `logscale`). `gamma`
    is required: it gates |Wx| <= gamma."""
    from .ssq_cuda import ssq_fused
    if gamma is None:
        raise ValueError("`gamma` is required")
    device = resolve_device(device)
    Wx = torch.as_tensor(Wx, device=device)
    dWx = torch.as_tensor(dWx, device=device)
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
