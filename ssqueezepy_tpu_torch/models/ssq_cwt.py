# -*- coding: utf-8 -*-
"""Synchrosqueezed CWT (forward & inverse).

Counterpart of `ssqueezepy_tpu/models/ssq_cwt.py`. The host plan (scales,
ssq frequency grid, squeeze constant, bin parameters) is resolved once
and memoized; the signal (1-D, or a (B, N) batch) then runs pad -> real
FFT (torch.fft) and one of two routes:

  * the fused CWT + bins kernel (`ops/cwt_cuda.py::cwt_bins`,
    batched for 2-D input) -> `_apply_squeezing` on Wx -> the
    reassignment scatter (`ops/ssq_cuda.py::scatter_kv`); the bins always
    come from the raw Wx;
  * with `get_dWx=True`: the CWT kernel in derivative mode
    (`cwt_fused`) -> the fused phase + bins + scatter kernel
    (`ops/ssq_cuda.py::ssq_fused`), and dWx is returned.

On a CUDA device the kernels are the hand-written CUDA ones; with
``device='cpu'`` their plain PyTorch versions run. The TPU's natural-bin
row placement is not needed: the scatters walk each column's rows in
order.
"""
import collections

import numpy as np
import torch

from ..configs import device_dtype
from ..ops.cwt_cuda import cwt_bins, cwt_fused
from ..ops.fft import rfft
from ..ops.pad import padsignal, pad_params
from ..ops.ssq_cuda import scatter_kv, ssq_fused
from ..ops.ssq_kernels import ssq_bin_params
from ..utils.common import EPS32, EPS64, not_ported, resolve_device
from ..utils.cwt_utils import (process_scales, adm_ssq, _process_fs_and_t,
                               infer_scaletype, nv_from_scales)
from .cwt import resolve_wavelet, _wavelet_key
from .wavelets import Wavelet
from .ssqueezing import (_check_ssqueezing_args,
                         _compute_associated_frequencies)

__all__ = ['ssq_cwt', 'issq_cwt']


_PLAN_CACHE = {}
_DEV_CACHE = {}

# scales (na, 1); ssq_freqs (nbins,); const: the squeeze constant, per row
# or a scalar for 'log' grids; params: the bin map (`ssq_bin_params`)
Plan = collections.namedtuple('Plan', 'scales ssq_freqs const params')


def _spec_key(spec):
    """Hashable key for a scales/ssq_freqs spec: strings pass through,
    arrays key by content hash."""
    if spec is None or isinstance(spec, str):
        return spec
    if isinstance(spec, np.ndarray):
        return ('nd', hash(spec.tobytes()), spec.shape, str(spec.dtype))
    return None


def _ssq_cwt_plan(wavelet, N, scales, nv, ssq_freqs, maprange, was_padded,
                  dt):
    """Host `Plan`, memoized for string AND array specs (the scale-bound
    searches and center-frequency integrals cost ~100 ms+ per call).
    Returns (plan, key); key is None when the spec is not cacheable."""
    skey, fkey = _spec_key(scales), _spec_key(ssq_freqs)
    key = None
    if (skey is not None and (ssq_freqs is None or fkey is not None) and
            not isinstance(maprange, (tuple, list))):
        key = (_wavelet_key(wavelet), N, skey, nv, fkey, maprange,
               was_padded, float(dt))
        hit = _PLAN_CACHE.get(key)
        if hit is not None:
            return hit, key
    out = _build_ssq_cwt_plan(wavelet, N, scales, nv, ssq_freqs, maprange,
                              was_padded, dt)
    if key is not None:
        _PLAN_CACHE[key] = out
    return out, key


def _build_ssq_cwt_plan(wavelet, N, scales, nv, ssq_freqs, maprange,
                        was_padded, dt):
    scales_np, cwt_scaletype, _, nv_ = process_scales(
        scales, N, wavelet, nv=nv, get_params=True)

    if ssq_freqs is None:
        ssq_freqs = cwt_scaletype
    if not isinstance(ssq_freqs, np.ndarray):
        ssq_scaletype = ssq_freqs if isinstance(ssq_freqs, str) \
            else cwt_scaletype
        if ((maprange == 'maximal' or isinstance(maprange, tuple)) and
                ssq_scaletype == 'log-piecewise'):
            raise ValueError("can't have `ssq_scaletype = log-piecewise` "
                             "with `maprange = 'maximal'`")
        ssq_freqs = _compute_associated_frequencies(
            scales_np, N, wavelet, ssq_scaletype, maprange, was_padded, dt,
            'cwt')
    else:
        ssq_scaletype, _ = infer_scaletype(ssq_freqs)

    # squeeze constant: per row for log-piecewise scales (downsampled high
    # scales carry 1/downsample the voices), a scalar for 'log' grids
    if cwt_scaletype == 'log-piecewise':
        const = np.log(2) / nv_from_scales(scales_np)
    elif cwt_scaletype.startswith('log'):
        const = np.log(2) / nv_
    else:
        const = ((scales_np[1] - scales_np[0]) / scales_np).squeeze()

    params = ssq_bin_params(ssq_freqs, ssq_scaletype.startswith('log'))
    return Plan(scales_np, ssq_freqs, const, params)


def _device_plan(key, scales_np, const, dtype, device):
    """(scales, const) as (na,) tensors on `device`; `const` broadcast
    from a scalar where the grid is 'log'. Memoized per plan."""
    ck = None if key is None else (key, dtype, str(device))
    hit = _DEV_CACHE.get(ck) if ck is not None else None
    if hit is not None:
        return hit
    na = len(scales_np)
    tdt = getattr(torch, dtype)
    c = np.broadcast_to(np.asarray(const, np.float64).reshape(-1), (na,))
    out = (torch.as_tensor(np.asarray(scales_np, np.float64).reshape(-1),
                           dtype=tdt, device=device).contiguous(),
           torch.as_tensor(np.array(c), dtype=tdt,
                           device=device))
    if ck is not None:
        _DEV_CACHE[ck] = out
    return out


def _check_slice(x, wavelet, padtype, squeezing, order, get_w, difftype,
                 get_dWx):
    """Calls outside the ported slice raise, naming their ROADMAP item."""
    if isinstance(order, (tuple, list, range)) or order > 0:
        not_ported("ssq_cwt with order > 0", 'A6b')
    if get_w:
        not_ported("ssq_cwt with get_w=True", 'A6b')
    if difftype != 'trig':
        not_ported("difftype != 'trig'", 'A6b')
    if not isinstance(squeezing, str):
        not_ported("callable squeezing", 'A5b')
    if get_dWx and squeezing != 'sum':
        not_ported("get_dWx=True with squeezing=%r (phase transform, then "
                   "the generic scatter)" % squeezing, 'B5')
    if x.ndim not in (1, 2):
        raise ValueError("`x` must be 1D or 2D (got x.ndim == %s)" % x.ndim)
    if padtype is None:
        not_ported("padtype=None", 'A6b')


def ssq_cwt(x, wavelet='gmw', scales='log-piecewise', nv=None, fs=None,
            t=None, ssq_freqs=None, padtype='reflect', squeezing='sum',
            maprange='peak', difftype='trig', difforder=None, gamma=None,
            vectorized=True, preserve_transform=None, astensor=True,
            order=0, nan_checks=None, patience=0, flipud=True,
            cache_wavelet=None, get_w=False, get_dWx=False, get_Wx=True,
            device='cuda'):
    """Synchrosqueezed Continuous Wavelet Transform of a 1-D signal or a
    (B, N) batch.

    Returns (Tx, Wx, ssq_freqs, scales[, dWx]): Tx (nbins, N) and Wx
    (na, N) complex tensors on `device`, (B, nbins, N) and (B, na, N) for
    a batch (numpy with `astensor=False`; Wx is None with `get_Wx=False`),
    ssq_freqs reversed (high to low), scales (na,), and dWx like Wx with
    `get_dWx=True`. `squeezing` is 'sum', 'lebesgue' or 'abs' (the latter
    two not with `get_dWx`). `scales` and `ssq_freqs` may be strings or
    numpy arrays.
    """
    device = resolve_device(device)
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    _check_ssqueezing_args(squeezing, maprange, wavelet, difftype,
                           difforder, get_w, transform='cwt')
    _check_slice(x, wavelet, padtype, squeezing, order, get_w, difftype,
                 get_dWx)
    if nv is None and not isinstance(scales, np.ndarray):
        nv = 32
    N = x.shape[-1]
    dt, _, _ = _process_fs_and_t(fs, t, N)

    wavelet = resolve_wavelet(wavelet, l1_norm=True, N=N)
    dtype = device_dtype(wavelet.dtype)
    # gamma default: 10 * machine epsilon
    if gamma is None:
        gamma = 10 * (EPS64 if dtype == 'float64' else EPS32)
    gamma = float(gamma)

    plan, key = _ssq_cwt_plan(wavelet, N, scales, nv, ssq_freqs, maprange,
                              padtype is not None, dt)
    params = plan.params
    n_up, n1, _ = pad_params(N, padtype)
    scales_t, const_t = _device_plan(key, plan.scales, plan.const, dtype,
                                     device)

    xt = torch.as_tensor(x, dtype=getattr(torch, dtype), device=device)
    xt = torch.where(torch.isfinite(xt), xt, torch.zeros_like(xt))
    xh = rfft(padsignal(xt, padtype)).contiguous()
    dWx = None
    if get_dWx:
        Wx, dWx = cwt_fused(xh, scales_t, wavelet, n_up, n1, N, dt, True,
                            True)
        Tx = ssq_fused(Wx, dWx, const_t, params, gamma, flipud)
    else:
        Wx, k = cwt_bins(xh, scales_t, wavelet, n_up, n1, N, dt, True,
                         params, gamma, flipud)
        Tx = scatter_kv(_apply_squeezing(Wx, squeezing), k, const_t,
                        params['omax'] + 1)
    if not get_Wx:
        Wx = None

    # for CWT, ssq_freqs are always returned reversed
    ssq_freqs_out = np.asarray(plan.ssq_freqs)[::-1].copy()
    scales_out = plan.scales.squeeze()
    if not astensor:
        Tx = Tx.cpu().numpy()
        Wx = Wx.cpu().numpy() if Wx is not None else None
        dWx = dWx.cpu().numpy() if dWx is not None else None
    if get_dWx:
        return Tx, Wx, ssq_freqs_out, scales_out, dWx
    return Tx, Wx, ssq_freqs_out, scales_out


def _apply_squeezing(Wx, squeezing):
    """The values the scatter sums: Wx for 'sum', 1/na everywhere for
    'lebesgue', |Wx| for 'abs' (as complex tensors of Wx's type)."""
    if squeezing == 'sum':
        return Wx
    if squeezing == 'lebesgue':
        return torch.full_like(Wx, 1. / Wx.shape[-2])
    return Wx.abs().to(Wx.dtype)


def issq_cwt(Tx, wavelet='gmw', cc=None, cw=None):
    """Inverse synchrosqueezed CWT: full inversion
    ``x = Re(sum(Tx, axis=-2)) * 2/Css`` ((N,) from (nbins, N), (B, N)
    from a (B, nbins, N) batch) or masked per-component inversion. `Tx` a
    complex tensor (reduced on its device) or numpy array; returns
    numpy."""
    cc, cw, full_inverse = _process_component_inversion_args(cc, cw)

    if full_inverse:
        if isinstance(Tx, torch.Tensor):
            x = Tx.real.sum(dim=-2).cpu().numpy()
        else:
            x = np.asarray(Tx).real.sum(axis=-2)
    else:
        x = _invert_components(Tx, cc, cw)

    wavelet = Wavelet._init_if_not_isinstance(wavelet)
    Css = adm_ssq(wavelet)
    return x * (2 / Css)


def _invert_components(Tx, cc, cw):
    """Masked per-component inversion: component `n` collects the rows in
    the band ``[cc[:, n] - cw[:, n], cc[:, n] + cw[:, n]]`` at each time
    step (``cc == -1`` marks no-curve columns, which contribute nothing);
    the final output row is the residual — everything no component's band
    touched. A tensor input is reduced on its device; only the
    (n_components + 1, N) result crosses to the host."""
    if isinstance(Tx, torch.Tensor):
        Txr = Tx.real
        na = Txr.shape[0]
        cc_t = torch.as_tensor(cc, device=Txr.device)
        cw_t = torch.as_tensor(cw, device=Txr.device)
        rows = torch.arange(na, device=Txr.device).reshape(1, na, 1)
        hi = torch.clamp(cc_t + cw_t, 0, na).T[:, None, :]   # (nc, 1, N)
        lo = torch.clamp(cc_t - cw_t, 0, na).T[:, None, :]
        miss = (cc_t == -1).T[:, None, :]
        band = (rows >= lo) & (rows <= hi) & ~miss           # (nc, na, N)
        comps = (Txr[None] * band).sum(dim=1)                # (nc, N)
        resid = (Txr * ~band.any(dim=0)).sum(dim=0)
        return torch.cat([comps, resid[None]], dim=0).cpu().numpy()

    # numpy input: one broadcast band per component, on the host
    Txr = np.asarray(Tx).real
    na, N = Txr.shape
    rows = np.arange(na).reshape(na, 1)
    out = np.zeros((cc.shape[1] + 1, N), Txr.dtype)
    covered = np.zeros((na, N), bool)
    for n in range(cc.shape[1]):
        hi = np.clip(cc[:, n] + cw[:, n], 0, na)
        lo = np.clip(cc[:, n] - cw[:, n], 0, na)
        band = (rows >= lo) & (rows <= hi) & (cc[:, n] != -1)
        out[n] = np.einsum('rt,rt->t', Txr, band.astype(Txr.dtype))
        covered |= band
    out[-1] = np.where(covered, 0, Txr).sum(axis=0)
    return out


def _process_component_inversion_args(cc, cw):
    if (cc is None) and (cw is None):
        return cc, cw, True
    if cc.ndim == 1:
        cc = cc.reshape(-1, 1)
    if cw.ndim == 1:
        cw = cw.reshape(-1, 1)
    return cc.astype('int32'), cw.astype('int32'), False
