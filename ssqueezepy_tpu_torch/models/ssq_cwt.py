# -*- coding: utf-8 -*-
"""Synchrosqueezed CWT (forward & inverse).

Counterpart of `ssqueezepy_tpu/models/ssq_cwt.py`. The host plan (scales,
ssq frequency grid, squeeze constant, bin parameters) is resolved once
and memoized; the signal (1-D, or a (B, N) batch) then runs pad -> real
FFT (torch.fft) and one of three routes:

  * the fused CWT + bins kernel (`ops/cwt_cuda.py::cwt_bins`,
    batched for 2-D input) -> `_apply_squeezing` on Wx (any squeezing, a
    function of Wx included) -> the reassignment scatter
    (`ops/ssq_cuda.py::scatter_kv`); the bins always come from the raw
    Wx;
  * with `get_dWx=True` and 'sum' squeezing: the CWT kernel in
    derivative mode (`cwt_fused`) -> the fused phase + bins + scatter
    kernel (`ops/ssq_cuda.py::ssq_fused`), and dWx is returned;
  * with `get_w=True` (1-D input), or `get_dWx=True` and another
    squeezing: `cwt_fused` in derivative mode -> the phase transform
    (`ops/phase.py::phase_cwt`, 'trig' or 'phase') -> `_apply_squeezing`
    -> the generic scatter (`ops/ssq_kernels.py::indexed_sum_onfly`), as
    the JAX package's compositional route runs; w is returned with
    `get_w`. With `difftype='numeric'` (which needs `get_w`) `cwt_fused`
    returns the whole padded planes, and the route runs as the JAX
    package's does: `phase_cwt_num` on Wx's columns [n1 - 4, n1 + N + 4)
    (n1 the left pad of `p2up(N)`, whatever `padtype`), the scatter over
    those columns, then Tx, Wx and w trimmed by 4 each side; dWx is
    returned padded.

A wavelet outside the CWT kernel's route (`models/cwt.py::
_kernel_route`: morlet, hhhat with mu < 0, a bump that is not analytic
or not real, a user's callable), and any wavelet at a padded length
with a prime factor above 7 (`padtype=None` at an N such as 1031 or
2002), takes `models/cwt.py::cwt_general` for
(Wx, dWx) in place of the kernel, then `ssq_fused` for 'sum' and the
phase transform and the generic scatter otherwise, as the JAX package's
XLA path runs it. `order` > 0 (or a tuple of orders) runs the JAX
package's compositional route: `cwt_higher_order` over the whole padded
window (rpadded), `ops/diff.py::trigdiff` of it, the unpadded slice, then
`ssq_fused` for 'sum' and the phase transform and the generic scatter
otherwise.

`padtype=None` transforms the signal unpadded (n_up = N) on each route;
the kernel's route takes it where N's prime factors are at most 7
(`ops/cwt_cuda.py::kernel_length`), `cwt_general` at any other N,
chosen before anything runs, with every option carried as on a
non-kernel wavelet. An n_up past the CWT kernel's rule (`ops/cwt_cuda.py::
cwt_length_rule`, one block's shared memory; `cwt_kernel_fits`) takes
`cwt_general` the same way, and bins past the reassignment kernels' rule
(`ops/ssq_cuda.py::scatter_rule`) take `ops/ssq_kernels.py::
scatter_general` in the scatter's place (after the torch phase
transform and bin map in B4's: `ssq_fused_general`), on every device.
The JAX package takes its XLA CWT and
`ssqueeze_fast` there; its Tx agrees with this one by the bins criterion
and its Wx to 2e-5 of max (float32) or 1e-9 (float64).

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
from ..ops.diff import trigdiff
from ..ops.phase import phase_cwt, phase_cwt_num
from ..ops import ssq_cuda
from ..ops.ssq_cuda import scatter_kv, ssq_fused
from ..ops.ssq_kernels import (indexed_sum_onfly, scatter_general,
                               ssq_bin_params, ssq_fused_general)
from ..utils.common import (EPS32, EPS64, check_batch, numpy_unless_grad,
                            p2up, resolve_device)
from ..utils.cwt_utils import (process_scales, adm_ssq, _process_fs_and_t,
                               infer_scaletype, nv_from_scales)
from ..utils.plan_cache import disk_memo
from .cwt import (cwt, cwt_general, cwt_spectrum, padded_length,
                  padded_signal, resolve_wavelet, _is_custom, _public_route,
                  _wavelet_key)
from .wavelets import Wavelet
from .ssqueezing import (_apply_squeezing, _check_ssqueezing_args,
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
    searches and center-frequency integrals cost ~100 ms+ per call); a
    plan from string specs is also kept on disk from one process to the
    next (`utils/plan_cache.py`, as the JAX package keeps its own). A
    user's callable is cached nowhere (`models/cwt.py::_wavelet_key`).
    Returns (plan, key); key is None when the plan is not cached."""
    skey, fkey = _spec_key(scales), _spec_key(ssq_freqs)
    key = None
    if (skey is not None and (ssq_freqs is None or fkey is not None) and
            not isinstance(maprange, (tuple, list)) and
            not _is_custom(wavelet)):
        key = (_wavelet_key(wavelet), N, skey, nv, fkey, maprange,
               was_padded, float(dt))
        hit = _PLAN_CACHE.get(key)
        if hit is not None:
            return hit, key

    def build():
        return _build_ssq_cwt_plan(wavelet, N, scales, nv, ssq_freqs,
                                   maprange, was_padded, dt)
    if key is not None and isinstance(scales, str) and (
            ssq_freqs is None or isinstance(ssq_freqs, str)):
        out = Plan(*disk_memo(('ssqueezepy_tpu_torch.ssq_cwt_plan',) + key,
                              build))
    else:
        out = build()
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


def ssq_cwt(x, wavelet='gmw', scales='log-piecewise', nv=None, fs=None,
            t=None, ssq_freqs=None, padtype='reflect', squeezing='sum',
            maprange='peak', difftype='trig', difforder=None, gamma=None,
            vectorized=True, preserve_transform=None, astensor=True,
            order=0, nan_checks=None, patience=0, flipud=True,
            cache_wavelet=None, get_w=False, get_dWx=False, get_Wx=True,
            device='cuda'):
    """Synchrosqueezed Continuous Wavelet Transform of a 1-D signal or a
    (B, N) batch.

    Returns (Tx, Wx, ssq_freqs, scales[, w][, dWx]): Tx (nbins, N) and Wx
    (na, N) complex tensors on `device`, (B, nbins, N) and (B, na, N) for
    a batch (numpy with `astensor=False`; Wx is None with `get_Wx=False`),
    ssq_freqs reversed (high to low), scales (na,), the phase transform w
    (na, N) real with `get_w=True` (1-D input; `difftype` 'trig' or
    'phase' or 'numeric'), and dWx like Wx with `get_dWx=True` (padded,
    (na, n_up), with 'numeric', as the JAX package returns it).
    `squeezing` is 'sum', 'lebesgue', 'abs' or a function of Wx.
    `scales` and `ssq_freqs` may be strings or numpy arrays. `padtype=None`
    transforms the signal unpadded. `wavelet` is any that `cwt` takes;
    `order` > 0 or a tuple of orders (a GMW) squeezes the higher-order
    CWT, averaged over a tuple.
    """
    device = resolve_device(device)
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    difforder = _check_ssqueezing_args(squeezing, maprange, wavelet,
                                       difftype, difforder, get_w,
                                       transform='cwt')
    check_batch(x.ndim, get_w)
    if nv is None and not isinstance(scales, np.ndarray):
        nv = 32
    N = x.shape[-1]
    dt, fs_, _ = _process_fs_and_t(fs, t, N)

    wavelet = resolve_wavelet(wavelet, l1_norm=True, N=N)
    dtype = device_dtype(wavelet.dtype)
    # gamma default: 10 * machine epsilon
    if gamma is None:
        gamma = 10 * (EPS64 if dtype == 'float64' else EPS32)
    gamma = float(gamma)

    plan, key = _ssq_cwt_plan(wavelet, N, scales, nv, ssq_freqs, maprange,
                              padtype is not None, dt)
    params = plan.params
    scales_t, const_t = _device_plan(key, plan.scales, plan.const, dtype,
                                     device)

    nbins = params['omax'] + 1
    xt = torch.as_tensor(x, dtype=getattr(torch, dtype), device=device)
    xt = torch.where(torch.isfinite(xt), xt, torch.zeros_like(xt))
    kernel = _public_route(wavelet, padded_length(N, padtype), xt, 2)
    fits = ssq_cuda.scatter_fits(nbins, 2 * xt.element_size())
    higher = isinstance(order, (tuple, list, range)) or order > 0
    dWx = None
    if higher:
        # the JAX package's compositional route: the higher-order CWT over
        # the whole padded window, its trigonometric derivative, the
        # unpadded slice
        _, n1p, _ = p2up(N)
        Wx, _ = cwt(xt, wavelet, scales=plan.scales, fs=fs_, nv=nv,
                    l1_norm=True, padtype=padtype, rpadded=True,
                    order=order,
                    average=isinstance(order, (tuple, list, range)),
                    device=device)
        dWx = trigdiff(Wx, fs_, rpadded=True, N=N, n1=n1p)
        # the orders' wavelets run in the default dtype (as the JAX
        # package builds them); the squeeze runs in the plan's
        cdt = torch.complex64 if dtype == 'float32' else torch.complex128
        Wx, dWx = Wx[..., n1p:n1p + N].to(cdt), dWx.to(cdt)
    elif kernel:
        xh, n_up, n1 = cwt_spectrum(xt, padtype, 2)
    else:
        xp, n_up, n1 = padded_signal(xt, padtype)

    def planes(n1_, N_):
        """(Wx, dWx) of columns [n1_, n1_ + N_) of the padded transform."""
        if kernel:
            return cwt_fused(xh, scales_t, wavelet, n_up, n1_, N_, dt, True,
                             True)
        return cwt_general(xp, wavelet, scales_t, n1_, N_, dt, True, True)

    w = None
    if difftype == 'numeric':
        if higher:
            Wx = Wx[..., n1p - 4:n1p + N + 4]
        else:
            # the whole padded planes, then JAX's window of p2up's left pad
            Wx, dWx = planes(0, n_up)
            _, n1p, _ = p2up(N)
            Wx = Wx[..., n1p - 4:n1p + N + 4]
        w = phase_cwt_num(Wx, dt, difforder, gamma)
        Tx = indexed_sum_onfly(_apply_squeezing(Wx, squeezing), w, None,
                               const_t, params=params, flipud=flipud,
                               device=device)
        Tx, Wx, w = (v[..., 4:-4].contiguous() for v in (Tx, Wx, w))
    elif get_w or ((get_dWx or higher or not kernel)
                   and squeezing != 'sum'):
        if not higher:
            Wx, dWx = planes(n1, N)
        w = phase_cwt(Wx, dWx if difftype == 'trig' else None, difftype,
                      gamma)
        Tx = indexed_sum_onfly(_apply_squeezing(Wx, squeezing), w, None,
                               const_t, params=params, flipud=flipud,
                               device=device)
        if not get_w:
            w = None
    elif get_dWx or higher or not kernel:
        if not higher:
            Wx, dWx = planes(n1, N)
        Wx, dWx = Wx.contiguous(), dWx.contiguous()
        Tx = (ssq_fused if fits else ssq_fused_general)(
            Wx, dWx, const_t, params, gamma, flipud)
    else:
        Wx, k = cwt_bins(xh, scales_t, wavelet, n_up, n1, N, dt, True,
                         params, gamma, flipud)
        Wx_s = _apply_squeezing(Wx, squeezing)
        Tx = (scatter_kv(Wx_s, k, const_t, nbins) if fits else
              scatter_general(Wx_s, k, k >= 0, nbins, const_t))
    if not get_Wx:
        Wx = None

    # for CWT, ssq_freqs are always returned reversed
    ssq_freqs_out = np.asarray(plan.ssq_freqs)[::-1].copy()
    scales_out = plan.scales.squeeze()
    if not astensor:
        Tx = Tx.cpu().numpy()
        Wx = Wx.cpu().numpy() if Wx is not None else None
        dWx = dWx.cpu().numpy() if dWx is not None else None
        w = w.cpu().numpy() if w is not None else None
    out = (Tx, Wx, ssq_freqs_out, scales_out)
    if get_w:
        out += (w,)
    if get_dWx:
        out += (dWx,)
    return out


def issq_cwt(Tx, wavelet='gmw', cc=None, cw=None):
    """Inverse synchrosqueezed CWT: full inversion
    ``x = Re(sum(Tx, axis=-2)) * 2/Css`` ((N,) from (nbins, N), (B, N)
    from a (B, nbins, N) batch) or masked per-component inversion. `Tx` a
    complex tensor (reduced on its device) or numpy array; returns
    numpy, or for the full inversion of a tensor that requires grad a
    tensor on its device carrying the graph."""
    cc, cw, full_inverse = _process_component_inversion_args(cc, cw)

    if full_inverse:
        if isinstance(Tx, torch.Tensor):
            x = numpy_unless_grad(Tx.real.sum(dim=-2))
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
