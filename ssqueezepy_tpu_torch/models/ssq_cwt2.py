# -*- coding: utf-8 -*-
"""Second-order synchrosqueezed CWT (WSST2).

Counterpart of `ssqueezepy_tpu/models/ssq_cwt2.py`. First-order
reassignment estimates the instantaneous frequency as Im(dWx/Wx)/2pi,
biased on modulated components; WSST2 fits a local complex linear chirp
per cell from five wavelet transforms (W, A = x' * h, B = x * th,
Bd = x' * th, C = x * t^2 h), solves p2 = (Bd W - A B) / (B^2 - C W),
p1 = (A + p2 B) / W and reassigns by w2 = |Im p1| / (2 pi dt), exact on
linear chirps. The plan (scales, ssq frequency grid, squeeze constant,
bin map) is `ssq_cwt`'s, memoized with it; the signal runs pad (none
with `padtype=None`, n_up = N) -> real FFT (torch.fft) -> the WSST2 kernel
(`ops/cwt_cuda.py::cwt_bins2`, W and the bins of w2) ->
`_apply_squeezing` on W -> the reassignment scatter (`ops/ssq_cuda.py`).
With `get_w=True` (one signal) the kernel's w2 mode (`cwt_w2`, W and w2)
runs instead, then `_apply_squeezing` on W -> the generic scatter by the
bins of w2 (`ops/ssq_kernels.py::indexed_sum_onfly`), as the JAX
package's XLA path runs it, and w2 is returned. A (B, N) batch runs each
kernel once over the batch. At a padded length with a prime factor above
7 (`padtype=None` at an N such as 1031; `ops/cwt_cuda.py::kernel_length`)
or past the kernel's rule for five planes (`ops/cwt_cuda.py::
cwt_kernel_fits`; n_up beyond 2^22 in float64), decided before anything
runs, the general route `wsst2_general` runs in the kernel's place: the
JAX package's XLA branch `_wsst2_rows`, by torch.fft (`ops/cwt_cuda.py::
wsst2_rows`) in row blocks of at most 2 GiB per intermediate
(`utils/common.py::row_blocks`), then `_apply_squeezing` on W and the
generic scatter by the bins of w2, for one signal or a batch, with or
without `get_w`. Bins past the reassignment kernels' rule
(`ops/ssq_cuda.py::scatter_fits`) take `ops/ssq_kernels.py::
scatter_general` in the scatter's place. Every wavelet that the JAX
package's `_supports_order2` accepts runs there: an analytic wavelet, or
one whose spectrum is below 1e-12 on [-20, 0] (morlet, a user's
callable), with a real-valued spectrum that torch autograd differentiates
twice; the order-0 GMW is synthesized in the kernel, any other wavelet
read from its three-plane table (`ops/cwt_cuda.py::wavelet_table`). Another raises with
the JAX package's message. Inversion is `issq_cwt`: reassignment only
moves energy within a column.
"""
import numpy as np
import torch

from ..configs import device_dtype
from ..ops import cwt_cuda, ssq_cuda
from ..ops.cwt_cuda import cwt_bins2, cwt_w2, wsst2_rows, _wavelet_derivatives
from ..ops.fft import rfft
from ..ops.ssq_cuda import scatter_kv
from ..ops.ssq_kernels import indexed_sum_onfly, scatter_general
from ..utils.common import (EPS32, EPS64, check_batch, resolve_device,
                            row_blocks)
from ..utils.cwt_utils import _process_fs_and_t
from .cwt import (cwt_spectrum, padded_length, padded_signal,
                  resolve_wavelet, _is_analytic, _is_custom, _wavelet_key)
from .ssq_cwt import _ssq_cwt_plan, _device_plan
from .ssqueezing import _apply_squeezing, _check_ssqueezing_args
from .stft import _as_signal

__all__ = ['ssq_cwt2', 'wsst2_general', 'wsst2_tx']


_SUPPORTS2 = {}


def _supports_order2(wavelet, dtype):
    """(ok, why): ssq_cwt2 needs an analytic wavelet (or one whose
    spectrum is below 1e-12 on [-20, 0]: the half-grid transform is then
    exact in float32 and float64) with a real-valued spectrum that torch
    autograd differentiates twice; the JAX package's gate, memoized per
    (wavelet, dtype) for this package's wavelets, probed anew per call
    for a user's callable (`models/cwt.py::_wavelet_key`)."""
    if _is_custom(wavelet):
        return _supports_order2_probe(wavelet, dtype)
    key = (_wavelet_key(wavelet), dtype)
    hit = _SUPPORTS2.get(key)
    if hit is None:
        hit = _SUPPORTS2[key] = _supports_order2_probe(wavelet, dtype)
    return hit


def _supports_order2_probe(wavelet, dtype):
    if not _is_analytic(wavelet):
        try:
            neg = wavelet.fn(np.linspace(-20., 0., 64), xp=np)
            if (isinstance(neg, tuple)
                    or np.abs(np.asarray(neg)).max() > 1e-12):
                return False, "requires an analytic wavelet"
        except Exception:
            return False, "requires an analytic wavelet"
    try:
        w = torch.ones(2, dtype=getattr(torch, dtype))
        probe = wavelet.fn(w, xp=torch)
        if isinstance(probe, tuple) or probe.is_complex():
            return False, "requires a real-valued spectral fn"
        _wavelet_derivatives(wavelet.fn, w)
    except Exception as e:
        return False, "spectral fn not differentiable (%s)" % e
    return True, None


def wsst2_general(xt, padtype, scales, wavelet, N, dt, gamma):
    """(W, w2) of the real signal or (B, N) batch `xt` off the WSST2
    kernel's lengths: padded by `padtype` (none for None), its half
    spectrum by `torch.fft.rfft`, then the torch WSST2 rows
    (`ops/cwt_cuda.py::wsst2_rows`, the JAX package's `_wsst2_rows`) on
    xt's device at any n_up, its scales in row blocks that keep the five
    banks within 2 GiB (`utils/common.py::row_blocks`; each row is
    computed as in one block, its wavelet table with it). Counts its
    calls on `wsst2_general.calls`."""
    wsst2_general.calls += 1
    xp, n_up, n1 = padded_signal(xt, padtype)
    xh = rfft(xp)
    W = torch.empty(xt.shape[:-1] + (len(scales), N), dtype=xh.dtype,
                    device=xt.device)
    w2 = torch.empty(W.shape, dtype=xt.dtype, device=xt.device)
    for lo, hi in row_blocks(len(scales), 5 * xh[..., :1].numel() * n_up
                             * xh.element_size()):
        W[..., lo:hi, :], w2[..., lo:hi, :] = wsst2_rows(
            xh, scales[lo:hi], wavelet, n_up, n1, N, dt, gamma)
    return W, w2


wsst2_general.calls = 0


def wsst2_tx(xt, padtype, scales, wavelet, N, dt, gamma, params, flipud,
             squeeze, const, get_w=False):
    """(Tx, W, w2) of the real signal or (B, N) batch `xt`, on the route
    its padded length takes (decided before anything runs): a 7-smooth
    n_up that fits the kernel's rule for five planes runs the WSST2
    kernel, in its bins mode then the reassignment scatter on
    `squeeze(W)` (`scatter_general` past the scatters' rule), or with
    `get_w` in its w2 mode; any other n_up runs `wsst2_general`. w2 then
    feeds the generic scatter by its bins; it is None on the bins
    mode."""
    nbins = params['omax'] + 1
    if not cwt_cuda.cwt_kernel_fits(padded_length(N, padtype),
                                    2 * xt.element_size(), 5):
        W, w2 = wsst2_general(xt, padtype, scales, wavelet, N, dt, gamma)
    else:
        xh, n_up, n1 = cwt_spectrum(xt, padtype, 5)
        if not get_w:
            W, k = cwt_bins2(xh, scales, wavelet, n_up, n1, N, dt, params,
                             gamma, flipud)
            if ssq_cuda.scatter_fits(nbins, W.element_size()):
                return scatter_kv(squeeze(W), k, const, nbins), W, None
            return scatter_general(squeeze(W), k, k >= 0, nbins,
                                   const), W, None
        W, w2 = cwt_w2(xh, scales, wavelet, n_up, n1, N, dt, gamma)
    Tx = indexed_sum_onfly(squeeze(W), w2, None, const, params=params,
                           flipud=flipud, device=xt.device)
    return Tx, W, w2


def ssq_cwt2(x, wavelet='gmw', scales='log-piecewise', nv=None, fs=None,
             t=None, ssq_freqs=None, padtype='reflect', squeezing='sum',
             maprange='peak', gamma=None, astensor=True, flipud=True,
             get_w=False, device='cuda'):
    """Second-order synchrosqueezed CWT of a signal (N,) or a batch of
    signals (B, N) (L1 norm), for any wavelet `_supports_order2` takes.

    Returns (Tx, Wx, ssq_freqs, scales[, w2]) as `ssq_cwt` does: Tx
    (nbins, N) and Wx (na, N), with a leading B for a batch, complex
    tensors on `device` (numpy with `astensor=False`), ssq_freqs
    reversed, scales (na,), and with `get_w=True` (one signal, as in the
    JAX package) the chirp-corrected frequency w2 (na, N) real, inf on
    dropped cells. `squeezing` is 'sum', 'lebesgue', 'abs' or a function
    of W. `padtype=None` transforms the signal unpadded (an N with a
    prime factor above 7 takes `wsst2_general`)."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    check_batch(x.ndim, get_w)
    device = resolve_device(device)
    _check_ssqueezing_args(squeezing, maprange, wavelet, 'trig', None,
                           get_w, transform='cwt')
    N = x.shape[-1]
    wavelet = resolve_wavelet(wavelet, l1_norm=True, N=N)
    if nv is None and not isinstance(scales, np.ndarray):
        nv = 32
    dt, _, _ = _process_fs_and_t(fs, t, N)
    dtype = device_dtype(wavelet.dtype)
    ok, why = _supports_order2(wavelet, dtype)
    if not ok:
        raise NotImplementedError("ssq_cwt2 %s (got %r)"
                                  % (why, getattr(wavelet.fn, 'qualname',
                                                  wavelet.fn)))
    if gamma is None:
        gamma = 10 * (EPS64 if dtype == 'float64' else EPS32)

    plan, key = _ssq_cwt_plan(wavelet, N, scales, nv, ssq_freqs, maprange,
                              padtype is not None, dt)
    params = plan.params
    scales_t, const_t = _device_plan(key, plan.scales, plan.const, dtype,
                                     device)

    Tx, Wx, w2 = wsst2_tx(
        _as_signal(x, dtype, device), padtype, scales_t, wavelet, N, dt,
        float(gamma), params, flipud,
        lambda W: _apply_squeezing(W, squeezing), const_t, get_w)

    ssq_freqs_out = np.asarray(plan.ssq_freqs)[::-1].copy()
    scales_out = plan.scales.squeeze()
    if not astensor:
        Tx, Wx = Tx.cpu().numpy(), Wx.cpu().numpy()
    if get_w:
        return Tx, Wx, ssq_freqs_out, scales_out, (
            w2.cpu().numpy() if not astensor else w2)
    return Tx, Wx, ssq_freqs_out, scales_out
