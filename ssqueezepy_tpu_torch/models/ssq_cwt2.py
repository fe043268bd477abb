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
with `padtype=None`, n_up = N, whose prime factors must then be at most
7) -> real FFT (torch.fft) -> the WSST2 kernel
(`ops/cwt_cuda.py::cwt_bins2`, W and the bins of w2) ->
`_apply_squeezing` on W -> the reassignment scatter (`ops/ssq_cuda.py`).
With `get_w=True` (one signal) the kernel's w2 mode (`cwt_w2`, W and w2)
runs instead, then `_apply_squeezing` on W -> the generic scatter by the
bins of w2 (`ops/ssq_kernels.py::indexed_sum_onfly`), as the JAX
package's XLA path runs it, and w2 is returned. A (B, N) batch runs each
kernel once over the batch. Inversion is `issq_cwt`: reassignment only
moves energy within a column.
"""
import numpy as np
import torch

from ..configs import device_dtype
from ..ops.cwt_cuda import cwt_bins2, cwt_w2
from ..ops.ssq_cuda import scatter_kv, scatter_rule
from ..ops.ssq_kernels import indexed_sum_onfly
from ..utils.common import (EPS32, EPS64, check_batch, not_ported,
                            resolve_device)
from ..utils.cwt_utils import _process_fs_and_t
from .cwt import cwt_spectrum, resolve_wavelet, _is_analytic
from .ssq_cwt import _ssq_cwt_plan, _device_plan
from .ssqueezing import _apply_squeezing, _check_ssqueezing_args
from .stft import _as_signal

__all__ = ['ssq_cwt2']


def _check_slice(wavelet):
    """Calls outside the ported slice raise, naming their ROADMAP item."""
    if not _is_analytic(wavelet):
        not_ported("ssq_cwt2 with a non-GMW wavelet", 'A2b')


def ssq_cwt2(x, wavelet='gmw', scales='log-piecewise', nv=None, fs=None,
             t=None, ssq_freqs=None, padtype='reflect', squeezing='sum',
             maprange='peak', gamma=None, astensor=True, flipud=True,
             get_w=False, device='cuda'):
    """Second-order synchrosqueezed CWT of a signal (N,) or a batch of
    signals (B, N) (GMW, L1 norm).

    Returns (Tx, Wx, ssq_freqs, scales[, w2]) as `ssq_cwt` does: Tx
    (nbins, N) and Wx (na, N), with a leading B for a batch, complex
    tensors on `device` (numpy with `astensor=False`), ssq_freqs
    reversed, scales (na,), and with `get_w=True` (one signal, as in the
    JAX package) the chirp-corrected frequency w2 (na, N) real, inf on
    dropped cells. `squeezing` is 'sum', 'lebesgue', 'abs' or a function
    of W. `padtype=None` transforms the signal unpadded."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    check_batch(x.ndim, get_w)
    device = resolve_device(device)
    _check_ssqueezing_args(squeezing, maprange, wavelet, 'trig', None,
                           get_w, transform='cwt')
    N = x.shape[-1]
    wavelet = resolve_wavelet(wavelet, l1_norm=True, N=N)
    _check_slice(wavelet)
    if nv is None and not isinstance(scales, np.ndarray):
        nv = 32
    dt, _, _ = _process_fs_and_t(fs, t, N)
    dtype = device_dtype(wavelet.dtype)
    if gamma is None:
        gamma = 10 * (EPS64 if dtype == 'float64' else EPS32)

    plan, key = _ssq_cwt_plan(wavelet, N, scales, nv, ssq_freqs, maprange,
                              padtype is not None, dt)
    params = plan.params
    scales_t, const_t = _device_plan(key, plan.scales, plan.const, dtype,
                                     device)

    nbins = params['omax'] + 1
    scatter_rule(nbins, 2 * np.dtype(dtype).itemsize)
    xh, n_up, n1 = cwt_spectrum(_as_signal(x, dtype, device), padtype, 5)
    if get_w:
        Wx, w2 = cwt_w2(xh, scales_t, wavelet, n_up, n1, N, dt,
                        float(gamma))
        Tx = indexed_sum_onfly(_apply_squeezing(Wx, squeezing), w2, None,
                               const_t, params=params, flipud=flipud,
                               device=device)
    else:
        Wx, k = cwt_bins2(xh, scales_t, wavelet, n_up, n1, N, dt, params,
                          float(gamma), flipud)
        Tx = scatter_kv(_apply_squeezing(Wx, squeezing), k, const_t, nbins)

    ssq_freqs_out = np.asarray(plan.ssq_freqs)[::-1].copy()
    scales_out = plan.scales.squeeze()
    if not astensor:
        Tx, Wx = Tx.cpu().numpy(), Wx.cpu().numpy()
    if get_w:
        return Tx, Wx, ssq_freqs_out, scales_out, (
            w2.cpu().numpy() if not astensor else w2)
    return Tx, Wx, ssq_freqs_out, scales_out
