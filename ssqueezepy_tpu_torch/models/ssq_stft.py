# -*- coding: utf-8 -*-
"""Synchrosqueezed STFT (forward & inverse), first and second order.

Counterpart of `ssq_stft`/`issq_stft`/`ssq_stft2` in
`ssqueezepy_tpu/models/ssq_stft.py`. The host plan (window, derivative
window, Sfs, ssq frequency grid, squeeze constant, bin parameters) is
resolved once and memoized; the signal then runs pad -> `torch.fft.fft`
-> the STFT table kernel in bins mode (`ops/stft_cuda.py`, (Sx, k)) ->
the reassignment scatter (`ops/ssq_cuda.py`). With `hop_len > 1` or
`get_dWx=True` it runs `stft(..., derivative=True)` instead (the framed
path, or the table kernel's Sx + dSx mode at hop 1) -> the fused phase +
bins + scatter kernel (`ops/ssq_cuda.py::ssq_fused`) with the per-row
frequencies Sfs. `ssq_stft2` (FSST2) runs
the table kernel's FSST2 mode on the five tables of the windows g, g',
t g, t g', g'' instead. On a CUDA device the kernels are the hand-written
CUDA ones; with ``device='cpu'`` their plain PyTorch versions run.
"""
import collections

import numpy as np
import torch

from ..configs import default_dtype
from ..ops.ssq_cuda import scatter_kv, ssq_fused
from ..ops.ssq_kernels import ssq_bin_params
from ..ops.stft_conv import conv_bank, conv_table
from ..ops.stft_cuda import fsst2_conv, stft_conv
from ..utils.common import (WARN, EPS32, EPS64, not_ported, resolve_device)
from ..utils.cwt_utils import _process_fs_and_t, infer_scaletype
from .ssq_cwt import (_invert_components, _process_component_inversion_args,
                      _spec_key)
from .ssqueezing import _check_ssqueezing_args
from .stft import _as_signal, signal_spectrum, stft
from .windows import get_window, _check_NOLA

__all__ = ['ssq_stft', 'issq_stft', 'ssq_stft2']

# window, diff_window (numpy, length n_fft); Sfs (n_rows,) and ssq_freqs
# (nbins,) numpy; const: the squeeze constant; params: the 'lin' bin map
StftPlan = collections.namedtuple('StftPlan',
                                  'window diff_window Sfs ssq_freqs const '
                                  'params')
_PLANS = {}
_DEV_CACHE = {}
# bank (5, n_fft) float64 numpy: the FSST2 windows g, g', t g, t g', g''
Fsst2Plan = collections.namedtuple('Fsst2Plan',
                                   'bank Sfs ssq_freqs const params')
_PLANS2 = {}


def stft_plan(window, ssq_freqs, n_fft, win_len, fs, dtype):
    """Host `StftPlan`, memoized for string and array specs."""
    key = (_spec_key(window), _spec_key(ssq_freqs), n_fft, win_len,
           float(fs), dtype)
    if any(k is None and spec is not None
           for k, spec in zip(key, (window, ssq_freqs))):
        key = None                       # an uncacheable spec
    hit = _PLANS.get(key) if key is not None else None
    if hit is not None:
        return hit
    win, dwin = get_window(window, win_len, n_fft, derivative=True,
                           dtype=dtype)
    n_rows = n_fft // 2 + 1
    Sfs = np.linspace(0, .5 * fs, n_rows, dtype=dtype)
    if ssq_freqs is None:
        ssq_freqs = Sfs
    plan = StftPlan(win, dwin, Sfs, ssq_freqs,
                    float(ssq_freqs[1] - ssq_freqs[0]),
                    ssq_bin_params(ssq_freqs, logscale=False))
    if key is not None:
        _PLANS[key] = plan
    return plan


def _device_consts(plan, dtype, device):
    """(Sfs, const) as (n_rows,) tensors on `device`, memoized."""
    key = (hash(plan.Sfs.tobytes()), len(plan.Sfs), plan.const, dtype,
           str(device))
    hit = _DEV_CACHE.get(key)
    if hit is None:
        tdt = getattr(torch, dtype)
        n_rows = len(plan.Sfs)
        hit = _DEV_CACHE[key] = (
            torch.as_tensor(plan.Sfs, dtype=tdt, device=device),
            torch.full((n_rows,), plan.const, dtype=tdt, device=device))
    return hit


def _check_slice(ndim, squeezing, get_w):
    """Calls outside the ported slice raise, naming their ROADMAP item."""
    if ndim != 1:
        not_ported("ssq_stft of %d-D input" % ndim, 'A7b')
    if not isinstance(squeezing, str):
        not_ported("callable squeezing", 'A5b')
    if squeezing != 'sum':
        not_ported("squeezing=%r" % squeezing, 'A5b')
    if get_w:
        not_ported("ssq_stft with get_w=True", 'A5b')


def ssq_stft(x, window=None, n_fft=None, win_len=None, hop_len=1, fs=None,
             t=None, modulated=True, ssq_freqs=None, padtype='reflect',
             squeezing='sum', gamma=None, preserve_transform=None,
             dtype=None, astensor=True, flipud=False, get_w=False,
             get_dWx=False, device='cuda'):
    """Synchrosqueezed STFT of a 1-D signal.

    Returns (Tx, Sx, ssq_freqs, Sfs[, dSx]): Tx (nbins, n_segs) and Sx
    (n_fft//2 + 1, n_segs) complex tensors on `device` (numpy with
    `astensor=False`; n_segs = N at hop 1), ssq_freqs reversed if
    `flipud`, Sfs the STFT row frequencies, and dSx like Sx with
    `get_dWx=True`.
    `ssq_freqs` may be a user's linear grid (numpy). The scatter keeps a
    shared-memory accumulator of nbins rows per block, so on the card
    nbins is bounded (about 6400 in float32, half that in float64; it
    raises beyond)."""
    device = resolve_device(device)
    ndim = x.dim() if isinstance(x, torch.Tensor) else np.ndim(x)
    _check_ssqueezing_args(squeezing)
    _check_slice(ndim, squeezing, get_w)
    if isinstance(ssq_freqs, np.ndarray) and \
            infer_scaletype(ssq_freqs)[0] != 'linear':
        raise ValueError("`ssq_freqs` must be linearly distributed "
                         "for `ssq_stft`")
    N = x.shape[-1]
    _, fs_, _ = _process_fs_and_t(fs, t, N)
    n_fft = int(n_fft or min(N // hop_len, 512))
    if win_len is None:
        win_len = (len(window) if isinstance(window, np.ndarray) else n_fft)
    dtype = dtype or default_dtype()
    if gamma is None:
        gamma = 10 * (EPS64 if dtype == 'float64' else EPS32)

    plan = stft_plan(window, ssq_freqs, n_fft, win_len, fs_, dtype)
    _check_NOLA(plan.window, hop_len, dtype)
    Sfs_t, const_t = _device_consts(plan, dtype, device)

    dSx = None
    if int(hop_len) != 1 or get_dWx:
        Sx, dSx = stft(x, window, n_fft, win_len, hop_len, fs, t, padtype,
                       modulated, derivative=True, dtype=dtype,
                       device=device)
        Sx, dSx = Sx.contiguous(), dSx.contiguous()
        Tx = ssq_fused(Sx, dSx, const_t, plan.params, float(gamma),
                       bool(flipud), Sfs_t)
    else:
        xh = signal_spectrum(_as_signal(x, dtype, device), n_fft, padtype)
        Np2 = xh.shape[0]
        H = conv_table(plan.window, n_fft, Np2, modulated, dtype, device)
        Hd = conv_table(plan.diff_window, n_fft, Np2, modulated, dtype,
                        device)
        bins = dict(Sfs=Sfs_t, params=plan.params, gamma=float(gamma),
                    flipud=bool(flipud))
        Sx, k = stft_conv(xh, H, Hd, N, float(fs_), bins)
        Tx = scatter_kv(Sx, k, const_t, plan.params['omax'] + 1)

    ssq_freqs_out = (np.asarray(plan.ssq_freqs)[::-1].copy() if flipud
                     else np.asarray(plan.ssq_freqs))
    if not astensor:
        Tx, Sx = Tx.cpu().numpy(), Sx.cpu().numpy()
        dSx = dSx.cpu().numpy() if dSx is not None else None
    if get_dWx:
        return Tx, Sx, ssq_freqs_out, plan.Sfs, dSx
    return Tx, Sx, ssq_freqs_out, plan.Sfs


def issq_stft(Tx, window=None, cc=None, cw=None, n_fft=None, win_len=None,
              hop_len=1, modulated=True):
    """Inverse synchrosqueezed STFT:
    ``x = Re(sum(Tx, axis=0)) * 2 / window[n_fft // 2]``, or per component
    with `cc`, `cw` (as `issq_cwt`). `Tx` a complex tensor (reduced on its
    device) or numpy array; returns numpy."""
    if not modulated:
        raise ValueError("inversion with `modulated == False` is "
                         "unsupported.")
    if hop_len != 1:
        raise ValueError("inversion with `hop_len != 1` is unsupported.")
    cc, cw, full_inverse = _process_component_inversion_args(cc, cw)
    n_fft = int(n_fft or (Tx.shape[0] - 1) * 2)
    win_len = win_len or n_fft
    window = get_window(window, win_len, n_fft=n_fft)
    _check_NOLA(window, hop_len)
    if abs(np.argmax(window) - len(window) // 2) > 1:
        WARN("`window` maximum not centered; results may be inaccurate.")

    if not full_inverse:
        x = _invert_components(Tx, cc, cw)
    elif isinstance(Tx, torch.Tensor):
        x = Tx.real.sum(dim=0).cpu().numpy()
    else:
        x = np.asarray(Tx).real.sum(axis=0)
    return x * (2 / window[len(window) // 2])


def _fsst2_bank(window, win_len, n_fft, dtype):
    """The five FSST2 analysis windows (g, g', t g, t g', g'') as a
    (5, n_fft) float64 bank; t counts samples from the window's centre
    n_fft // 2."""
    g, dg = get_window(window, win_len, n_fft, derivative=True, dtype=dtype)
    _, d2g = get_window(dg, n_fft, n_fft, derivative=True, dtype=dtype)
    nc = (np.arange(n_fft) - n_fft // 2).astype(np.float64)
    g, dg = np.asarray(g, np.float64), np.asarray(dg, np.float64)
    return np.stack([g, dg, nc * g, nc * dg, np.asarray(d2g, np.float64)])


def fsst2_plan(window, ssq_freqs, n_fft, win_len, fs, dtype):
    """Host `Fsst2Plan`, memoized for string and array specs."""
    key = (_spec_key(window), _spec_key(ssq_freqs), n_fft, win_len,
           float(fs), dtype)
    if any(k is None and spec is not None
           for k, spec in zip(key, (window, ssq_freqs))):
        key = None                       # an uncacheable spec
    hit = _PLANS2.get(key) if key is not None else None
    if hit is not None:
        return hit
    base = stft_plan(window, ssq_freqs, n_fft, win_len, fs, dtype)
    plan = Fsst2Plan(_fsst2_bank(window, win_len, n_fft, dtype), base.Sfs,
                     base.ssq_freqs, base.const, base.params)
    if key is not None:
        _PLANS2[key] = plan
    return plan


def ssq_stft2(x, window=None, n_fft=None, win_len=None, fs=None, t=None,
              modulated=True, ssq_freqs=None, padtype='reflect',
              squeezing='sum', gamma=None, dtype=None, astensor=True,
              flipud=False, get_w=False, device='cuda'):
    """Second-order synchrosqueezed STFT (FSST2) of a 1-D signal, hop 1.

    First-order reassignment estimates w1 = Sfs - Im(V^g' / V) / 2pi; FSST2
    adds the chirp-rate correction (fs / 2pi) q Re(V^tg / V), q =
    Im((V^g'' V - (V^g')^2) / (V^tg' V - V^tg V^g')), exact on linear
    chirps. Returns (Tx, Sx, ssq_freqs, Sfs) as `ssq_stft` does. Inversion
    is `issq_stft`."""
    device = resolve_device(device)
    ndim = x.dim() if isinstance(x, torch.Tensor) else np.ndim(x)
    _check_ssqueezing_args(squeezing)
    if not isinstance(squeezing, str):
        not_ported("callable squeezing", 'A5b')
    if squeezing != 'sum':
        not_ported("squeezing=%r" % squeezing, 'A5b')
    if get_w:
        not_ported("ssq_stft2 with get_w=True", 'A8b')
    if ndim != 1:
        not_ported("ssq_stft2 of %d-D input" % ndim, 'A8b')
    if isinstance(ssq_freqs, np.ndarray) and \
            infer_scaletype(ssq_freqs)[0] != 'linear':
        raise ValueError("`ssq_freqs` must be linearly distributed "
                         "for `ssq_stft2`")
    N = x.shape[-1]
    _, fs_, _ = _process_fs_and_t(fs, t, N)
    n_fft = int(n_fft or min(N, 512))
    if win_len is None:
        win_len = (len(window) if isinstance(window, np.ndarray) else n_fft)
    dtype = dtype or default_dtype()
    if gamma is None:
        gamma = 10 * (EPS64 if dtype == 'float64' else EPS32)

    plan = fsst2_plan(window, ssq_freqs, n_fft, win_len, fs_, dtype)
    Sfs_t, const_t = _device_consts(plan, dtype, device)

    xh = signal_spectrum(_as_signal(x, dtype, device), n_fft, padtype)
    tables = conv_bank(plan.bank, n_fft, xh.shape[0], modulated, dtype,
                       device)
    bins = dict(Sfs=Sfs_t, params=plan.params, gamma=float(gamma),
                flipud=bool(flipud))
    Sx, k = fsst2_conv(xh, tables, N, float(fs_), bins)
    Tx = scatter_kv(Sx, k, const_t, plan.params['omax'] + 1)

    ssq_freqs_out = (np.asarray(plan.ssq_freqs)[::-1].copy() if flipud
                     else np.asarray(plan.ssq_freqs))
    if not astensor:
        Tx, Sx = Tx.cpu().numpy(), Sx.cpu().numpy()
    return Tx, Sx, ssq_freqs_out, plan.Sfs
