# -*- coding: utf-8 -*-
"""Synchrosqueezed STFT (forward & inverse), first and second order.

Counterpart of `ssq_stft`/`issq_stft`/`ssq_stft2` in
`ssqueezepy_tpu/models/ssq_stft.py`. The host plan (window, derivative
window, Sfs, ssq frequency grid, squeeze constant, bin parameters) is
resolved once and memoized; the signal then runs pad -> `torch.fft.fft`
-> the STFT table kernel in bins mode (`ops/stft_cuda.py`, (Sx, k)) ->
the reassignment scatter (`ops/ssq_cuda.py`), the scattered values
squeezed by `_apply_squeezing`. With `hop_len > 1`, `get_dWx=True` or
`get_w=True` it runs `stft(..., derivative=True)` instead (the framed
path, or the table kernel's Sx + dSx mode at hop 1) -> with 'sum'
squeezing the fused phase + bins + scatter kernel
(`ops/ssq_cuda.py::ssq_fused`) with the per-row frequencies Sfs;
otherwise, or with `get_w`, the phase transform (`ops/phase.py::
phase_stft`) -> `_apply_squeezing` -> the generic scatter
(`ops/ssq_kernels.py::indexed_sum_onfly`). `ssq_stft2` (FSST2) runs the
table kernel's FSST2 mode on the five tables of the windows g, g', t g,
t g', g'' instead, then the same squeezing and scatter; with `get_w` its
w2 mode (`fsst2_w`, V and w2), then the squeezing and the generic
scatter by the bins of w2, as the JAX package's XLA path runs it. A
(B, N) batch runs every kernel once over the batch (its rows b * n_rows
+ i in the table kernel, a batch axis in the scatters). On a CUDA device
the kernels are the hand-written CUDA ones; with ``device='cpu'`` their
plain PyTorch versions run.

Both decide on every device, before the transform, whether the kernels
take the call: the bins must fit the scatters' rule (`ops/ssq_cuda.py::
scatter_fits`) and, at hop 1, the transform length the table kernel's
(`models/stft.py::stft_kernel_route`). At hop 1 past either, the STFT
runs on the general route: `models/stft.py::stft_general` (Sx, dSx) for
`ssq_stft`, fed to the reassignment of its hop > 1 route, and
`fsst2_general` (the torch FSST2 rows on the bank, block by block) for
`ssq_stft2`, then the bin map of w2 and the generic scatter. (An STFT
with more bins than the scatters take, n_fft beyond ~51200, has window
tables of 25601 x 51200 complex elements and more, which the kernel's
route holds whole; the general route builds them per row block.) Bins
past the scatters' rule take `ops/ssq_kernels.py::scatter_general` in
the scatter's place (after the torch phase transform and bin map in
B4's: `ssq_fused_general`).
"""
import collections

import numpy as np
import torch

from ..configs import default_dtype
from ..ops.phase import phase_stft
from ..ops import ssq_cuda
from ..ops.ssq_cuda import scatter_kv, ssq_fused
from ..ops.ssq_kernels import (indexed_sum_onfly, ssq_bin_params,
                               ssq_fused_general)
from ..ops.stft_conv import fsst2_tables, stft_tables, table_rows
from ..ops.stft_cuda import fsst2_conv, fsst2_rows, fsst2_w, stft_conv
from ..utils.common import (WARN, EPS32, EPS64, check_batch,
                            numpy_unless_grad, resolve_device, row_blocks)
from ..utils.cwt_utils import _process_fs_and_t, infer_scaletype
from .ssq_cwt import (_invert_components, _process_component_inversion_args,
                      _spec_key)
from .ssqueezing import _apply_squeezing, _check_ssqueezing_args
from .stft import (_as_signal, _general_spectrum, signal_spectrum, stft,
                   stft_general, stft_kernel_route)
from .windows import get_window, _check_NOLA

__all__ = ['ssq_stft', 'issq_stft', 'ssq_stft2', 'fsst2_general']

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


def squeeze_planes(Sx, dSx, Sfs, const, params, gamma, flipud, squeezing,
                   squeeze, fits):
    """Tx of the hop-1 planes (Sx, dSx) on the general route, as `ssq_stft`
    reassigns them there: 'sum' by B4 (`ssq_fused`, or
    `ssq_fused_general` past the scatters' rule, `fits` False), any
    other squeezing by the phase transform and the generic scatter of
    `squeeze(Sx)`. The sharded and streaming plans call it on their rows
    or window."""
    if squeezing == 'sum':
        return (ssq_fused if fits else ssq_fused_general)(
            Sx, dSx, const, params, gamma, flipud, Sfs)
    w = phase_stft(Sx, dSx, Sfs, gamma)
    return indexed_sum_onfly(squeeze(Sx), w, None, const, params=params,
                             flipud=flipud, device=Sx.device)


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


def ssq_stft(x, window=None, n_fft=None, win_len=None, hop_len=1, fs=None,
             t=None, modulated=True, ssq_freqs=None, padtype='reflect',
             squeezing='sum', gamma=None, preserve_transform=None,
             dtype=None, astensor=True, flipud=False, get_w=False,
             get_dWx=False, device='cuda'):
    """Synchrosqueezed STFT of a signal (N,) or a batch of signals
    (B, N).

    Returns (Tx, Sx, ssq_freqs, Sfs[, w][, dSx]): Tx (nbins, n_segs) and
    Sx (n_fft//2 + 1, n_segs), with a leading B for a batch, complex
    tensors on `device` (numpy with
    `astensor=False`; n_segs = N at hop 1), ssq_freqs reversed if
    `flipud`, Sfs the STFT row frequencies, the phase transform w like Sx
    but real with `get_w=True` (one signal only, as in the JAX package),
    and dSx like Sx with `get_dWx=True`.
    `squeezing` is 'sum', 'lebesgue', 'abs' or a function of Sx.
    `ssq_freqs` may be a user's linear grid (numpy). The scatter keeps a
    shared-memory accumulator of nbins rows per block (25600 in float32,
    12800 in float64: n_fft up to ~51200 or ~25600), and at hop 1 the
    table kernel takes transform lengths N + n_fft - 1 up to 2^22; past
    either the call runs on the general route (module docstring)."""
    ndim = x.dim() if isinstance(x, torch.Tensor) else np.ndim(x)
    check_batch(ndim, get_w)
    device = resolve_device(device)
    _check_ssqueezing_args(squeezing)
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

    dSx = w = None
    nbins = plan.params['omax'] + 1
    fits = ssq_cuda.scatter_fits(nbins, 2 * np.dtype(dtype).itemsize)
    hop1 = int(hop_len) == 1
    general = hop1 and not (fits and stft_kernel_route(N, n_fft, dtype, 2))
    if general or not hop1 or get_dWx or get_w:
        if general:
            Sx, dSx = stft_general(_as_signal(x, dtype, device),
                                   [plan.window, plan.diff_window], n_fft,
                                   padtype, modulated)
            dSx.mul_(fs_)
        else:
            Sx, dSx = stft(x, window, n_fft, win_len, hop_len, fs, t,
                           padtype, modulated, derivative=True,
                           dtype=dtype, device=device)
        Sx, dSx = Sx.contiguous(), dSx.contiguous()
        if get_w or squeezing != 'sum':
            w = phase_stft(Sx, dSx, Sfs_t, gamma)
            Tx = indexed_sum_onfly(_apply_squeezing(Sx, squeezing), w, None,
                                   const_t, params=plan.params,
                                   flipud=flipud, device=device)
        else:
            Tx = (ssq_fused if fits else ssq_fused_general)(
                Sx, dSx, const_t, plan.params, float(gamma), bool(flipud),
                Sfs_t)
    else:
        xh = signal_spectrum(_as_signal(x, dtype, device), n_fft, padtype,
                             2)
        Np2 = xh.shape[-1]
        H, Hd = stft_tables(plan.window, plan.diff_window, n_fft, Np2,
                            modulated, dtype, device)
        bins = dict(Sfs=Sfs_t, params=plan.params, gamma=float(gamma),
                    flipud=bool(flipud))
        Sx, k = stft_conv(xh, H, Hd, N, float(fs_), bins)
        Tx = scatter_kv(_apply_squeezing(Sx, squeezing), k, const_t, nbins)

    ssq_freqs_out = (np.asarray(plan.ssq_freqs)[::-1].copy() if flipud
                     else np.asarray(plan.ssq_freqs))
    if not astensor:
        Tx, Sx = Tx.cpu().numpy(), Sx.cpu().numpy()
        dSx = dSx.cpu().numpy() if dSx is not None else None
        w = w.cpu().numpy() if w is not None else None
    out = (Tx, Sx, ssq_freqs_out, plan.Sfs)
    if get_w:
        out += (w,)
    if get_dWx:
        out += (dSx,)
    return out


def issq_stft(Tx, window=None, cc=None, cw=None, n_fft=None, win_len=None,
              hop_len=1, modulated=True):
    """Inverse synchrosqueezed STFT:
    ``x = Re(sum(Tx, axis=0)) * 2 / window[n_fft // 2]``, or per component
    with `cc`, `cw` (as `issq_cwt`). `Tx` a complex tensor (reduced on its
    device) or numpy array; returns numpy, or for the full inversion of
    a tensor that requires grad a tensor on its device carrying the
    graph."""
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
        x = numpy_unless_grad(Tx.real.sum(dim=0))
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
    """Second-order synchrosqueezed STFT (FSST2) of a signal (N,) or a
    batch of signals (B, N), hop 1.

    First-order reassignment estimates w1 = Sfs - Im(V^g' / V) / 2pi; FSST2
    adds the chirp-rate correction (fs / 2pi) q Re(V^tg / V), q =
    Im((V^g'' V - (V^g')^2) / (V^tg' V - V^tg V^g')), exact on linear
    chirps. `squeezing` as `ssq_stft` takes it. Returns (Tx, Sx, ssq_freqs,
    Sfs[, w2]) as `ssq_stft` does, with `get_w=True` (one signal or a
    batch, as in the JAX package) the chirp-corrected frequency w2 like Sx
    but real, inf on dropped cells. Inversion is `issq_stft`."""
    device = resolve_device(device)
    ndim = x.dim() if isinstance(x, torch.Tensor) else np.ndim(x)
    _check_ssqueezing_args(squeezing)
    check_batch(ndim)
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
    nbins = plan.params['omax'] + 1
    xt = _as_signal(x, dtype, device)
    if not (ssq_cuda.scatter_fits(nbins, 2 * xt.element_size())
            and stft_kernel_route(N, n_fft, dtype, 5)):
        Sx, w2 = fsst2_general(xt, plan.bank, n_fft, padtype, modulated,
                               float(fs_), Sfs_t, float(gamma))
        Tx = indexed_sum_onfly(_apply_squeezing(Sx, squeezing), w2, None,
                               const_t, params=plan.params, flipud=flipud,
                               device=device)
        return _ssq_stft2_out(Tx, Sx, w2, plan, flipud, astensor, get_w)

    xh = signal_spectrum(xt, n_fft, padtype, 5)
    tables = fsst2_tables(plan.bank, n_fft, xh.shape[-1], modulated, dtype,
                          device)
    if get_w:
        Sx, w2 = fsst2_w(xh, tables, N, float(fs_), Sfs_t, float(gamma))
        Tx = indexed_sum_onfly(_apply_squeezing(Sx, squeezing), w2, None,
                               const_t, params=plan.params, flipud=flipud,
                               device=device)
    else:
        bins = dict(Sfs=Sfs_t, params=plan.params, gamma=float(gamma),
                    flipud=bool(flipud))
        Sx, k = fsst2_conv(xh, tables, N, float(fs_), bins)
        Tx = scatter_kv(_apply_squeezing(Sx, squeezing), k, const_t, nbins)
        w2 = None
    return _ssq_stft2_out(Tx, Sx, w2, plan, flipud, astensor, get_w)


def _ssq_stft2_out(Tx, Sx, w2, plan, flipud, astensor, get_w):
    """`ssq_stft2`'s outputs: (Tx, Sx, ssq_freqs, Sfs[, w2]), numpy
    without `astensor`."""
    ssq_freqs_out = (np.asarray(plan.ssq_freqs)[::-1].copy() if flipud
                     else np.asarray(plan.ssq_freqs))
    if not astensor:
        Tx, Sx = Tx.cpu().numpy(), Sx.cpu().numpy()
    if get_w:
        return Tx, Sx, ssq_freqs_out, plan.Sfs, (
            w2.cpu().numpy() if not astensor else w2)
    return Tx, Sx, ssq_freqs_out, plan.Sfs


def fsst2_general(xt, bank, n_fft, padtype, modulated, fs, Sfs, gamma,
                  rows=None, padded=False):
    """(V, w2) of the second-order STFT of the real signal or (B, N)
    batch `xt`, hop 1, for transform lengths or bins past the kernels'
    rules: the JAX package's XLA branch (`_fsst2_rows` after its full
    bank of tables) on torch ops. The spectrum of the signal padded to
    N + n_fft - 1 at `next_fft_len` of that, then per block of rows the
    five windows' full tables (`ops/stft_conv.py::table_rows`, built on
    xt's device per block) and the FSST2 rows of `ops/stft_cuda.py::
    fsst2_rows` with the block's `Sfs` (all n_fft//2 + 1 rows' on xt's
    device); row blocks keep each intermediate within 2 GiB
    (`utils/common.py::row_blocks`). `rows` and `padded` as
    `models/stft.py::stft_general` takes them. Counts its calls on
    `fsst2_general.calls`."""
    fsst2_general.calls += 1
    xh, N = _general_spectrum(xt, n_fft, padtype, padded)
    Np2 = xh.shape[-1]
    r0, r1 = rows or (0, n_fft // 2 + 1)
    V = torch.empty(xt.shape[:-1] + (r1 - r0, N), dtype=xh.dtype,
                    device=xt.device)
    w2 = torch.empty(V.shape, dtype=xt.dtype, device=xt.device)
    for lo, hi in row_blocks(r1 - r0, len(bank) * xh[..., :1].numel() * Np2
                             * 16):
        tables = table_rows(bank, n_fft, Np2, modulated, r0 + lo, r0 + hi,
                            xh.dtype, xt.device)
        V[..., lo:hi, :], w2[..., lo:hi, :] = fsst2_rows(
            xh, tables, N, fs, Sfs[r0 + lo:r0 + hi], gamma)
    return V, w2


fsst2_general.calls = 0
