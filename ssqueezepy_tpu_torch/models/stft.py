# -*- coding: utf-8 -*-
"""Short-Time Fourier Transform (forward & inverse).

Counterpart of `ssqueezepy_tpu/models/stft.py`. At hop 1 the STFT is
one FFT of the padded signal and, per row, the inverse DFT of the
product with that row's window table (in float32, by default, cut to
the row's spectral band: `ops/stft_conv.py::stft_tables`): on a CUDA
device the hand-written table kernel (`ops/stft_cuda.py`), with
``device='cpu'`` its plain version. At hop > 1 it takes the framed
path (frames -> window -> `torch.fft.rfft`), which the JAX package left
to XLA: the windowed frames
are one contiguous (..., n_segs, n_fft) tensor, transformed along their
last axis and returned transposed, (..., n_fft//2 + 1, n_segs), so that
each frame is transformed as in a one-signal call, whatever the batch
and the CPU's thread count. A (B, N) batch
runs as one call: the table kernel over its B spectra, or the framed
path over its B signals. At hop 1 the transform length is checked
against the table kernel's rule (`ops/stft_cuda.py::stft_kernel_fits`)
on every device before the signal's FFT; past it the call takes
`stft_general`, the JAX package's XLA branch (`_stft_conv_jit`): the
same row products with the full tables, built on the device block by
block (`ops/stft_conv.py::table_rows`), and `torch.fft.ifft`, in row
blocks of at most 2 GiB per intermediate. The inverse is
irfft -> fftshift -> windowed overlap-add -> window-norm divide -> unpad,
on the tensor's device.
"""
import functools

import numpy as np
import torch

from ..configs import default_dtype
from ..ops.fft import fft, irfft, fftshift, ifftshift, next_fft_len
from ..ops.framing import frame_rows, overlap_add, window_norm
from ..ops.pad import padsignal
from ..ops.stft_conv import stft_tables, table_rows
from ..ops import stft_cuda
from ..ops.stft_cuda import stft_conv, stft_length_rule
from ..utils.common import (check_batch, numpy_unless_grad, resolve_device,
                            row_blocks)
from ..utils.cwt_utils import _process_fs_and_t
from .windows import get_window, _check_NOLA

__all__ = ['stft', 'istft', 'stft_general']


def _as_signal(x, dtype, device):
    """Real tensor of `dtype` on `device`, non-finite samples zeroed."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    xt = torch.as_tensor(x, dtype=getattr(torch, dtype), device=device)
    return torch.where(torch.isfinite(xt), xt, torch.zeros_like(xt))


def signal_spectrum(xt, n_fft, padtype, planes=1):
    """The full FFT of the signal padded to N + n_fft - 1, at the
    kernel's transform length `next_fft_len(N + n_fft - 1)`, which is
    checked first against the kernel's length rule for the route's
    `planes` (1: Sx; 2: Sx and dSx, or bins; 5: FSST2)."""
    stft_length_rule(next_fft_len(xt.shape[-1] + n_fft - 1),
                     2 * xt.element_size(), planes)
    return _spectrum(xt, n_fft, padtype)


def _spectrum(xt, n_fft, padtype):
    """`signal_spectrum` without the kernel's rule (the general routes)."""
    padlength = xt.shape[-1] + n_fft - 1
    xp = padsignal(xt, padtype, padlength=padlength)
    return fft(xp, n=next_fft_len(padlength)).contiguous()


def _general_spectrum(xt, n_fft, padtype, padded):
    """(spectrum, N) of the general routes: `_spectrum` of the length-N
    `xt`, or with `padded` the FFT of `xt`, already the padded signal of
    N + n_fft - 1 samples, at the same length."""
    if padded:
        return (fft(xt, n=next_fft_len(xt.shape[-1])).contiguous(),
                xt.shape[-1] - n_fft + 1)
    return _spectrum(xt, n_fft, padtype), xt.shape[-1]


def stft_kernel_route(N, n_fft, dtype, planes):
    """Whether the hop-1 STFT of a length-N signal in `dtype` ('float32'
    or 'float64') runs the table kernel: its transform length fits the
    kernel's rule for `planes` planes of the complex type
    (`ops/stft_cuda.py::stft_kernel_fits`); else the general route.
    Decided before the signal's FFT."""
    return stft_cuda.stft_kernel_fits(next_fft_len(N + n_fft - 1),
                                      2 * np.dtype(dtype).itemsize, planes)


def stft_general(xt, windows, n_fft, padtype, modulated, rows=None,
                 padded=False):
    """The hop-1 STFT rows of the real signal or (B, N) batch `xt` with
    each window of `windows` (numpy (n_w, n_fft)): the JAX package's XLA
    branch `_stft_conv_jit` on torch ops, for transform lengths past the
    table kernel's rule. The spectrum of the signal padded to N + n_fft -
    1 at `next_fft_len` of that, times each block of rows of the windows'
    full tables (`ops/stft_conv.py::table_rows`, built on xt's device per
    block), then `torch.fft.ifft` kept to [0, N); row blocks keep each
    intermediate within 2 GiB (`utils/common.py::row_blocks`). `rows`
    (lo, hi): those rows of the n_fft//2 + 1 alone (a sharded plan's
    block); `padded`: `xt` is already the padded signal of N + n_fft - 1
    samples (a streaming window; `padtype` unused). Returns one
    (rows, N) or (B, rows, N) complex tensor per window. Counts its calls
    on `stft_general.calls`."""
    stft_general.calls += 1
    xh, N = _general_spectrum(xt, n_fft, padtype, padded)
    xh = xh[..., None, :]
    Np2 = xh.shape[-1]
    n_w = len(windows)
    r0, r1 = rows or (0, n_fft // 2 + 1)
    out = [torch.empty(xt.shape[:-1] + (r1 - r0, N), dtype=xh.dtype,
                       device=xt.device) for _ in range(n_w)]
    # per row: the complex128 tables and their products with each signal
    for lo, hi in row_blocks(r1 - r0, n_w * xh[..., :1].numel() * Np2 * 16):
        H = table_rows(windows, n_fft, Np2, modulated, r0 + lo, r0 + hi,
                       xh.dtype, xt.device)
        for q in range(n_w):
            out[q][..., lo:hi, :] = torch.fft.ifft(H[q] * xh,
                                                   dim=-1)[..., :N]
    return out


stft_general.calls = 0


def stft(x, window=None, n_fft=None, win_len=None, hop_len=1, fs=None,
         t=None, padtype='reflect', modulated=True, derivative=False,
         dtype=None, device='cuda'):
    """Short-Time Fourier Transform of a signal (N,) or a batch of
    signals (B, N). Returns `Sx` (n_fft//2 + 1, n_segs), or (B, n_fft//2
    + 1, n_segs), complex on `device` (+ `dSx`, the transform with the
    derivative window times fs, if `derivative`): rows are the positive
    frequencies, columns the hops (N of them at hop 1)."""
    device = resolve_device(device)
    ndim = x.dim() if isinstance(x, torch.Tensor) else np.ndim(x)
    check_batch(ndim)
    N = x.shape[-1]
    _, fs_, _ = _process_fs_and_t(fs, t, N)
    n_fft = int(n_fft or min(N // hop_len, 512))
    if win_len is None:
        win_len = (len(window) if isinstance(window, np.ndarray) else n_fft)
    dtype = dtype or default_dtype()
    window, diff_window = get_window(window, win_len, n_fft,
                                     derivative=True, dtype=dtype)
    _check_NOLA(window, hop_len, dtype)
    xt = _as_signal(x, dtype, device)

    if int(hop_len) == 1 and not stft_kernel_route(
            N, n_fft, dtype, 2 if derivative else 1):
        planes = stft_general(xt, [window, diff_window][:1 + derivative],
                              n_fft, padtype, modulated)
        Sx, dSx = planes[0], planes[1].mul_(fs_) if derivative else None
    elif int(hop_len) == 1:
        xh = signal_spectrum(xt, n_fft, padtype, 2 if derivative else 1)
        Np2 = xh.shape[-1]
        H, Hd = stft_tables(window, diff_window, n_fft, Np2, modulated,
                            dtype, device, derivative)
        Sx, dSx = stft_conv(xh, H, Hd, N, float(fs_))
    else:
        xp = padsignal(xt, padtype, padlength=N + n_fft - 1)
        frames = frame_rows(xp, n_fft, int(hop_len), modulated)

        def dft(win):
            w = torch.as_tensor(win, device=device)
            if modulated:
                w = ifftshift(w)
            return torch.fft.rfft((frames * w).contiguous(),
                                  dim=-1).transpose(-1, -2)

        Sx = dft(window)
        dSx = dft(diff_window) * fs_ if derivative else None
    return (Sx, dSx) if derivative else Sx


@functools.lru_cache(maxsize=32)
def _istft_consts(win_bytes, n_fft, hop_len, N, win_exp, dtype, device):
    """(window ** win_exp as an (n_fft, 1) column, the window norm made
    safe to divide by), tensors on `device`; `win_bytes` the window's
    bytes in `dtype`. Kept per plan: a per-call upload is a pageable copy
    that blocks the host until the stream drains."""
    window = np.frombuffer(win_bytes, dtype=dtype)
    w = np.ones_like(window) if win_exp == 0 else window ** win_exp
    wn = window_norm(window, hop_len, n_fft, N, win_exp)
    tiny = np.finfo(np.dtype(dtype)).tiny
    wn = np.where(wn > tiny, wn, 1.0).astype(dtype)
    return (torch.as_tensor(w.astype(dtype), device=device).reshape(-1, 1),
            torch.as_tensor(wn, device=device))


def istft(Sx, window=None, n_fft=None, win_len=None, hop_len=1, N=None,
          modulated=True, win_exp=1):
    """Inverse STFT by least-squares overlap-add. `Sx` (n_rows, n_segs)
    or a batch (B, n_rows, n_segs), a complex tensor (inverted on its
    device) or numpy array; returns numpy (N,) or (B, N), or for a tensor
    that requires grad a tensor on its device carrying the graph."""
    if not isinstance(Sx, torch.Tensor):
        Sx = torch.as_tensor(np.asarray(Sx))
    n_fft = int(n_fft or (Sx.shape[-2] - 1) * 2)
    win_len = win_len or n_fft
    N_ = int(N or hop_len * Sx.shape[-1])
    dtype = 'float32' if Sx.dtype == torch.complex64 else 'float64'

    window = get_window(window, win_len, n_fft=n_fft, dtype=dtype)
    _check_NOLA(window, hop_len, dtype=dtype)
    w, wn = _istft_consts(window.tobytes(), n_fft, int(hop_len), N_,
                          int(win_exp), dtype, Sx.device)
    full = N_ + n_fft - 1
    lo, hi = n_fft // 2, full - ((n_fft - 1) // 2)

    xbuf = irfft(Sx, n=n_fft, axis=-2)
    if modulated:
        xbuf = fftshift(xbuf, axes=-2)
    x = overlap_add(xbuf * w, int(hop_len), full) / wn
    return numpy_unless_grad(x[..., lo:hi])
