# -*- coding: utf-8 -*-
"""Signal framing and overlap-add for the framed STFT and its inverse, and
the window measures.

Counterpart of `buffer`, `unbuffer`, the overlap-add of `istft`,
`window_norm`, `window_resolution` and `window_area` in
`ssqueezepy_tpu/ops/framing.py` (the window measures are host numpy, as
there). Frames are `Tensor.unfold` views, one
frame per row (`frame_rows`; `buffer` is their transpose); the
overlap-add is `torch.nn.functional.fold`, which gathers per output
sample (no atomics, so it is deterministic on the card).
"""
import numpy as np
import torch
from scipy import integrate

__all__ = ['frame_rows', 'buffer', 'unbuffer', 'overlap_add', 'window_norm',
           'window_resolution', 'window_area', 'mod_roll_amount']


def mod_roll_amount(seg_len):
    """Modulated frames are plain frames rolled left by s21:
    s20 = ceil(seg_len/2), s21 = s20 - 1 for odd seg_len, else s20."""
    s20 = -(-seg_len // 2)
    return s20 - 1 if seg_len % 2 == 1 else s20


def frame_rows(x, seg_len, hop_len, modulated=False):
    """Successive length-`seg_len` slices of `x` along its last axis,
    `hop_len` apart, as rows: 1-D (L,) -> (n_segs, seg_len); 2-D (B, L)
    -> (B, n_segs, seg_len). A view of `x`; `modulated` rolls each frame
    left by s21 (`mod_roll_amount`) into a new tensor."""
    out = x.unfold(-1, seg_len, hop_len)
    if modulated:
        out = torch.roll(out, -mod_roll_amount(seg_len), dims=-1)
    return out


def buffer(x, seg_len, n_overlap, modulated=False):
    """Successive length-`seg_len` slices of `x` along its last axis,
    overlapping by `n_overlap`, as columns: 1-D (L,) -> (seg_len,
    n_segs); 2-D (B, L) -> (B, seg_len, n_segs)."""
    return frame_rows(x, seg_len, seg_len - n_overlap,
                      modulated).transpose(-1, -2)


def overlap_add(frames, hop_len, out_len):
    """out[n] = sum_i frames[..., n - i*hop_len, i], frames (..., seg_len,
    n_segs) real; the result (..., out_len) is cut or zero-extended to
    `out_len`."""
    lead = frames.shape[:-2]
    seg_len, n_segs = frames.shape[-2:]
    span = seg_len + (n_segs - 1) * hop_len
    f = frames.reshape(-1, seg_len, n_segs)
    out = torch.nn.functional.fold(f, output_size=(1, span),
                                   kernel_size=(1, seg_len),
                                   stride=(1, hop_len))
    out = out.reshape(lead + (span,))
    if span >= out_len:
        return out[..., :out_len]
    return torch.nn.functional.pad(out, (0, out_len - span))


def unbuffer(xbuf, window, hop_len, n_fft, N, win_exp=1):
    """Overlap-add inverse of `buffer`: the frames `xbuf` (n_fft, n_segs)
    weighted by window ** win_exp, added `hop_len` apart into a signal of
    N + n_fft - 1 samples (N None: n_segs * hop_len + len(window) - 1).
    numpy in, numpy out; a tensor stays on its device."""
    if N is None:
        N = xbuf.shape[1] * hop_len + len(window) - 1
    if len(window) != n_fft:
        raise ValueError("Must have `len(window) == n_fft` "
                         "(got %s != %s)" % (len(window), n_fft))
    w = np.asarray(window)
    w = np.ones_like(w) if win_exp == 0 else w if win_exp == 1 else \
        w ** win_exp
    if isinstance(xbuf, torch.Tensor):
        wt = torch.as_tensor(w, dtype=xbuf.dtype, device=xbuf.device)
        return overlap_add(xbuf * wt.reshape(-1, 1), hop_len,
                           N + n_fft - 1)
    xbuf = np.asarray(xbuf)
    x = np.zeros(N + n_fft - 1, dtype=xbuf.dtype)
    wb = xbuf * w[:, None]
    for i in range(xbuf.shape[1]):
        x[i * hop_len:i * hop_len + n_fft] += wb[:, i]
    return x


def window_norm(window, hop_len, n_fft, N, win_exp=1):
    """Window modulation array that `istft` divides by (host numpy, a
    plan constant)."""
    wn = np.zeros(N + n_fft - 1)
    max_hops = (len(wn) - n_fft) // hop_len + 1
    wpow = window ** (win_exp + 1)
    for i in range(max_hops):
        n = i * hop_len
        wn[n:n + n_fft] += wpow
    return wn


def _xi_centered(N):
    from ..models.wavelets import _xifn
    return np.fft.fftshift(_xifn(1, N))


def window_resolution(window):
    """(std_w, std_t, harea) of a window (numpy, >= 0), its spectrum
    centered about dc."""
    window = np.asarray(window)
    if window.min() < 0:
        raise ValueError("`window` must be >= 0 (got min=%s)"
                         % window.min())
    N = len(window)
    t = np.arange(-N / 2, N / 2, step=1)
    ws = _xi_centered(N)
    apsi2 = np.abs(window) ** 2
    apsih2s = np.abs(np.fft.fftshift(np.fft.fft(window))) ** 2
    var_w = (integrate.trapezoid(ws ** 2 * apsih2s, ws) /
             integrate.trapezoid(apsih2s, ws))
    var_t = (integrate.trapezoid(t ** 2 * apsi2, t) /
             integrate.trapezoid(apsi2, t))
    std_w, std_t = np.sqrt(var_w), np.sqrt(var_t)
    return std_w, std_t, std_w * std_t


def window_area(window, time=True, frequency=False):
    """The area under |window|^2 in time and/or under its |spectrum|^2 in
    frequency (numpy)."""
    if not time and not frequency:
        raise ValueError("must compute something")
    window = np.asarray(window)
    if time:
        t = np.arange(-len(window) / 2, len(window) / 2, step=1)
        at = integrate.trapezoid(np.abs(window) ** 2, t)
    if frequency:
        ws = _xi_centered(len(window))
        apsih2s = np.abs(np.fft.fftshift(np.fft.fft(window))) ** 2
        aw = integrate.trapezoid(apsih2s, ws)
    if time and frequency:
        return at, aw
    return at if time else aw
