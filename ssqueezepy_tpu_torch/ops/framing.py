# -*- coding: utf-8 -*-
"""Signal framing and overlap-add for the framed STFT and its inverse.

Counterpart of `buffer`, the overlap-add of `istft` and `window_norm` in
`ssqueezepy_tpu/ops/framing.py`. Frames are `Tensor.unfold` views, one
frame per row (`frame_rows`; `buffer` is their transpose); the
overlap-add is `torch.nn.functional.fold`, which gathers per output
sample (no atomics, so it is deterministic on the card).
"""
import numpy as np
import torch

__all__ = ['frame_rows', 'buffer', 'overlap_add', 'window_norm',
           'mod_roll_amount']


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
