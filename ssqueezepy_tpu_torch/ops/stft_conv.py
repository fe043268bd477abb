# -*- coding: utf-8 -*-
"""Window tables of the hop-1 STFT (host side of the table kernel).

Counterpart of `_conv_filterbank` and the device-table cache of
`ssqueezepy_tpu/ops/stft_conv.py`. At hop 1 each STFT row k is a
correlation of the padded signal with the fixed kernel

    g_k[m] = c_k * v[m] * exp(-2 pi i k m / n_fft),   m < n_fft,

(v the window, frame-rolled by s21 for the modulated STFT, and c_k the
modulation phase), so with xh = fft(pad(x), Np2) the row is
ifft(H_k * xh)[:N] for H_k = conj(fft(conj(g_k), Np2)). The tables are
plan constants: built once per (window, n_fft, Np2, modulated, dtype,
device) in float64 with `torch.fft` on the target device, then cast.
The TPU's band plan (`_band_plan`, which drops 1e-7 of each row's mass)
is not carried over: the card kernel reads full rows.

`conv_bank` stacks the tables of a bank of windows sharing one
modulation geometry (the five FSST2 windows; counterpart of
`_conv_filterbank_multi` / `_device_filterbank_multi`) into one
(n_w, n_rows, Np2) tensor, cached apart from the single tables so that
neither evicts the other.
"""
import collections

import numpy as np
import torch

from .framing import mod_roll_amount

__all__ = ['conv_table', 'conv_bank']

_TABLE_CACHE = collections.OrderedDict()
_TABLE_CACHE_SIZE = 8
_BANK_CACHE = collections.OrderedDict()
_BANK_CACHE_SIZE = 2


def _build_table(window, n_fft, Np2, modulated, cdtype, device):
    n_rows = n_fft // 2 + 1
    v = np.asarray(window, np.float64)
    if modulated:
        s21 = mod_roll_amount(n_fft)
        v = np.roll(np.fft.ifftshift(v), s21)
        ck = np.exp(2j * np.pi * np.arange(n_rows) * s21 / n_fft)
    else:
        ck = np.ones(n_rows)
    cis = np.exp(-2j * np.pi * np.outer(np.arange(n_rows), np.arange(n_fft))
                 / n_fft)
    g = torch.zeros((n_rows, Np2), dtype=torch.complex128, device=device)
    g[:, :n_fft] = torch.as_tensor((ck[:, None] * cis) * v, device=device)
    # corr[j] = sum_m g[m] x[j + m]  ->  H = conj(fft(conj(g)))
    H = torch.fft.fft(g.conj_physical_(), dim=-1).conj_physical_()
    return H.to(cdtype).contiguous()


def _memo(cache, size, window, n_fft, Np2, modulated, dtype, device,
          build):
    """`build(cdtype)` memoized in the LRU `cache` of `size` entries,
    keyed by the window content and the table geometry."""
    cdtype = (torch.complex64 if str(dtype) == 'float32'
              else torch.complex128)
    key = (hash(np.asarray(window).tobytes()), np.shape(window),
           str(np.asarray(window).dtype), n_fft, Np2, bool(modulated),
           cdtype, str(device))
    hit = cache.get(key)
    if hit is not None:
        cache.move_to_end(key)
        return hit
    hit = cache[key] = build(cdtype)
    while len(cache) > size:
        cache.popitem(last=False)
    return hit


def conv_table(window, n_fft, Np2, modulated, dtype, device):
    """(n_fft//2 + 1, Np2) complex table of `window` (numpy, length
    n_fft) in `dtype`'s complex type on `device`, memoized (a few tables
    at a time: at the ssq_stft headline one is 393 MB)."""
    return _memo(_TABLE_CACHE, _TABLE_CACHE_SIZE, window, n_fft, Np2,
                 modulated, dtype, device, lambda cdtype: _build_table(
                     window, n_fft, Np2, modulated, cdtype, device))


def conv_bank(bank, n_fft, Np2, modulated, dtype, device):
    """(n_w, n_fft//2 + 1, Np2) complex tables of the windows `bank`
    (numpy (n_w, n_fft)), each as `conv_table` builds it, memoized per
    bank (at the ssq_stft2 headline five tables are 1.97 GB)."""
    def build(cdtype):
        out = torch.empty((len(bank), n_fft // 2 + 1, Np2), dtype=cdtype,
                          device=device)
        for i, window in enumerate(bank):
            out[i] = _build_table(window, n_fft, Np2, modulated, cdtype,
                                  device)
        return out
    return _memo(_BANK_CACHE, _BANK_CACHE_SIZE, bank, n_fft, Np2, modulated,
                 dtype, device, build)
