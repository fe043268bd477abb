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

`conv_bank` stacks the tables of a bank of windows sharing one
modulation geometry (the five FSST2 windows; counterpart of
`_conv_filterbank_multi` / `_device_filterbank_multi`) into one
(n_w, n_rows, Np2) tensor, cached apart from the single tables so that
neither evicts the other.

The band plan (`_band_geometry`, `_band_plan`, `_band_plan_bank`,
`_conv_filterbank_packed`, `_fsst2_tables_packed` there): a window's
spectrum is concentrated around each row's frequency, so of the (f1, f2)
view of a row's table (m = m1 f2 + m2, the kernel's split
`ops/stft_cuda.py::split_fft_len`) only a band of the f1 rows m1 carries
mass. `_band_geometry` keeps, per row, the rows that hold all but 1e-7 of
the row's L1 mass (dropped from the outside in around the row's peak),
from an 8-aligned start r0 and one width br for every row; no band where
br > f1 / 2. `stft_tables` (the pair H, Hd, their band planned on
max(|H|, |Hd|)) and `fsst2_tables` (the bank, planned on the max over its
five windows) return `BandedTable`s packed to (n_w, n_rows, br, f2) where
the tables are float32, `get_config().stft_band` is on and the band
pays, and the full tables of `conv_table` / `conv_bank` otherwise
(float64 keeps them: a 1e-7 tail is far above its tolerance). The
setting chooses the function (the exact correlation or the one with
each row's 1e-7 tail dropped); both run the same kernel.
"""
import collections

import numpy as np
import torch

from ..configs import get_config
from .framing import mod_roll_amount
from .stft_cuda import BandedTable, split_fft_len

__all__ = ['conv_table', 'conv_bank', 'stft_tables', 'fsst2_tables',
           'row_block']

_TABLE_CACHE = collections.OrderedDict()
_TABLE_CACHE_SIZE = 8
_BANK_CACHE = collections.OrderedDict()
_BANK_CACHE_SIZE = 2
# banded pairs and banks (None where the band does not pay)
_BAND_CACHE = collections.OrderedDict()
_BAND_CACHE_SIZE = 4
_MISS = object()

# per row, the dropped spectrum rows' L1 mass stays under this fraction of
# the row's total (the JAX package's `_BAND_EPS_MASS`)
_BAND_EPS_MASS = 1e-7


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


def _key(windows, *geometry):
    w = np.asarray(windows)
    return (hash(w.tobytes()), w.shape, str(w.dtype)) + geometry


def _lru(cache, size, key, build):
    """`build()` memoized in the LRU `cache` of `size` entries (None
    results too)."""
    hit = cache.get(key, _MISS)
    if hit is not _MISS:
        cache.move_to_end(key)
        return hit
    hit = cache[key] = build()
    while len(cache) > size:
        cache.popitem(last=False)
    return hit


def _cdtype(dtype):
    return (torch.complex64 if str(dtype) == 'float32'
            else torch.complex128)


def _memo(cache, size, window, n_fft, Np2, modulated, dtype, device,
          build):
    """`build(cdtype)` memoized in the LRU `cache` of `size` entries,
    keyed by the window content and the table geometry."""
    cdtype = _cdtype(dtype)
    return _lru(cache, size, _key(window, n_fft, Np2, bool(modulated),
                                  cdtype, str(device)),
                lambda: build(cdtype))


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


def _band_geometry(msum, mmax):
    """Per-row band (r0, br) from each row's per-m1 L1 mass `msum` and
    peak `mmax` ((n_rows, f1) float64 numpy): rows m1 drop from the
    outside in around the row's peak while the dropped mass stays under
    `_BAND_EPS_MASS` of the row's; starts 8-aligned, one width (a
    multiple of 8, at most f1). (r0 int64 (n_rows,), br), or None where
    br > f1 / 2 (the band would not pay)."""
    n_rows, f1 = msum.shape
    r0 = np.zeros(n_rows, np.int64)
    br = 8
    for k in range(n_rows):
        # offsets unwrapped around the peak row (bands are contiguous mod
        # f1); drop rows outside-in while the dropped mass fits
        c = int(mmax[k].argmax())
        off = ((np.arange(f1) - c + f1 // 2) % f1) - f1 // 2
        drop_order = np.argsort(-np.abs(off))
        cum = np.cumsum(msum[k][drop_order])
        ndrop = int(np.searchsorted(cum, _BAND_EPS_MASS * cum[-1]))
        keep_off = off[drop_order[ndrop:]]
        lo = (c + int(keep_off.min())) % f1
        r0[k] = (lo // 8) * 8
        br = max(br, int(keep_off.max() - keep_off.min()) + 1
                 + (lo - r0[k]))
    br = min(-(-br // 8) * 8, f1)
    if br > f1 // 2:
        return None
    return r0, int(br)


def _banded(windows, n_fft, Np2, modulated, dtype, device):
    """The `BandedTable` (n_w, n_rows, br, f2) of `windows` (numpy
    (n_w, n_fft)) on their shared band, planned on the max of their
    magnitudes on the kernel's split of Np2 (each table built in float64,
    then cast), or None where the band does not pay; memoized."""
    cdtype = _cdtype(dtype)

    def build():
        f1, f2 = split_fft_len(Np2)
        mag, full = None, []
        for window in windows:
            H = _build_table(window, n_fft, Np2, modulated,
                             torch.complex128, device)
            mag = H.abs() if mag is None else torch.maximum(mag, H.abs())
            full.append(H.to(cdtype))
            del H
        magr = mag.reshape(-1, f1, f2)
        plan = _band_geometry(magr.sum(-1).cpu().numpy(),
                              magr.amax(-1).cpu().numpy())
        if plan is None:
            return None
        r0, br = plan
        full = torch.stack(full)
        n_w, n_rows = full.shape[:2]
        r0_t = torch.as_tensor(r0, device=device)
        take = (r0_t[:, None] + torch.arange(br, device=device)) % f1
        t = full.reshape(n_w, n_rows, f1, f2).gather(
            2, take[None, :, :, None].expand(n_w, n_rows, br, f2))
        return BandedTable(t.contiguous(), r0_t.to(torch.int32), f1,
                           r0.astype(np.int32))
    return _lru(_BAND_CACHE, _BAND_CACHE_SIZE,
                _key(windows, n_fft, Np2, bool(modulated), cdtype,
                     str(device)), build)


def _band_on(dtype):
    """Whether tables of `dtype` are banded where the band pays."""
    return str(dtype) == 'float32' and bool(get_config().stft_band)


def stft_tables(window, diff_window, n_fft, Np2, modulated, dtype, device,
                derivative=True):
    """(H, Hd) for the STFT kernel (B6): two `BandedTable`s of one band,
    planned on max(|H|, |Hd|) and memoized as one pair (Sx-only calls
    read its H, so `stft` and `ssq_stft` share the entry), where `dtype`
    is float32, `stft_band` is on and the band pays; else the full
    tables of `conv_table`. Hd is None unless `derivative`."""
    if _band_on(dtype):
        pair = _banded(np.stack([np.asarray(window),
                                 np.asarray(diff_window)]), n_fft, Np2,
                       modulated, dtype, device)
        if pair is not None:
            return pair.plane(0), pair.plane(1) if derivative else None
    H = conv_table(window, n_fft, Np2, modulated, dtype, device)
    return H, (conv_table(diff_window, n_fft, Np2, modulated, dtype, device)
               if derivative else None)


def fsst2_tables(bank, n_fft, Np2, modulated, dtype, device):
    """The FSST2 bank for B7: a `BandedTable` (5, n_rows, br, f2) on the
    band of the max over its windows (as `stft_tables` decides), else the
    full (5, n_rows, Np2) tables of `conv_bank`."""
    if _band_on(dtype):
        band = _banded(bank, n_fft, Np2, modulated, dtype, device)
        if band is not None:
            return band
    return conv_bank(bank, n_fft, Np2, modulated, dtype, device)


def row_block(tab, lo, hi):
    """Rows [lo, hi) of a table: a (n_rows, Np2) table, a (n_w, n_rows,
    Np2) bank (made contiguous) or a `BandedTable` (its rows and r0, br
    kept)."""
    if isinstance(tab, BandedTable) or tab.dim() == 2:
        return tab[lo:hi]
    return tab[:, lo:hi].contiguous()
