# -*- coding: utf-8 -*-
"""Elementwise replacement and scrubbing helpers.

Counterpart of `ssqueezepy_tpu/ops/elementwise.py`: a numpy array is
changed in place and returned, as the reference library does; a tensor
gets a new tensor from `torch.where` on its device, in its dtype, with
the values numpy gives (a complex cell tested as numpy tests it, and
replaced by `replacement` + 0j).
"""
import functools

import numpy as np
import torch

__all__ = ['replace_at_inf_or_nan', 'replace_at_inf', 'replace_at_nan',
           'replace_at_value', 'replace_under_abs', 'zero_denormals',
           '_min_neglect_idx', 'nCk']


def _apply(x, ref, mask_fn, replacement):
    """numpy `x`: x[mask] = replacement in place; a tensor: a new one."""
    ref = x if ref is None else ref
    if isinstance(x, np.ndarray):
        if isinstance(ref, torch.Tensor):
            ref = ref.detach().cpu().numpy()
        x[mask_fn(np, np.asarray(ref))] = replacement
        return x
    x = torch.as_tensor(x)
    m = mask_fn(torch, torch.as_tensor(ref, device=x.device))
    return torch.where(m, torch.tensor(replacement, dtype=x.dtype,
                                       device=x.device), x)


def replace_at_inf_or_nan(x, ref=None, replacement=0.):
    """x[isinf(ref) | isnan(ref)] = replacement."""
    return _apply(x, ref, lambda xp, r: ~xp.isfinite(r), replacement)


def replace_at_inf(x, ref=None, replacement=0.):
    """x[isinf(ref)] = replacement."""
    return _apply(x, ref, lambda xp, r: xp.isinf(r), replacement)


def replace_at_nan(x, ref=None, replacement=0.):
    """x[isnan(ref)] = replacement."""
    return _apply(x, ref, lambda xp, r: xp.isnan(r), replacement)


def replace_at_value(x, ref=None, value=0., replacement=0.):
    """x[ref == value] = replacement."""
    return _apply(x, ref, lambda xp, r: r == value, replacement)


def replace_under_abs(x, ref=None, value=0., replacement=0.):
    """x[|ref| < value] = replacement (the phase transform's gamma
    gate)."""
    return _apply(x, ref, lambda xp, r: xp.abs(r) < value, replacement)


def zero_denormals(x, parallel=None):
    """|x| < 1000 * tiny (of x's real dtype) set to zero: in place for
    numpy, a new tensor for a tensor. `parallel` is ignored."""
    if isinstance(x, np.ndarray):
        x[np.abs(x) < 1000 * np.finfo(x.dtype).tiny] = 0
        return x
    x = torch.as_tensor(x)
    th = 1000 * torch.finfo(x.real.dtype).tiny
    return torch.where(x.abs() < th, torch.zeros_like(x), x)


def _min_neglect_idx(arr, th=1e-12):
    """First index where arr < th (else the last index)."""
    arr = np.asarray(arr)
    idxs = np.flatnonzero(arr < th)
    return int(idxs[0]) if len(idxs) else len(arr) - 1


def nCk(n, k):
    """n choose k, as a float."""
    r = min(k, n - k)
    numer = functools.reduce(lambda a, b: a * b, range(n, n - r, -1), 1)
    denom = functools.reduce(lambda a, b: a * b, range(1, r + 1), 1)
    return numer / denom
