# -*- coding: utf-8 -*-
"""Signal padding along the last axis.

Counterpart of `ssqueezepy_tpu/ops/pad.py`. The pad geometry is host
arithmetic; the padded signal is one gather whose index is numpy's own
`np.pad` of `arange(N)`, so every padtype (including reflections longer
than the signal) follows numpy's semantics exactly. `reflect_index` and
`_reflect` take the reflected material alone from the same index (the
streaming plans' carry state: `_reflect` of
`ssqueezepy_tpu/parallel/time_sharded.py`, and the repeated reflection
`np.pad(..., 'reflect')` applies when the pad is longer than the signal).
"""
import functools

import numpy as np
import torch

from ..utils.common import p2up, assert_is_one_of

__all__ = ['SUPPORTED_PADTYPES', 'pad_params', 'padsignal',
           'reflect_index']

SUPPORTED_PADTYPES = ('reflect', 'symmetric', 'replicate', 'wrap', 'zero')

_MODE_MAP = {
    'zero': 'constant',
    'reflect': 'reflect',
    'symmetric': 'symmetric',
    'replicate': 'edge',
    'wrap': 'wrap',
}


def pad_params(N, padtype='reflect', padlength=None):
    """(n_up, n1, n2): padded length (the next power of two, or
    `padlength`), left pad, right pad. An odd total pad puts the extra
    sample on the LEFT."""
    assert_is_one_of(padtype, 'padtype', SUPPORTED_PADTYPES)
    if padlength is None:
        n_up, n1, n2 = p2up(N)
    else:
        n_up = int(padlength)
        n2 = (n_up - N) // 2
        n1 = n_up - N - n2
    return int(n_up), int(n1), int(n2)


@functools.lru_cache(maxsize=64)
def _pad_index(N, n1, n2, padtype, device):
    """Gather index on `device`, kept: uploading it per call is a pageable
    host-to-device copy, which also blocks the host until the stream's
    earlier work is done."""
    idx = np.pad(np.arange(N), (n1, n2), mode=_MODE_MAP[padtype])
    return torch.as_tensor(idx, device=device)


def padsignal(x, padtype='reflect', padlength=None):
    """Pad real tensor `x` (1-D or 2-D) along the last axis to the next
    power of two, or to `padlength`."""
    N = x.shape[-1]
    _, n1, n2 = pad_params(N, padtype, padlength)
    if padtype == 'zero':
        return torch.nn.functional.pad(x, (n1, n2))
    return x.index_select(-1, _pad_index(N, n1, n2, padtype, x.device))


def reflect_index(N, n, from_start, device):
    """Gather index (on `device`) of the `n` samples that 'reflect'
    padding puts before (`from_start`) or after a length-N signal: the
    signal reflected from its own edge with no repeated edge sample, and
    reflected again (numpy's rule) where n >= N. A slice of `_pad_index`,
    kept with it."""
    if from_start:
        return _pad_index(N, n, 0, 'reflect', device)[:n]
    return _pad_index(N, 0, n, 'reflect', device)[N:]


def _reflect(x, n, from_start):
    """The `n` samples 'reflect' padding puts before (`from_start`) or
    after `x` along its last axis; x[..., 1:n + 1] reversed, or
    x[..., -n - 1:-1] reversed, for n < x.shape[-1]."""
    return x.index_select(-1, reflect_index(x.shape[-1], n, from_start,
                                            x.device))
