# -*- coding: utf-8 -*-
"""Signal padding along the last axis.

Counterpart of `ssqueezepy_tpu/ops/pad.py`. The pad geometry is host
arithmetic; the padded signal is one gather whose index is numpy's own
`np.pad` of `arange(N)`, so every padtype (including reflections longer
than the signal) follows numpy's semantics exactly.
"""
import functools

import numpy as np
import torch

from ..utils.common import p2up, assert_is_one_of

__all__ = ['SUPPORTED_PADTYPES', 'pad_params', 'padsignal']

SUPPORTED_PADTYPES = ('reflect', 'symmetric', 'replicate', 'wrap', 'zero')

_MODE_MAP = {
    'reflect': 'reflect',
    'symmetric': 'symmetric',
    'replicate': 'edge',
    'wrap': 'wrap',
}


def pad_params(N, padtype='reflect'):
    """(n_up, n1, n2): padded length (next power of two), left pad, right
    pad. An odd total pad puts the extra sample on the LEFT."""
    assert_is_one_of(padtype, 'padtype', SUPPORTED_PADTYPES)
    n_up, n1, n2 = p2up(N)
    return int(n_up), int(n1), int(n2)


@functools.lru_cache(maxsize=64)
def _pad_index(N, n1, n2, padtype, device):
    """Gather index on `device`, kept: uploading it per call is a pageable
    host-to-device copy, which also blocks the host until the stream's
    earlier work is done."""
    idx = np.pad(np.arange(N), (n1, n2), mode=_MODE_MAP[padtype])
    return torch.as_tensor(idx, device=device)


def padsignal(x, padtype='reflect'):
    """Pad real tensor `x` (1-D or 2-D) along the last axis to the next
    power of two."""
    N = x.shape[-1]
    _, n1, n2 = pad_params(N, padtype)
    if padtype == 'zero':
        return torch.nn.functional.pad(x, (n1, n2))
    return x.index_select(-1, _pad_index(N, n1, n2, padtype, x.device))
