# -*- coding: utf-8 -*-
"""Small analysis helpers. Counterpart of `ssqueezepy_tpu/toolkit.py`
(`mad_rms`; the rest waits for ROADMAP item A12)."""
import numpy as np
import torch

__all__ = ['mad_rms']


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def mad_rms(x, xrec):
    """Mean absolute deviation of the reconstruction, normalized by the
    signal's RMS — the library-wide round-trip accuracy criterion."""
    x = _host(x)
    err = np.mean(np.abs(_host(xrec) - x))
    rms = np.sqrt(np.mean(np.square(x)))
    return err / rms
