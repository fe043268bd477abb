# -*- coding: utf-8 -*-
"""Shared helpers: logging, numeric constants, padding geometry, the
entry points' device rule.

Counterpart of `ssqueezepy_tpu/utils/common.py` (own copy: this package
imports nothing of the JAX package).
"""
import logging
import numpy as np
import torch

__all__ = ['WARN', 'NOTE', 'pi', 'EPS32', 'EPS64', 'assert_is_one_of',
           'p2up', 'not_ported', 'check_batch', 'resolve_device',
           'to_device', 'numpy_unless_grad']

_logger = logging.getLogger('ssqueezepy_tpu_torch')


def WARN(msg):
    _logger.warning("WARNING: %s" % msg)


def NOTE(msg):
    _logger.warning("NOTE: %s" % msg)


pi = np.pi
EPS32 = np.finfo(np.float32).eps
EPS64 = np.finfo(np.float64).eps


def assert_is_one_of(x, name, supported, e=ValueError):
    if x not in supported:
        opts = ', '.join(map(str, supported))
        raise e(f"`{name}` must be one of: {opts} (got {x})")


def p2up(n):
    """Next power of 2 by ssqueezepy's rounding rule, with left/right pad
    lengths centering the original `n` samples. The rule is
    `2**(1 + round(log2(n)))`, so it can jump two octaves above for `n`
    just under a power of 2 — kept exactly, since the plan must match.
    """
    total = int(2 ** (1 + np.round(np.log2(n))))
    right = (total - n) // 2
    left = total - n - right
    return total, int(left), int(right)


def not_ported(what, item):
    """Raise for a call outside the ported slices, naming its item of
    ROADMAP.md; the item's letter (A, B or C) names its queue."""
    queue = item[0]
    raise NotImplementedError("%s is not ported yet (ROADMAP.md queue %s, "
                              "%s)" % (what, queue, item))


def check_batch(ndim, get_w=False):
    """An entry point's input is a signal (N,) or a batch (B, N);
    `get_w=True` on a batch raises, as in the JAX package."""
    if ndim not in (1, 2):
        raise ValueError("`x` must be 1D or 2D (got x.ndim == %s)" % ndim)
    if ndim == 2 and get_w:
        raise NotImplementedError("`get_w=True` unsupported with batched "
                                  "input.")


def resolve_device(device):
    """torch.device for an entry point; a CUDA request without a CUDA
    device raises (the entry points never fall back to the CPU)."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("device=%r requested but no CUDA device is "
                           "available; pass device='cpu' to run the plain "
                           "PyTorch versions on the CPU" % str(device))
    if device.type not in ('cuda', 'cpu'):
        raise ValueError("device must be 'cuda' or 'cpu' (got %s)" % device)
    return device


def to_device(x, device):
    """`x` (a tensor, numpy array or array-like) as a tensor on `device`;
    a read-only numpy array is copied first (torch takes no read-only
    memory)."""
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.copy()
    return torch.as_tensor(x, device=device)


def numpy_unless_grad(t):
    """An inverse's result: `t` as numpy on the host, or `t` itself (on
    its device) where autograd records and it requires grad, so that a
    loss through the inverse stays differentiable."""
    if torch.is_grad_enabled() and t.requires_grad:
        return t
    return t.cpu().numpy()
