# -*- coding: utf-8 -*-
"""Shared helpers: logging, numeric constants, padding geometry.

Counterpart of `ssqueezepy_tpu/utils/common.py` (own copy: this package
imports nothing of the JAX package).
"""
import logging
import numpy as np

__all__ = ['WARN', 'NOTE', 'pi', 'EPS32', 'EPS64', 'assert_is_one_of',
           'p2up']

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
