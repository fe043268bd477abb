# -*- coding: utf-8 -*-
"""Persistent plan cache: the numeric plans of `ssq_cwt` / `ssq_cwt2`
(scale grid, ssq frequency grid, squeeze constant, bin-map parameters),
whose host-side construction costs ~0.1-1 s cold (scale-bound searches,
redundancy scans, center-frequency integrals), kept on disk from one
process to the next. Host only: nothing here touches a device.

Counterpart of `ssqueezepy_tpu/utils/plan_cache.py` (own copy: this
package imports nothing of the JAX package). Entries are .npz files
under `$SSQ_TPU_TORCH_CACHE` (default `~/.cache/ssqueezepy_tpu_torch`),
keyed by a hash of the plan spec, which the caller prefixes with this
package's name. Every failure degrades silently to recomputation.
"""
import hashlib
import json
import os
import threading

import numpy as np

__all__ = ['disk_memo', 'cache_dir']

_VERSION = 1
_lock = threading.Lock()
# kinds of a stored entry
_NONE, _SCALAR, _ARRAY, _JSON = 0, 1, 2, 3


def cache_dir():
    return os.environ.get('SSQ_TPU_TORCH_CACHE',
                          os.path.join(os.path.expanduser('~'), '.cache',
                                       'ssqueezepy_tpu_torch'))


def _path(key_obj):
    h = hashlib.sha256(repr((_VERSION, key_obj)).encode()).hexdigest()[:24]
    return os.path.join(cache_dir(), 'plan_%s.npz' % h)


def _load(path):
    with np.load(path, allow_pickle=False) as z:
        out = []
        for i in range(int(z['__n'])):
            kind = int(z['__kind%d' % i])
            if kind == _NONE:
                out.append(None)
            elif kind == _SCALAR:
                out.append(z['v%d' % i].item())
            elif kind == _JSON:
                out.append(json.loads(str(z['v%d' % i])))
            else:
                out.append(z['v%d' % i])
        return tuple(out)


def _store(path, out):
    payload = {'__n': np.asarray(len(out))}
    for i, v in enumerate(out):
        if v is None:
            payload['__kind%d' % i] = np.asarray(_NONE)
        elif isinstance(v, (str, dict, list, bool)):
            payload['__kind%d' % i] = np.asarray(_JSON)
            payload['v%d' % i] = np.asarray(json.dumps(v))
        elif np.isscalar(v) or getattr(v, 'ndim', None) == 0:
            payload['__kind%d' % i] = np.asarray(_SCALAR)
            payload['v%d' % i] = np.asarray(v)
        else:
            payload['__kind%d' % i] = np.asarray(_ARRAY)
            payload['v%d' % i] = np.asarray(v)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = '%s.tmp%d.npz' % (path[:-4], os.getpid())
    with _lock:
        np.savez(tmp, **payload)
        os.replace(tmp, path)


def disk_memo(key_obj, build):
    """build() with transparent on-disk memoization. `build` returns
    a tuple of numpy arrays, scalars, JSON-able values (str, dict, list,
    bool) or None; the structure comes back as it was (a scalar as a
    Python number, a dict through JSON)."""
    path = _path(key_obj)
    try:
        if os.path.exists(path):
            return _load(path)
    except Exception:
        pass
    out = build()
    try:
        _store(path, out)
    except Exception:
        pass
    return out
