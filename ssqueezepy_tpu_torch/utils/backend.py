# -*- coding: utf-8 -*-
"""Array-backend dispatch between numpy (host) and torch (any device).

Counterpart of `ssqueezepy_tpu/utils/backend.py`, the reference
library's numpy/torch layer: a call takes torch where an argument (or
`like`) is a tensor, numpy otherwise. `S` carries the helpers, `Q.foo(x)`
resolves to `torch.foo` or `np.foo` per call. `asnumpy` brings a tensor
on any device to the host.
"""
import numpy as np
import torch

__all__ = ['S', 'Q', 'is_tensor', 'is_dtype', 'asnumpy']


def _xp_of(*xs):
    return torch if any(isinstance(x, torch.Tensor) for x in xs) else np


def _torch_kw(dtype, like):
    """dtype (a name, numpy or torch dtype) and device for torch."""
    kw = {}
    if dtype is not None:
        kw['dtype'] = (dtype if isinstance(dtype, torch.dtype)
                       else getattr(torch, np.dtype(dtype).name))
    if isinstance(like, torch.Tensor):
        kw['device'] = like.device
    return kw


def is_tensor(x):
    """True for a torch tensor."""
    return isinstance(x, torch.Tensor)


def is_dtype(x, str_dtype):
    return str_dtype in str(getattr(x, 'dtype', ''))


def asnumpy(x):
    """`x` as a numpy array on the host (a tensor detached and copied
    from its device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class _S:
    """numpy/torch helpers of the reference library's backend."""

    @staticmethod
    def asarray(x, dtype=None, like=None):
        if _xp_of(x, like) is torch:
            return torch.as_tensor(x, **_torch_kw(dtype, like))
        return np.asarray(x, dtype=dtype)

    array = asarray

    @staticmethod
    def zeros(shape, dtype=None, like=None):
        if _xp_of(like) is torch:
            return torch.zeros(shape, **_torch_kw(dtype, like))
        return np.zeros(shape, dtype=dtype)

    @staticmethod
    def ones(shape, dtype=None, like=None):
        if _xp_of(like) is torch:
            return torch.ones(shape, **_torch_kw(dtype, like))
        return np.ones(shape, dtype=dtype)

    @staticmethod
    def arange(*args, like=None, **kw):
        if _xp_of(like) is torch:
            dtype = kw.pop('dtype', None)
            return torch.arange(*args, **kw, **_torch_kw(dtype, like))
        return np.arange(*args, **kw)

    @staticmethod
    def vstack(xs):
        return _xp_of(*xs).vstack(xs)

    @staticmethod
    def atleast_1d(x):
        return _xp_of(x).atleast_1d(x)

    @staticmethod
    def astype(x, dtype):
        if isinstance(x, torch.Tensor):
            return x.to(**_torch_kw(dtype, None))
        return x.astype(dtype)

    is_tensor = staticmethod(is_tensor)
    is_dtype = staticmethod(is_dtype)
    asnumpy = staticmethod(asnumpy)


S = _S()


class _Q:
    """`Q.foo(*args)`: `torch.foo` where an argument is a tensor, else
    `np.foo`."""

    def __getattr__(self, name):
        def fn(*args, **kw):
            return getattr(_xp_of(*args), name)(*args, **kw)
        return fn


Q = _Q()
