# -*- coding: utf-8 -*-
"""Reassignment scatter from precomputed bins: the kernel
`csrc/scatter_kv.cu` and its plain PyTorch version.

Replaces `ssqueezepy_tpu/ops/ssq_pallas.py::_make_kv_kernel` +
`_shift_scatter_core` (`scatter_kv_direct`):

    Tx[k[i, j], j] += Wx[i, j] * const[i]     for 0 <= k[i, j] <= nbins-1

Each CUDA thread owns one time column and sums its rows in order into
shared memory, so the result is bit-identical from run to run (design
and bound are noted in the source).

`scatter_kv` launches the kernel for CUDA tensors and runs
`scatter_kv_plain` for CPU tensors; `scatter_kv.launches` counts kernel
launches.
"""
import torch

from . import _build
from .ssq_kernels import scatter_plain

__all__ = ['scatter_kv', 'scatter_kv_plain']

_SMEM_BUDGET = 200 * 1024


def _check(Wx, k, const):
    if Wx.dim() != 2 or k.shape != Wx.shape:
        raise ValueError("Wx and k must be (na, N) of one shape (got %s, %s)"
                         % (tuple(Wx.shape), tuple(k.shape)))
    if const.shape != (Wx.shape[0],):
        raise ValueError("const must be (na,) (got %s)"
                         % (tuple(const.shape),))
    if not (Wx.device == k.device == const.device):
        raise ValueError("Wx, k and const must be on one device")
    rdt = {torch.complex64: torch.float32,
           torch.complex128: torch.float64}.get(Wx.dtype)
    if rdt is None or const.dtype != rdt or k.dtype != torch.int32:
        raise TypeError("dtypes: complex Wx, int32 k and const of Wx's real "
                        "type (got %s, %s, %s)"
                        % (Wx.dtype, k.dtype, const.dtype))
    if not (Wx.is_contiguous() and k.is_contiguous()
            and const.is_contiguous()):
        raise ValueError("Wx, k and const must be contiguous")


def scatter_kv_plain(Wx, k, const, nbins):
    """Plain version: `index_put_` with accumulate."""
    return scatter_plain(Wx * const.reshape(-1, 1), k, nbins)


def scatter_kv(Wx, k, const, nbins):
    """Tx (nbins, N) complex from Wx (na, N) complex, bins k (na, N)
    int32 (any k outside [0, nbins) dropped) and per-row const (na,)."""
    _check(Wx, k, const)
    if Wx.device.type == 'cpu':
        return scatter_kv_plain(Wx, k, const, nbins)
    if Wx.device.type != 'cuda':
        raise RuntimeError("scatter_kv runs on CUDA or CPU tensors (got %s)"
                           % Wx.device)
    lib = _build.load('scatter_kv')
    na, N = Wx.shape
    tc = 32
    while tc > 1 and nbins * tc * Wx.element_size() > _SMEM_BUDGET:
        tc //= 2
    if nbins * tc * Wx.element_size() > _SMEM_BUDGET:
        raise NotImplementedError("nbins=%d exceeds the kernel's shared "
                                  "memory accumulator" % nbins)
    Tx = torch.empty((nbins, N), dtype=Wx.dtype, device=Wx.device)
    fn = (lib.scatter_kv_f32 if Wx.dtype == torch.complex64
          else lib.scatter_kv_f64)
    err = fn(Wx.data_ptr(), k.data_ptr(), const.data_ptr(), na, N, nbins,
             tc, Tx.data_ptr(), torch.cuda.current_stream(Wx.device)
             .cuda_stream)
    _build.check(err, 'scatter_kv')
    scatter_kv.launches += 1
    return Tx


scatter_kv.launches = 0
