# -*- coding: utf-8 -*-
"""The reassignment kernels and their plain PyTorch versions.

  * `scatter_kv` (B2), `csrc/scatter_kv.cu`, from precomputed bins;
    replaces `ssqueezepy_tpu/ops/ssq_pallas.py::_make_kv_kernel` +
    `_shift_scatter_core` (`scatter_kv_direct`, `scatter_kv_pallas`):

        Tx[k[i, j], j] += Wx[i, j] * const[i]     for 0 <= k[i, j] < nbins

  * `ssq_fused` (B4), `csrc/ssq_fused.cu`, the phase transform, the bin
    map and the same scatter in one pass over (Wx, dWx), the bins never
    written out; replaces `ssqueezepy_tpu/ops/ssq_pallas.py::
    _make_fused_kernel` (`ssq_fused_pallas`).

Both take one signal (na, N) or a batch (B, na, N), the batch in one
launch. Each CUDA thread owns one time column and sums its rows in order
into shared memory, so the results are bit-identical from run to run
(design and bound are noted in the sources).

Each wrapper launches its kernel for CUDA tensors and runs its plain
version for CPU tensors; `scatter_kv.launches` and `ssq_fused.launches`
count kernel launches.
"""
import ctypes

import torch

from . import _build
from .cwt_cuda import _MODES, _bin_args
from .phase import phase_transform_w
from .ssq_kernels import compute_bins, scatter_plain

__all__ = ['scatter_kv', 'scatter_kv_plain', 'ssq_fused', 'ssq_fused_plain']

_SMEM_BUDGET = 200 * 1024
_MAX_BATCH = 65535


def _check_planes(Wx, other, const, what):
    """Common checks: Wx (na, N) or (B, na, N) complex, `other` of its
    shape, const (na,) of its real type, one device, contiguous."""
    if Wx.dim() not in (2, 3) or other.shape != Wx.shape:
        raise ValueError("Wx and %s must be (na, N) or (B, na, N) of one "
                         "shape (got %s, %s)" % (what, tuple(Wx.shape),
                                                 tuple(other.shape)))
    if Wx.dim() == 3 and not 1 <= Wx.shape[0] <= _MAX_BATCH:
        raise ValueError("batch size must lie in [1, %d] (got %d)"
                         % (_MAX_BATCH, Wx.shape[0]))
    if const.shape != (Wx.shape[-2],):
        raise ValueError("const must be (na,) (got %s)"
                         % (tuple(const.shape),))
    if not (Wx.device == other.device == const.device):
        raise ValueError("Wx, %s and const must be on one device" % what)
    rdt = {torch.complex64: torch.float32,
           torch.complex128: torch.float64}.get(Wx.dtype)
    if rdt is None or const.dtype != rdt:
        raise TypeError("dtypes: complex Wx and const of Wx's real type "
                        "(got %s, %s)" % (Wx.dtype, const.dtype))
    if not (Wx.is_contiguous() and other.is_contiguous()
            and const.is_contiguous()):
        raise ValueError("Wx, %s and const must be contiguous" % what)


def _columns(nbins, itemsize):
    """Columns per block: the largest power of two <= 32 whose (nbins,
    columns) complex accumulator fits the shared-memory budget."""
    tc = 32
    while tc > 1 and nbins * tc * itemsize > _SMEM_BUDGET:
        tc //= 2
    if nbins * tc * itemsize > _SMEM_BUDGET:
        raise NotImplementedError("nbins=%d exceeds the kernel's shared "
                                  "memory accumulator" % nbins)
    return tc


def _on_card(Wx, name):
    if Wx.device.type != 'cuda':
        raise RuntimeError("%s runs on CUDA or CPU tensors (got %s)"
                           % (name, Wx.device))


def scatter_kv_plain(Wx, k, const, nbins):
    """Plain version: `index_put_` with accumulate."""
    return scatter_plain(Wx * const.reshape(-1, 1), k, nbins)


def scatter_kv(Wx, k, const, nbins):
    """Tx (nbins, N) complex from Wx (na, N) complex, bins k (na, N)
    int32 (any k outside [0, nbins) dropped) and per-row const (na,); or
    Tx (B, nbins, N) from a (B, na, N) batch of Wx and k."""
    _check_planes(Wx, k, const, 'k')
    if k.dtype != torch.int32:
        raise TypeError("k must be int32 (got %s)" % k.dtype)
    if Wx.device.type == 'cpu':
        return scatter_kv_plain(Wx, k, const, nbins)
    _on_card(Wx, 'scatter_kv')
    lib = _build.load('scatter_kv')
    na, N = Wx.shape[-2:]
    B = Wx.shape[0] if Wx.dim() == 3 else 1
    tc = _columns(nbins, Wx.element_size())
    Tx = torch.empty(Wx.shape[:-2] + (nbins, N), dtype=Wx.dtype,
                     device=Wx.device)
    fn = (lib.scatter_kv_f32 if Wx.dtype == torch.complex64
          else lib.scatter_kv_f64)
    err = fn(Wx.data_ptr(), k.data_ptr(), const.data_ptr(), B, na, N, nbins,
             tc, Tx.data_ptr(), torch.cuda.current_stream(Wx.device)
             .cuda_stream)
    _build.check(err, 'scatter_kv')
    scatter_kv.launches += 1
    return Tx


scatter_kv.launches = 0


def ssq_fused_plain(Wx, dWx, const, params, gamma, flipud, Sfs=None):
    """Plain version: `phase_transform_w` (with `Sfs`), `compute_bins`,
    then `scatter_kv_plain` with the gated cells dropped."""
    w = phase_transform_w(Wx, dWx, gamma, Sfs)
    k, valid = compute_bins(w, params, flipud)
    k = torch.where(valid, k, torch.full_like(k, -1))
    return scatter_kv_plain(Wx, k, const, params['omax'] + 1)


def ssq_fused(Wx, dWx, const, params, gamma, flipud, Sfs=None):
    """Tx (nbins, N) from Wx, dWx (na, N) complex, or (B, nbins, N) from
    (B, na, N) batches: per cell w = |Im(dWx / Wx)| / 2pi (|Sfs[i] - .|
    with `Sfs` (na,) given), gated to |Wx| > gamma, binned by `params`
    (`ssq_bin_params`, nbins = omax + 1) with `flipud`, and
    Tx[k, j] += Wx[i, j] * const[i]."""
    _check_planes(Wx, dWx, const, 'dWx')
    if Sfs is not None and (Sfs.shape != const.shape
                            or Sfs.dtype != const.dtype
                            or Sfs.device != Wx.device
                            or not Sfs.is_contiguous()):
        raise ValueError("Sfs must be a contiguous (na,) tensor of Wx's "
                         "real type on its device")
    nbins = params['omax'] + 1
    if Wx.device.type == 'cpu':
        return ssq_fused_plain(Wx, dWx, const, params, gamma, flipud, Sfs)
    _on_card(Wx, 'ssq_fused')
    lib = _build.load('ssq_fused')
    na, N = Wx.shape[-2:]
    B = Wx.shape[0] if Wx.dim() == 3 else 1
    tc = _columns(nbins, Wx.element_size())
    Tx = torch.empty(Wx.shape[:-2] + (nbins, N), dtype=Wx.dtype,
                     device=Wx.device)
    a0, d0, a1, d1, idx1 = _bin_args(params)
    ip = (ctypes.c_int * 10)(B, na, N, nbins, tc, int(Sfs is not None),
                             _MODES[params['mode']], int(idx1),
                             int(params['omax']), int(bool(flipud)))
    dp = (ctypes.c_double * 5)(gamma, a0, d0, a1, d1)
    fn = (lib.ssq_fused_f32 if Wx.dtype == torch.complex64
          else lib.ssq_fused_f64)
    err = fn(Wx.data_ptr(), dWx.data_ptr(), const.data_ptr(),
             None if Sfs is None else Sfs.data_ptr(), ip, dp, Tx.data_ptr(),
             torch.cuda.current_stream(Wx.device).cuda_stream)
    _build.check(err, 'ssq_fused')
    ssq_fused.launches += 1
    return Tx


ssq_fused.launches = 0
