# -*- coding: utf-8 -*-
"""Fused CWT + phase transform + bin map: the kernel `csrc/cwt_bins.cu`
and its plain PyTorch version.

Replaces `ssqueezepy_tpu/ops/cwt_pallas.py::_make_kernel` in bins +
direct mode (`cwt_fused_bins_direct`). From the half spectrum of the
padded signal it returns Wx (na, N) complex and the reassignment bin
plane k (na, N) int32, k = -1 on gamma-gated cells; dWx stays inside the
kernel. The inverse DFT is computed in the kernel itself (four-step,
radix 2 in shared memory); design and bound are noted in the source.

`cwt_bins` launches the kernel for CUDA tensors and runs `cwt_bins_plain`
for CPU tensors. `cwt_bins.launches` counts calls of the C entry point
(one per chunk of rows); each such call issues two CUDA launches, stage 1
and stage 2.
"""
import ctypes
import math

import torch

from . import _build

__all__ = ['cwt_bins', 'cwt_bins_plain', 'four_step']

_MODES = {'lin': 0, 'log': 1, 'log-piecewise': 2}
# stage-1 scratch held at once (two planes); rows are chunked beyond it
_SCRATCH_BUDGET = 2 << 30
_SMEM_BUDGET = 96 * 1024


def four_step(n_up):
    """(f1, f2) with n_up = f1 * f2, both powers of two, f1 >= f2."""
    lg = int(n_up).bit_length() - 1
    if n_up < 4 or (1 << lg) != n_up:
        raise NotImplementedError(
            "the CUDA CWT kernel takes a power-of-two padded length >= 4 "
            "(got %d); other lengths wait for ROADMAP.md queue A, A6b"
            % n_up)
    f1 = 1 << ((lg + 1) // 2)
    return f1, n_up // f1


def _columns(L, other, itemsize):
    """Columns per block: a power of two <= 8 dividing `other`, within
    the shared-memory budget for two planes of length L."""
    P = min(8, other)
    while P > 1 and (L // 2 + 2 * P * L) * itemsize > _SMEM_BUDGET:
        P //= 2
    if (L // 2 + 2 * P * L) * itemsize > _SMEM_BUDGET:
        raise NotImplementedError("DFT factor %d exceeds shared memory" % L)
    return P


def _bin_args(params):
    mode = params['mode']
    if mode == 'lin':
        return params['vmin'], params['dv'], 0., 1., 0
    if mode == 'log':
        return params['vlmin'], params['dvl'], 0., 1., 0
    return (params['vlmin0'], params['dvl0'], params['vlmin1'],
            params['dvl1'], params['idx1'])


def _check(xh, scales, n_up, n1, N):
    if xh.dim() != 1 or xh.shape[0] != n_up // 2 + 1:
        raise ValueError("xh must be the (n_up//2 + 1,) half spectrum "
                         "(got %s)" % (tuple(xh.shape),))
    if not (n1 >= 0 and N >= 1 and n1 + N <= n_up):
        raise ValueError("output span [n1, n1+N) = [%d, %d) must lie in "
                         "[0, n_up=%d)" % (n1, n1 + N, n_up))
    if scales.dim() != 1:
        raise ValueError("scales must be 1-D (na,)")
    if xh.device != scales.device:
        raise ValueError("xh and scales must be on one device")
    cdt = {torch.float32: torch.complex64,
           torch.float64: torch.complex128}.get(scales.dtype)
    if cdt is None or xh.dtype != cdt:
        raise TypeError("dtypes: scales float32/float64 with xh of the "
                        "matching complex type (got %s, %s)"
                        % (scales.dtype, xh.dtype))
    if not (xh.is_contiguous() and scales.is_contiguous()):
        raise ValueError("xh and scales must be contiguous")


def cwt_bins_plain(xh, scales, wavelet, n_up, n1, N, dt, l1_norm, params,
                   gamma, flipud):
    """Plain version: `cwt_core` (torch.fft.ifft) for Wx and dWx, then
    `phase_transform_w` and `compute_bins`."""
    from ..models.cwt import cwt_core
    from .phase import phase_transform_w
    from .ssq_kernels import compute_bins
    Wx, dWx = cwt_core(xh, wavelet, scales, n_up, n1, N, dt, True, l1_norm)
    w = phase_transform_w(Wx, dWx, gamma)
    k, valid = compute_bins(w, params, flipud)
    return Wx.contiguous(), torch.where(valid, k, torch.full_like(k, -1))


def cwt_bins(xh, scales, wavelet, n_up, n1, N, dt, l1_norm, params, gamma,
             flipud):
    """(Wx, k) of the synchrosqueezed CWT from the half spectrum `xh` of
    the padded signal. `scales` (na,) real, `wavelet` a GMW `Wavelet`,
    `params` from `ssq_bin_params`; output columns are [n1, n1+N) of the
    padded transform."""
    _check(xh, scales, n_up, n1, N)
    if xh.device.type == 'cpu':
        return cwt_bins_plain(xh, scales, wavelet, n_up, n1, N, dt, l1_norm,
                              params, gamma, flipud)
    if xh.device.type != 'cuda':
        raise RuntimeError("cwt_bins runs on CUDA or CPU tensors (got %s)"
                           % xh.device)
    kp = getattr(wavelet.fn, 'kernel_params', None)
    if kp is None:
        raise NotImplementedError("the CUDA CWT kernel synthesizes GMW "
                                  "(order 0) only; ROADMAP.md queue A, A2b")
    lib = _build.load('cwt_bins')
    f32 = scales.dtype == torch.float32
    itemsize = xh.element_size()
    f1, f2 = four_step(n_up)
    P1, P2 = _columns(f1, f2, itemsize), _columns(f2, f1, itemsize)
    na = scales.shape[0]
    dev = xh.device
    Wx = torch.empty((na, N), dtype=xh.dtype, device=dev)
    k = torch.empty((na, N), dtype=torch.int32, device=dev)
    rows = max(1, min(na, _SCRATCH_BUDGET // (2 * n_up * itemsize)))
    scratch = torch.empty((2, rows, n_up), dtype=xh.dtype, device=dev)
    a0, d0, a1, d1, idx1 = _bin_args(params)
    dp = (ctypes.c_double * 12)(
        2 * math.pi / n_up, 1.0 / dt, gamma, kp['logconst'], kp['amp'],
        kp['gamma'], kp['beta'], kp['wc'], a0, d0, a1, d1)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn = lib.cwt_bins_f32 if f32 else lib.cwt_bins_f64
    for row0 in range(0, na, rows):
        nr = min(rows, na - row0)
        ip = (ctypes.c_int * 17)(
            n_up, f1, f2, f1.bit_length() - 1, f2.bit_length() - 1,
            n_up // 2 + 1, n1, N, P1, P2, nr, row0, int(bool(l1_norm)),
            _MODES[params['mode']], int(idx1), int(params['omax']),
            int(bool(flipud)))
        err = fn(xh.data_ptr(), scales.data_ptr(), ip, dp,
                 scratch.data_ptr(), Wx.data_ptr(), k.data_ptr(), stream)
        _build.check(err, 'cwt_bins')
        cwt_bins.launches += 1
    return Wx, k


cwt_bins.launches = 0
