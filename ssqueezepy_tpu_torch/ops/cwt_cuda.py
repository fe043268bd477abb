# -*- coding: utf-8 -*-
"""Fused CWT kernels in `csrc/cwt_bins.cu` and their plain PyTorch
versions. All replace modes of `ssqueezepy_tpu/ops/cwt_pallas.py::
_make_kernel`:

  * `cwt_bins` (B1), its bins + direct mode (`cwt_fused_bins_direct`):
    from the half spectrum of the padded signal, Wx (na, N) complex and
    the reassignment bin plane k (na, N) int32, k = -1 on gamma-gated
    cells; dWx stays inside the kernel. Over a batch of spectra (B3b,
    the bins mode of `cwt_fused_bins_pallas`) it returns Wx and k
    (B, na, N), each row bit-identical to its signal run alone.
  * `cwt_fused` (B3), its plain/derivative mode (`cwt_fused_pallas`):
    Wx, and dWx when asked, for one spectrum (na, N) or a batch of them
    (B, na, N); L1 or L2 (sqrt(scale)) row norm.
  * `cwt_bins2` (B8), its order-2 mode (`cwt_fused_bins2_direct`): the
    five WSST2 banks, the per-cell chirp regression and the bin map ->
    (W, k); the four auxiliary transforms stay inside the kernel.

The inverse DFT is computed in the kernel itself (four-step, radix 2 in
shared memory); design and bound are noted in the source.

Each wrapper launches the kernel for CUDA tensors and runs its plain
version for CPU tensors. `cwt_bins.launches` (one signal),
`cwt_bins.batched_launches` (a batch), `cwt_fused.launches` and
`cwt_bins2.launches` count calls of the C entry point (one per chunk of
rows); each such call issues two CUDA launches, stage 1 and stage 2.
"""
import ctypes
import math

import torch

from ..models.wavelets import _xifn
from . import _build
from .fft import ifft
from .phase import cdiv, cmul, div_tiny

__all__ = ['cwt_bins', 'cwt_bins_plain', 'cwt_fused', 'cwt_fused_plain',
           'cwt_bins2', 'cwt_bins2_plain', 'wsst2_rows', 'four_step']

_MODES = {'lin': 0, 'log': 1, 'log-piecewise': 2}
# stage-1 scratch held at once (all planes); rows are chunked beyond it
_SCRATCH_BUDGET = 2 << 30
_SMEM_BUDGET = 96 * 1024
_MAX_GRID_Y = 65535
_OUT_BINS, _OUT_W, _OUT_W_DW, _OUT_BINS2 = 0, 1, 2, 3
_PLANES = {_OUT_BINS: 2, _OUT_W: 1, _OUT_W_DW: 2, _OUT_BINS2: 5}
_TWO_PI = 6.283185307179586


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


def _columns(L, other, itemsize, planes=2):
    """Columns per block: a power of two <= 8 dividing `other`, within
    the shared-memory budget for `planes` planes of length L."""
    P = min(8, other)
    while P > 1 and (L // 2 + planes * P * L) * itemsize > _SMEM_BUDGET:
        P //= 2
    if (L // 2 + planes * P * L) * itemsize > _SMEM_BUDGET:
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


def _check(xh, scales, n_up, n1, N, batched=False):
    if (xh.dim() not in ((1, 2) if batched else (1,))
            or xh.shape[-1] != n_up // 2 + 1):
        raise ValueError("xh must be the (n_up//2 + 1,) half spectrum%s "
                         "(got %s)" % (" or a (B, n_up//2 + 1) batch"
                                       if batched else "",
                                       tuple(xh.shape)))
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
    `phase_transform_w` and `compute_bins`; one spectrum or a batch."""
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
    the padded signal, (n_up//2 + 1,) or a (B, n_up//2 + 1) batch; Wx
    and k are (na, N) or (B, na, N). `scales` (na,) real, `wavelet` a GMW
    `Wavelet`, `params` from `ssq_bin_params`; output columns are
    [n1, n1+N) of the padded transform."""
    _check(xh, scales, n_up, n1, N, batched=True)
    if xh.device.type == 'cpu':
        return cwt_bins_plain(xh, scales, wavelet, n_up, n1, N, dt, l1_norm,
                              params, gamma, flipud)
    if xh.device.type != 'cuda':
        raise RuntimeError("cwt_bins runs on CUDA or CPU tensors (got %s)"
                           % xh.device)
    shape = xh.shape[:-1] + (scales.shape[0], N)
    Wx = torch.empty(shape, dtype=xh.dtype, device=xh.device)
    k = torch.empty(shape, dtype=torch.int32, device=xh.device)
    _launch(cwt_bins, xh, scales, wavelet, n_up, n1, N, dt, l1_norm,
            _OUT_BINS, Wx, k, params, gamma, flipud,
            counter='batched_launches' if xh.dim() == 2 else 'launches')
    return Wx, k


cwt_bins.launches = 0
cwt_bins.batched_launches = 0


def _launch(wrapper, xh, scales, wavelet, n_up, n1, N, dt, l1_norm,
            out_mode, Wx, out2, params=None, gamma=0., flipud=False,
            counter='launches'):
    """Run the two-launch kernel over every row of `Wx` (B * na, N),
    chunking rows to the scratch budget; counts each C call on the
    wrapper's attribute `counter`."""
    kp = getattr(wavelet.fn, 'kernel_params', None)
    if kp is None:
        raise NotImplementedError("the CUDA CWT kernel synthesizes GMW "
                                  "(order 0) only; ROADMAP.md queue A, A2b")
    lib = _build.load('cwt_bins')
    f32 = scales.dtype == torch.float32
    itemsize = xh.element_size()
    planes = _PLANES[out_mode]
    f1, f2 = four_step(n_up)
    P1 = _columns(f1, f2, itemsize, planes)
    P2 = _columns(f2, f1, itemsize, planes)
    na = scales.shape[0]
    n_all = Wx.numel() // N
    dev = xh.device
    rows = max(1, min(n_all, _MAX_GRID_Y,
                      _SCRATCH_BUDGET // (planes * n_up * itemsize)))
    scratch = torch.empty((planes, rows, n_up), dtype=xh.dtype, device=dev)
    if params is None:
        mode, idx1, omax, bin_args = 0, 0, 0, (0., 1., 0., 1.)
    else:
        a0, d0, a1, d1, idx1 = _bin_args(params)
        mode, omax, bin_args = _MODES[params['mode']], params['omax'], \
            (a0, d0, a1, d1)
    dp = (ctypes.c_double * 14)(
        2 * math.pi / n_up, 1.0 / dt, gamma, kp['logconst'], kp['amp'],
        kp['gamma'], kp['beta'], kp['wc'], *bin_args, div_tiny(xh.dtype),
        _TWO_PI * dt)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn = lib.cwt_bins_f32 if f32 else lib.cwt_bins_f64
    for row0 in range(0, n_all, rows):
        nr = min(rows, n_all - row0)
        ip = (ctypes.c_int * 20)(
            n_up, f1, f2, f1.bit_length() - 1, f2.bit_length() - 1,
            n_up // 2 + 1, n1, N, P1, P2, nr, row0, int(bool(l1_norm)),
            mode, int(idx1), int(omax), int(bool(flipud)), out_mode, planes,
            na)
        err = fn(xh.data_ptr(), scales.data_ptr(), ip, dp,
                 scratch.data_ptr(), Wx.data_ptr(),
                 None if out2 is None else out2.data_ptr(), stream)
        _build.check(err, wrapper.__name__)
        setattr(wrapper, counter, getattr(wrapper, counter) + 1)


def cwt_fused_plain(xh, scales, wavelet, n_up, n1, N, dt, derivative,
                    l1_norm):
    """Plain version: `cwt_core` (torch.fft.ifft)."""
    from ..models.cwt import cwt_core
    Wx, dWx = cwt_core(xh, wavelet, scales, n_up, n1, N, dt, derivative,
                       l1_norm)
    return Wx.contiguous(), (None if dWx is None else dWx.contiguous())


def cwt_fused(xh, scales, wavelet, n_up, n1, N, dt, derivative, l1_norm):
    """(Wx, dWx or None) of the CWT from the half spectrum `xh` of the
    padded signal, (n_up//2 + 1,) or a (B, n_up//2 + 1) batch; Wx and
    dWx are (na, N) or (B, na, N). `scales` (na,) real, `wavelet` a GMW
    `Wavelet`; output columns are [n1, n1+N) of the padded transform;
    `l1_norm=False` multiplies rows by sqrt(scale)."""
    _check(xh, scales, n_up, n1, N, batched=True)
    if xh.device.type == 'cpu':
        return cwt_fused_plain(xh, scales, wavelet, n_up, n1, N, dt,
                               derivative, l1_norm)
    if xh.device.type != 'cuda':
        raise RuntimeError("cwt_fused runs on CUDA or CPU tensors (got %s)"
                           % xh.device)
    shape = xh.shape[:-1] + (scales.shape[0], N)
    Wx = torch.empty(shape, dtype=xh.dtype, device=xh.device)
    dWx = torch.empty_like(Wx) if derivative else None
    _launch(cwt_fused, xh, scales, wavelet, n_up, n1, N, dt, l1_norm,
            _OUT_W_DW if derivative else _OUT_W, Wx, dWx)
    return Wx, dWx


cwt_fused.launches = 0


def wsst2_rows(xh, scales, wavelet, n_up, n1, N, dt, gamma):
    """(W, w2) of the second-order CWT, step by step with torch.fft (the
    XLA twin `_wsst2_rows` of `ssqueezepy_tpu/models/ssq_cwt2.py`): the
    five banks W = psih xh, A = i xi psih xh, B = i a psih' xh,
    Bd = -xi a psih' xh, C = -a^2 psih'' xh on the half spectrum (Nyquist
    bin halved in all five), one inverse FFT kept to [n1, n1+N), then
    p2 = (Bd W - A B) / (B^2 - C W), p1 = (A + p2 B) / W (regularized
    divides) and w2 = |Im p1| / (2 pi dt), inf where not finite or where
    |W|^2 <= gamma^2."""
    half = n_up // 2 + 1
    xi = torch.as_tensor(_xifn(1., n_up)[:half], dtype=scales.dtype,
                         device=scales.device)
    a = scales.reshape(-1, 1)
    w = a * xi
    psih = wavelet.fn(w, xp=torch)
    d1, d2 = wavelet.fn.derivatives(w)
    if n_up % 2 == 0:
        for p in (psih, d1, d2):
            p[:, half - 1] /= 2                     # Nyquist halving
    tb, t2b = a * d1, (a * a) * d2
    xr, xim = xh.real, xh.imag
    re = torch.stack([psih * xr, -xi * (psih * xim), -(tb * xim),
                      -xi * (tb * xr), -(t2b * xr)])
    im = torch.stack([psih * xim, xi * (psih * xr), tb * xr,
                      -xi * (tb * xim), -(t2b * xim)])
    W, A, B, Bd, C = ifft(torch.complex(re, im), n=n_up,
                          out_range=(n1, n1 + N))
    tiny = div_tiny(xh.dtype)
    p2 = cdiv(cmul(Bd, W) - cmul(A, B), cmul(B, B) - cmul(C, W), tiny)
    p1 = cdiv(A + cmul(p2, B), W, tiny)
    w2 = p1.imag.abs() / (_TWO_PI * dt)
    inf = torch.full_like(w2, float('inf'))
    w2 = torch.where(torch.isfinite(w2), w2, inf)
    big = W.real * W.real + W.imag * W.imag > \
        torch.tensor(gamma, dtype=w2.dtype) ** 2
    return W.contiguous(), torch.where(big, w2, inf)


def cwt_bins2_plain(xh, scales, wavelet, n_up, n1, N, dt, params, gamma,
                    flipud):
    """Plain version: `wsst2_rows`, then `compute_bins` on w2."""
    from .ssq_kernels import compute_bins
    W, w2 = wsst2_rows(xh, scales, wavelet, n_up, n1, N, dt, gamma)
    k, valid = compute_bins(w2, params, flipud)
    return W, torch.where(valid, k, torch.full_like(k, -1))


def cwt_bins2(xh, scales, wavelet, n_up, n1, N, dt, params, gamma, flipud):
    """(W, k) of the second-order synchrosqueezed CWT (WSST2) from the
    half spectrum `xh` of the padded signal: W (na, N) the L1 CWT, k
    (na, N) int32 the bin of the chirp-corrected frequency w2, -1 on
    gamma-gated or non-finite cells. Arguments as `cwt_bins`."""
    _check(xh, scales, n_up, n1, N)
    if xh.device.type == 'cpu':
        return cwt_bins2_plain(xh, scales, wavelet, n_up, n1, N, dt,
                               params, gamma, flipud)
    if xh.device.type != 'cuda':
        raise RuntimeError("cwt_bins2 runs on CUDA or CPU tensors (got %s)"
                           % xh.device)
    W = torch.empty((scales.shape[0], N), dtype=xh.dtype, device=xh.device)
    k = torch.empty((scales.shape[0], N), dtype=torch.int32,
                    device=xh.device)
    _launch(cwt_bins2, xh, scales, wavelet, n_up, n1, N, dt, True,
            _OUT_BINS2, W, k, params, gamma, flipud)
    return W, k


cwt_bins2.launches = 0
