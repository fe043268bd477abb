# -*- coding: utf-8 -*-
"""The reassignment kernels and their plain PyTorch versions.

  * `scatter_kv` (B2), `csrc/scatter_kv.cu`, from precomputed bins;
    replaces `ssqueezepy_tpu/ops/ssq_pallas.py::_make_kv_kernel` +
    `_shift_scatter_core` (`scatter_kv_direct`, `scatter_kv_pallas`):

        Tx[k[i, j], j] += Wx[i, j] * const[i]     for 0 <= k[i, j] < nbins

  * `ssq_fused` (B4), `csrc/scatter_kv.cu`, the phase transform, the bin
    map and the same scatter in one pass over (Wx, dWx), the bins never
    written out; replaces `ssqueezepy_tpu/ops/ssq_pallas.py::
    _make_fused_kernel` (`ssq_fused_pallas`).

  * `shift_scatter` (B5), `csrc/scatter_kv.cu`, the generic scatter over
    cells marked valid, a negative bin wrapped once as numpy indexing
    does; replaces `ssqueezepy_tpu/ops/ssq_pallas.py::
    _make_scatter_kernel` (`shift_scatter_pallas`):

        k' = k + nbins where k < 0
        out[k'[i, j], j] += v[i, j] * const[i]   for valid[i, j],
                                                  0 <= k'[i, j] < nbins

    so k = -1 lands in bin nbins - 1, where B2 drops it.

All three take one signal (na, N) or a batch (B, na, N), the batch in one
launch. Each time column's rows are summed in order into shared memory by
its own thread (B4: by two, one per real and imaginary part), so the
results are bit-identical from run to run (design and bound are noted in
the source). All three feed the rows through a ring of asynchronous
copies laid out by `scatter_plan`.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version for CPU tensors. Where autograd records and a floating input
requires grad, it runs the same launch through its
`torch.autograd.Function` (`ScatterKvGrad`, `SsqFusedGrad`,
`ShiftScatterGrad`; base `ops/adjoint.py::Adjoint`), the counterparts of
the JAX package's `_scatter_kv_vjp_fn`, `_ssq_fused_vjp_fn` and
`_scatter_vjp_fn`: the backward is the gradient of the plain version
(torch ops on the tensors' device), the adjoint gather of the forward's
bins; `scatter_kv.launches`, `ssq_fused.launches` and
`shift_scatter.launches` count kernel launches. `scatter_rule` bounds
the bins of all three (one column's accumulator in shared memory),
checked on every device by each wrapper and by the synchrosqueezing
models before their transforms run.
"""
import ctypes
import itertools
from collections import namedtuple

import torch

from ..utils.common import not_ported
from . import _build
from .adjoint import Adjoint, needs_grad
from .cwt_cuda import _MODES, _bin_args
from .phase import phase_transform_w
from .ssq_kernels import compute_bins, scatter_plain

__all__ = ['scatter_kv', 'scatter_kv_plain', 'ssq_fused', 'ssq_fused_plain',
           'shift_scatter', 'shift_scatter_plain', 'scatter_plan',
           'scatter_launch_plan', 'scatter_rule', 'ScatterKvGrad',
           'SsqFusedGrad', 'ShiftScatterGrad']

_SMEM_BUDGET = 200 * 1024
_MAX_BATCH = 65535

# The ring of B2, B4 and B5: the bytes of one block's row of values (one
# 128-byte line) and the bytes of copies to keep in flight per SM. The
# H100 sweeps (scripts/torch_scatter_sweep.py, PERF.md section 6) found
# more resident columns worth more than a deeper ring: past ~16 KB in
# flight, a stage that costs a block loses.
_ROW_BYTES = 128
_INFLIGHT = 16 * 1024
_CUDA_INVALID_VALUE = 1    # cudaErrorInvalidValue

ScatterPlan = namedtuple('ScatterPlan', 'columns stages smem blocks_per_sm '
                                        'inflight')
_plans = {}


def _check_planes(Wx, other, const, what):
    """Common checks: Wx (na, N) or (B, na, N) complex, `other` of its
    shape, const (na,) of its real type (or None), one device,
    contiguous."""
    if Wx.dim() not in (2, 3) or other.shape != Wx.shape:
        raise ValueError("Wx and %s must be (na, N) or (B, na, N) of one "
                         "shape (got %s, %s)" % (what, tuple(Wx.shape),
                                                 tuple(other.shape)))
    if Wx.dim() == 3 and not 1 <= Wx.shape[0] <= _MAX_BATCH:
        raise ValueError("batch size must lie in [1, %d] (got %d)"
                         % (_MAX_BATCH, Wx.shape[0]))
    rdt = {torch.complex64: torch.float32,
           torch.complex128: torch.float64}.get(Wx.dtype)
    if rdt is None:
        raise TypeError("Wx must be complex64 or complex128 (got %s)"
                        % Wx.dtype)
    if Wx.device != other.device:
        raise ValueError("Wx and %s must be on one device" % what)
    if not (Wx.is_contiguous() and other.is_contiguous()):
        raise ValueError("Wx and %s must be contiguous" % what)
    if const is None:
        return
    if const.shape != (Wx.shape[-2],):
        raise ValueError("const must be (na,) (got %s)"
                         % (tuple(const.shape),))
    if const.device != Wx.device:
        raise ValueError("Wx, %s and const must be on one device" % what)
    if const.dtype != rdt:
        raise TypeError("dtypes: complex Wx and const of Wx's real type "
                        "(got %s, %s)" % (Wx.dtype, const.dtype))
    if not const.is_contiguous():
        raise ValueError("const must be contiguous")


def scatter_rule(nbins, itemsize):
    """The reassignment kernels' one rule on the bins, checked on every
    device: one column's accumulator of `nbins` complex elements of
    `itemsize` bytes within `_SMEM_BUDGET` (25600 bins in complex64, 12800
    in complex128: `ssq_stft` up to n_fft ~51200 or ~25600); beyond it
    raises naming C1b."""
    if nbins * itemsize > _SMEM_BUDGET:
        not_ported("a scatter over nbins=%d of %d-byte elements in the "
                   "CUDA reassignment kernels (one column's accumulator "
                   "exceeds the block's shared memory)" % (nbins, itemsize),
                   'C1b')


def scatter_plan(nbins, itemsize, occupancy):
    """B2/B4/B5's launch plan for an (nbins, columns) accumulator of complex
    `itemsize` bytes. `occupancy(columns, stages)` gives the shared bytes
    of a block and the blocks per SM the card grants it (0 where the
    block does not fit or the kernel takes no such ring): on the card the
    kernel's own figures (`scatter_launch_plan`).
    Returns a `ScatterPlan` of the columns per block, the ring's stages,
    the block's shared bytes, its blocks per SM and the bytes of copies in
    flight per SM, (stages - 1) x (bytes of a stage) x blocks.

    Columns: one 128-byte line of values per row (16 in complex64, 8 in
    complex128), halved while a two-stage ring does not fit. Stages: the
    fewest that keep `_INFLIGHT` bytes in flight; where none does, those
    that keep the most. An accumulator column over 200 KB raises
    (`scatter_rule`)."""
    scatter_rule(nbins, itemsize)
    columns = _ROW_BYTES // itemsize
    while columns > 1 and occupancy(columns, 2)[1] < 1:
        columns //= 2
    stage = occupancy(columns, 3)[0] - occupancy(columns, 2)[0]
    best = None
    for stages in itertools.count(2):
        smem, blocks = occupancy(columns, stages)
        if blocks < 1:
            break
        plan = ScatterPlan(columns, stages, smem, blocks,
                           (stages - 1) * stage * blocks)
        if plan.inflight >= _INFLIGHT:
            return plan
        if best is None or plan.inflight > best.inflight:
            best = plan
    return best


def scatter_launch_plan(kind, nbins, itemsize, device):
    """`scatter_plan` on the card for kernel `kind` (0: B2; 1-4: B5 with
    mask and const, mask only, const only, neither; 5-6: B4 without and
    with Sfs), from the kernel's shared bytes and the runtime's blocks per
    SM (`scatter_occupancy` of `csrc/scatter_kv.cu`); computed once per
    shape and device."""
    key = (kind, nbins, itemsize, device)
    plan = _plans.get(key)
    if plan is None:
        lib = _build.load('scatter_kv')

        def occupancy(columns, stages):
            blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
            err = lib.scatter_occupancy(kind, int(itemsize == 16), nbins,
                                        columns, stages, ctypes.byref(blocks),
                                        ctypes.byref(smem))
            if err != _CUDA_INVALID_VALUE:      # that one: does not fit
                _build.check(err, 'scatter_occupancy')
            return smem.value, blocks.value
        plan = _plans[key] = scatter_plan(nbins, itemsize, occupancy)
    return plan


def _shift_kind(valid, const):
    """B5's kernel for a mask and a const, each given or None."""
    return (1 if const is not None else 2) if valid is not None else (
        3 if const is not None else 4)


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
    scatter_rule(nbins, Wx.element_size())
    if not needs_grad(Wx, const):
        return _scatter_kv_run(Wx, k, const, nbins)
    return ScatterKvGrad.apply(
        lambda *a: (_scatter_kv_run(*a, nbins),),
        lambda *a: (scatter_kv_plain(*a, nbins),), Wx, k, const)[0]


def _scatter_kv_run(Wx, k, const, nbins):
    if Wx.device.type == 'cpu':
        return scatter_kv_plain(Wx, k, const, nbins)
    _on_card(Wx, 'scatter_kv')
    lib = _build.load('scatter_kv')
    na, N = Wx.shape[-2:]
    B = Wx.shape[0] if Wx.dim() == 3 else 1
    p = scatter_launch_plan(0, nbins, Wx.element_size(), Wx.device)
    Tx = torch.empty(Wx.shape[:-2] + (nbins, N), dtype=Wx.dtype,
                     device=Wx.device)
    fn = (lib.scatter_kv_f32 if Wx.dtype == torch.complex64
          else lib.scatter_kv_f64)
    err = fn(Wx.data_ptr(), k.data_ptr(), const.data_ptr(), B, na, N, nbins,
             p.columns, p.stages, Tx.data_ptr(),
             torch.cuda.current_stream(Wx.device).cuda_stream)
    _build.check(err, 'scatter_kv')
    scatter_kv.launches += 1
    return Tx


class ScatterKvGrad(Adjoint):
    """`scatter_kv` (B2) under autograd. Backward: the gradient of
    `scatter_kv_plain` with respect to Wx and const, the adjoint gather
    on the forward's own k (JAX: `_scatter_kv_vjp_fn`)."""


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
    scatter_rule(nbins, Wx.element_size())

    def plain(Wx, dWx, const, Sfs):
        return (ssq_fused_plain(Wx, dWx, const, params, gamma, flipud,
                                Sfs),)

    def run(Wx, dWx, const, Sfs):
        if Wx.device.type == 'cpu':
            return plain(Wx, dWx, const, Sfs)
        return (_ssq_fused_launch(Wx, dWx, const, params, gamma, flipud,
                                  Sfs),)

    if not needs_grad(Wx, dWx, const, Sfs):
        return run(Wx, dWx, const, Sfs)[0]
    return SsqFusedGrad.apply(run, plain, Wx, dWx, const, Sfs)[0]


class SsqFusedGrad(Adjoint):
    """`ssq_fused` (B4) under autograd. Backward: the gradient of
    `ssq_fused_plain` with respect to Wx, dWx, const (and Sfs): the
    adjoint gather on bins that the plain bin map recomputes, as the JAX
    package's `xla_ref` does (`_ssq_fused_vjp_fn`), so a cell whose bin
    the kernel placed across a boundary (<= 1% of cells in float32 on
    white noise) reads its neighbour's cotangent; dWx enters only through
    the bins and gets no gradient."""


def _ssq_fused_launch(Wx, dWx, const, params, gamma, flipud, Sfs):
    nbins = params['omax'] + 1
    _on_card(Wx, 'ssq_fused')
    lib = _build.load('scatter_kv')
    na, N = Wx.shape[-2:]
    B = Wx.shape[0] if Wx.dim() == 3 else 1
    p = scatter_launch_plan(5 if Sfs is None else 6, nbins,
                            Wx.element_size(), Wx.device)
    Tx = torch.empty(Wx.shape[:-2] + (nbins, N), dtype=Wx.dtype,
                     device=Wx.device)
    a0, d0, a1, d1, idx1 = _bin_args(params)
    ip = (ctypes.c_int * 10)(B, na, N, nbins, p.columns, p.stages,
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


def shift_scatter_plain(v, k, valid, nbins, const=None):
    """Plain version: the wrap, then `index_put_` with accumulate (the
    twin of `ssqueezepy_tpu/ops/ssq_kernels.py::_scatter_xla`)."""
    if const is not None:
        v = v * const.reshape(-1, 1)
    k = torch.where(k < 0, k + nbins, k)
    if valid is not None:
        k = torch.where(valid, k, torch.full_like(k, -1))
    return scatter_plain(v, k, nbins)


def shift_scatter(v, k, valid, nbins, const=None):
    """out (nbins, N) complex from values v (na, N) complex, bins k
    (na, N) int32, the mask valid (na, N) bool or None (all valid) and
    per-row const (na,) or None (1); or out (B, nbins, N) from a
    (B, na, N) batch of v, k and valid. A negative k is wrapped once
    (k + nbins); a cell still outside [0, nbins), or not valid, is
    dropped."""
    _check_planes(v, k, const, 'k')
    if k.dtype != torch.int32:
        raise TypeError("k must be int32 (got %s)" % k.dtype)
    if valid is not None:
        if valid.shape != v.shape or valid.dtype != torch.bool:
            raise ValueError("valid must be a bool tensor of v's shape")
        if valid.device != v.device or not valid.is_contiguous():
            raise ValueError("valid must be contiguous, on v's device")
    scatter_rule(nbins, v.element_size())
    if not needs_grad(v, const):
        return _shift_scatter_run(v, k, valid, nbins, const)
    return ShiftScatterGrad.apply(
        lambda v, k, valid, const: (
            _shift_scatter_run(v, k, valid, nbins, const),),
        lambda v, k, valid, const: (
            shift_scatter_plain(v, k, valid, nbins, const),),
        v, k, valid, const)[0]


class ShiftScatterGrad(Adjoint):
    """`shift_scatter` (B5) under autograd. Backward: the gradient of
    `shift_scatter_plain` with respect to v (and const where given), the
    adjoint gather on the forward's own wrapped bins and mask (JAX:
    `_scatter_vjp_fn`)."""


def _shift_scatter_run(v, k, valid, nbins, const):
    if v.device.type == 'cpu':
        return shift_scatter_plain(v, k, valid, nbins, const)
    _on_card(v, 'shift_scatter')
    lib = _build.load('scatter_kv')
    na, N = v.shape[-2:]
    B = v.shape[0] if v.dim() == 3 else 1
    p = scatter_launch_plan(_shift_kind(valid, const), nbins,
                            v.element_size(), v.device)
    out = torch.empty(v.shape[:-2] + (nbins, N), dtype=v.dtype,
                      device=v.device)
    fn = (lib.shift_scatter_f32 if v.dtype == torch.complex64
          else lib.shift_scatter_f64)
    err = fn(v.data_ptr(), k.data_ptr(),
             None if valid is None else valid.data_ptr(),
             None if const is None else const.data_ptr(), B, na, N, nbins,
             p.columns, p.stages, out.data_ptr(),
             torch.cuda.current_stream(v.device).cuda_stream)
    _build.check(err, 'shift_scatter')
    shift_scatter.launches += 1
    return out


shift_scatter.launches = 0
