# -*- coding: utf-8 -*-
"""The ridge dynamic program, `csrc/ridge_dp.cu`, and its plain PyTorch
versions.

The port's counterpart of the JAX package's XLA program
`ssqueezepy_tpu/models/ridge_extraction.py::_fw_bw_jit` (no Pallas
kernel): over the penalized energy e (B, T, F), time-major, and the
penalty matrix P[f, g] = penalty * (v_f - v_g)^2 of the row coordinates v
(F,),

  * `ridge_forward`: pe[:, 0] = e[:, 0], then
    pe[:, t, f] = e[:, t, f] + min_g (pe[:, t-1, g] + P[f, g]);
  * `ridge_trace`: r[T-1] = argmin_f pe[T-1]; for t = T-2 .. 0 the last f
    with |val - (pe[t, f] + P[r[t+1], f])| < eps, val = pe[t+1, r[t+1]] -
    e[t+1, r[t+1]], else argmin_f pe[t] (first occurrence).

Each wrapper launches its kernel for CUDA tensors (one launch for the
whole batch: one block per row) and runs its plain version, a loop over
t that mirrors `_fw_bw_jit` step by step, for CPU tensors; on the card
the plain versions are the kernels' oracle. `ridge_forward.launches` and
`ridge_trace.launches` count the launches. `ridge_rule` bounds F (the
kernels' rows in one block's shared memory), checked on every device. Design and bound are noted in the source.
"""
import torch

from ..utils.common import not_ported
from . import _build
from .ssq_cuda import _on_card

__all__ = ['ridge_forward', 'ridge_forward_plain', 'ridge_trace',
           'ridge_trace_plain', 'ridge_penalty', 'ridge_rule']

# shared bytes a block may take (the card's limit is 227 KB)
_SMEM_MAX = 220 * 1024


def ridge_rule(F, itemsize):
    """The ridge kernels' rule on the rows, checked on every device: the
    forward's v and two rows (padded to a multiple of 4) and the trace's
    v and two double-buffered rows of pe and e fit one block's shared
    memory: F <= 11264 in float32, 5632 in float64."""
    need = max(3 * ((F + 3) & ~3), 5 * F) * itemsize
    if need > _SMEM_MAX:
        not_ported("the ridge kernels at F=%d rows of %d-byte elements "
                   "(%d B of shared memory per block)" % (F, itemsize, need),
                   'C1b')


def ridge_penalty(v, penalty):
    """P (F, F) = penalty * ((v_f - v_g) * (v_f - v_g)) in v's type, the
    JAX package's `penalty * np.subtract.outer(v, v) ** 2` bit for bit."""
    d = v.reshape(-1, 1) - v.reshape(1, -1)
    return torch.as_tensor(penalty, dtype=v.dtype, device=v.device) * (d * d)


def _check(e, v, what):
    if e.dim() != 3 or v.shape != (e.shape[-1],):
        raise ValueError("%s takes e (B, T, F) and v (F,) (got %s, %s)"
                         % (what, tuple(e.shape), tuple(v.shape)))
    if e.dtype not in (torch.float32, torch.float64) or v.dtype != e.dtype:
        raise TypeError("e and v must be float32 or float64 of one type "
                        "(got %s, %s)" % (e.dtype, v.dtype))
    if e.device != v.device:
        raise ValueError("e and v must be on one device")
    if not (e.is_contiguous() and v.is_contiguous()):
        raise ValueError("e and v must be contiguous")
    ridge_rule(e.shape[-1], e.element_size())


def ridge_forward_plain(e, v, penalty):
    """Plain version: `_fw_bw_jit`'s forward scan, one step per column."""
    P = ridge_penalty(v, penalty)
    pe = torch.empty_like(e)
    prev = pe[:, 0] = e[:, 0]
    for t in range(1, e.shape[1]):
        prev = pe[:, t] = e[:, t] + torch.amin(prev[:, None, :] + P, dim=-1)
    return pe


def ridge_forward(e, v, penalty):
    """pe (B, T, F) of the forward pass over e (B, T, F) real, time-major,
    with the row coordinates v (F,) of e's type and `penalty` a float
    (rounded to e's type)."""
    _check(e, v, 'ridge_forward')
    if e.device.type == 'cpu':
        return ridge_forward_plain(e, v, penalty)
    _on_card(e, 'ridge_forward')
    lib = _build.load('ridge_dp')
    B, T, F = e.shape
    pe = torch.empty_like(e)
    fn = (lib.ridge_forward_f32 if e.dtype == torch.float32
          else lib.ridge_forward_f64)
    err = fn(e.data_ptr(), v.data_ptr(), float(penalty), B, F, T,
             pe.data_ptr(), torch.cuda.current_stream(e.device).cuda_stream)
    _build.check(err, 'ridge_forward')
    ridge_forward.launches += 1
    return pe


ridge_forward.launches = 0


def ridge_trace_plain(pe, e, v, penalty, eps):
    """Plain version: `_fw_bw_jit`'s reverse scan, one step per column."""
    P = ridge_penalty(v, penalty)
    B, T, F = pe.shape
    eps = torch.as_tensor(eps, dtype=pe.dtype, device=pe.device)
    fw = torch.argmin(pe, dim=-1)                            # (B, T)
    rows = torch.arange(B, device=pe.device)
    f_rev = torch.arange(F - 1, -1, -1, device=pe.device)
    ridge = torch.empty((B, T), dtype=torch.int64, device=pe.device)
    nxt = ridge[:, T - 1] = fw[:, T - 1]
    for t in range(T - 2, -1, -1):
        val = pe[rows, t + 1, nxt] - e[rows, t + 1, nxt]
        cond = torch.abs(val[:, None] - (pe[:, t] + P[nxt])) < eps
        # the last f that qualifies, else the forward argmin
        last = f_rev[torch.argmax(cond.flip(-1).to(torch.uint8), dim=-1)]
        nxt = ridge[:, t] = torch.where(cond.any(-1), last, fw[:, t])
    return ridge


def ridge_trace(pe, e, v, penalty, eps):
    """ridge (B, T) int64 of the backward trace over pe and e (B, T, F),
    time-major, with v (F,), `penalty` and `eps` floats (rounded to pe's
    type)."""
    _check(e, v, 'ridge_trace')
    if pe.shape != e.shape or pe.dtype != e.dtype or \
            pe.device != e.device or not pe.is_contiguous():
        raise ValueError("pe must be contiguous, of e's shape, type and "
                         "device")
    if pe.device.type == 'cpu':
        return ridge_trace_plain(pe, e, v, penalty, eps)
    _on_card(pe, 'ridge_trace')
    lib = _build.load('ridge_dp')
    B, T, F = pe.shape
    ridge = torch.empty((B, T), dtype=torch.int32, device=pe.device)
    fn = (lib.ridge_trace_f32 if pe.dtype == torch.float32
          else lib.ridge_trace_f64)
    err = fn(pe.data_ptr(), e.data_ptr(), v.data_ptr(), float(penalty),
             float(eps), B, F, T, ridge.data_ptr(),
             torch.cuda.current_stream(pe.device).cuda_stream)
    _build.check(err, 'ridge_trace')
    ridge_trace.launches += 1
    return ridge.long()


ridge_trace.launches = 0
