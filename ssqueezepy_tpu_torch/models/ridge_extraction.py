# -*- coding: utf-8 -*-
"""Time-frequency ridge extraction (forward-backward penalized tracking).

Counterpart of `ssqueezepy_tpu/models/ridge_extraction.py`. Per ridge:
the energy |Tf|^2, its per-column normalisation -log(E / max + eps) and
the kill of +-bw rows around each found ridge run in torch on Tf's
device; the dynamic program (the JAX package's `_fw_bw_jit`, a `lax.scan`
over time with a min-plus F x F step and a reverse scan for the trace)
runs in the ridge kernels on the card (`ops/ridge_cuda.py`: one forward
and one trace launch per ridge for the whole batch) and in their plain
versions on the CPU. The row coordinates (log scales for the CWT, the
frequencies for the STFT) and the penalty are host numpy, as the JAX
package makes them.
"""
import numpy as np
import torch

from ..ops.ridge_cuda import ridge_forward, ridge_trace
from ..toolkit import _host
from ..utils.common import EPS32, EPS64, resolve_device, to_device

__all__ = ['extract_ridges']


def _normalized(energy, eps, dtype):
    """The DP's input: -log(E / max_f E + eps) of energy (B, F, T) per
    column, in `dtype`, time-major (B, T, F)."""
    emax = energy.amax(dim=-2, keepdim=True)
    e = -torch.log(energy / emax + eps)
    return e.to(dtype).transpose(-1, -2).contiguous()


def extract_ridges(Tf, scales, penalty=2., n_ridges=1, bw=15,
                   transform='cwt', get_params=False, parallel=True,
                   device='cuda'):
    """Track `n_ridges` maximum-energy ridges of `Tf` (numpy or a tensor,
    complex or real): 2-D (na, T) returns `ridge_idxs` (T, n_ridges), a
    batch (B, na, T) returns (B, T, n_ridges), numpy int64. `scales` are
    the rows' scales (`transform='cwt'`, penalized in log) or frequencies
    ('stft'). `get_params` adds `ridge_f` (the rows' scales along each
    ridge) and `ridge_e` (their energy), numpy. `Tf` is moved to `device`
    (the kernels on 'cuda', their plain versions on 'cpu'); `parallel` is
    accepted for compatibility."""
    device = resolve_device(device)
    Tf = to_device(Tf, device)
    double = Tf.dtype == torch.complex128
    eps = float(EPS64 if double else EPS32)
    np_dtype = np.float64 if double else np.float32
    dtype = torch.float64 if double else torch.float32
    a = Tf.abs()
    energy = a * a

    was_2d = energy.dim() == 2
    if was_2d:
        energy = energy[None]
    B, n_rows, n_cols = energy.shape

    scales = np.asarray(_host(scales), dtype=np_dtype)
    scales_orig = scales.squeeze()
    v = (np.log(scales) if transform == 'cwt' else scales).reshape(-1)
    v = torch.as_tensor(v, device=device)
    rows = torch.arange(n_rows, device=device)[:, None]     # (na, 1)

    ridges, ridge_e = [], []
    for _ in range(n_ridges):
        e = _normalized(energy, eps, dtype)
        pe = ridge_forward(e, v, penalty)
        ridge = ridge_trace(pe, e, v, penalty, eps)          # (B, T)
        ridges.append(ridge)
        if get_params:
            ridge_e.append(torch.gather(energy, 1, ridge[:, None])[:, 0])
        # zero +-bw rows around each found ridge for the next extraction
        kill = (rows >= ridge[:, None, :] - bw) & \
               (rows < ridge[:, None, :] + bw)              # (B, na, T)
        energy = energy.masked_fill(kill, 0)

    ridge_idxs = torch.stack(ridges, dim=-1).cpu().numpy()
    if get_params:
        ridge_f = scales_orig[ridge_idxs].astype(np_dtype)
        ridge_e = torch.stack(ridge_e, dim=-1).cpu().numpy().astype(
            np_dtype)
    if was_2d:
        ridge_idxs = ridge_idxs[0]
        if get_params:
            ridge_f, ridge_e = ridge_f[0], ridge_e[0]
    return ((ridge_idxs, ridge_f, ridge_e) if get_params else ridge_idxs)
