# -*- coding: utf-8 -*-
"""Sharded (multi-rank) inverse transforms.

Counterpart of `ssqueezepy_tpu/parallel/inverse.py`. The forward plans
leave Wx distributed over the 'scale' dimension of the mesh (each rank
its `row_block` of rows) and Tx replicated over it; the one-integral
inverse CWT's scale sum is then one sum over 'scale' (`collectives.psum`)
of each rank's weighted rows, with no gather of the (B, na, N) plane, and
the inverse synchrosqueezed CWT's bin sum the same over each rank's block
of bin rows. The log-piecewise grid needs no recursion: the split of the
integral at the grid's transition equals per-scale quadrature weights
ln(2)/nv_i, folded into one weighted row sum.
"""
import numpy as np
import torch

from ..models.cwt import resolve_wavelet
from ..utils.common import numpy_unless_grad, to_device
from ..utils.cwt_utils import adm_ssq, nv_from_scales, process_scales
from .collectives import dim_size, gather_shards, psum
from .mesh import make_mesh, mesh_device
from .sharded import scale_rows

__all__ = ['sharded_icwt', 'sharded_issq_cwt']


def _icwt_row_weights(scales, scaletype, nv, l1_norm, wavelet):
    """Per-scale quadrature weights of the one-integral inverse,
    ``x = sum_i w_i * Re(Wx_i)``: the admissibility constant, the grid
    measure (ln2/nv for log grids, per scale for log-piecewise, pi/4 for
    linear) and the scale normalization."""
    scales = np.asarray(scales).squeeze()
    Cpsi = adm_ssq(wavelet)
    if scaletype == 'log-piecewise':
        meas = (np.log(2) / nv_from_scales(scales)).squeeze()
    elif scaletype.startswith('log'):
        meas = np.full(len(scales), np.log(2) / nv)
    else:
        meas = np.full(len(scales), np.pi / 4)
    if l1_norm:
        nrm = (np.ones(len(scales)) if scaletype.startswith('log')
               else scales)
    else:
        nrm = (scales ** .5 if scaletype.startswith('log')
               else scales ** 1.5)
    return (2 / Cpsi) * meas / nrm


def _weighted_row_psum(shard, weights, mesh):
    """``sum_i w_i * Re(shard[:, i, :])`` over this rank's rows, summed
    over 'scale', then put together over 'batch': the global (B, N)."""
    shard = shard if isinstance(shard, torch.Tensor) else to_device(
        np.asarray(shard), mesh_device(mesh))
    if shard.dim() == 2:
        shard = shard[None]
    re = shard.real if shard.is_complex() else shard
    w = torch.as_tensor(np.asarray(weights), dtype=re.dtype,
                        device=re.device)
    part = torch.einsum('brn,r->bn', re, w)
    x = psum(part, mesh.get_group('scale'))
    return gather_shards(x, mesh, {'batch': (
        0, x.shape[0] * dim_size(mesh, 'batch'))})


def _own_rows(mesh, n, shape_rows, what):
    lo, hi = scale_rows(mesh, n)
    if shape_rows is not None and shape_rows != hi - lo:
        raise ValueError("%s holds %d rows; this rank's block of %d is "
                         "[%d, %d)" % (what, shape_rows, n, lo, hi))
    return lo, hi


def sharded_icwt(Wx, wavelet='gmw', scales='log-piecewise', nv=None,
                 x_len=None, x_mean=0, l1_norm=True, mesh=None):
    """One-integral inverse CWT with the scale sum as one sum over the
    'scale' dimension of `mesh`. `Wx` is this rank's shard (B_local,
    hi - lo, N), rows [lo, hi) = its `row_block` of the scales, as
    `ShardedSSQCWT` returns it (complex tensor or numpy). Returns the
    global (B, N) on every rank: numpy, or a tensor carrying the graph for
    a `Wx` that requires grad.

    `x_mean` is added once (the one-device log-piecewise recursion adds it
    once per piece)."""
    mesh = mesh if mesh is not None else make_mesh()
    N = Wx.shape[-1]
    x_len = x_len or N
    wavelet = resolve_wavelet(wavelet, l1_norm)
    if not isinstance(scales, np.ndarray) and nv is None:
        nv = 32
    scales, scaletype, _, nv = process_scales(scales, x_len, wavelet, nv=nv,
                                              get_params=True)
    lo, hi = _own_rows(mesh, len(scales), Wx.shape[-2], 'Wx')
    w = _icwt_row_weights(scales, scaletype, nv, l1_norm, wavelet)
    return numpy_unless_grad(_weighted_row_psum(Wx, w[lo:hi], mesh)) \
        + x_mean


def sharded_issq_cwt(Tx, wavelet='gmw', mesh=None):
    """Full inverse synchrosqueezed CWT ``x = Re(sum_bins Tx) * 2/Css``,
    each rank summing its `row_block` of the bins of this rank's `Tx`
    (B_local, nbins, N) (replicated over 'scale', as `ShardedSSQCWT`
    returns it), one sum over 'scale'. Masked component inversion stays
    on the one-device `issq_cwt`. Returns the global (B, N) on every rank,
    as `sharded_icwt` does."""
    mesh = mesh if mesh is not None else make_mesh()
    lo, hi = _own_rows(mesh, Tx.shape[-2], None, 'Tx')
    Css = adm_ssq(resolve_wavelet(wavelet, l1_norm=True))
    return numpy_unless_grad(_weighted_row_psum(
        Tx[..., lo:hi, :], np.full(hi - lo, 2 / Css), mesh))
