# -*- coding: utf-8 -*-
"""Three-axis sharded synchrosqueezed CWT over ('batch', 'scale', 'time').

Counterpart of `ssqueezepy_tpu/parallel/full_sharded.py`: the composition
of the scale-sharded and the time-sharded plans in one plan. Per rank of
a (batch, scale, time) mesh:

  * the halo exchange along 'time' (`time_sharded._TimeSharded._extend`:
    one `all_gather` of the edges; reflection at the signal's ends);
  * the CWT of its `row_block` of the interior rows (the rows that ride
    overlap-save) on its extended chunk: the bins mode of the CWT kernel
    (B1 / B3b), then the scatter from bins (B2) into the full bin space
    for its columns;
  * the exact rows (over-support and Nyquist-ringing scales) from the
    all-gathered global signal at its columns, replicated over 'scale'
    (they are few) with their squeeze constant divided by the 'scale'
    size: the derivative mode (B3), then B4;
  * one sum over 'scale' (`collectives.psum`) completes the bins.

A wavelet off the CWT kernel's route, or a window's n_up past its rule,
runs `cwt_general` and B4 on the interior rows too; bins past the
reassignment kernels' rule take `scatter_general` in B2's place and
`ssq_fused_general` in B4's (`time_sharded._TimeSharded`'s routes).
"""
import numpy as np
import torch
import torch.distributed as dist

from .collectives import dim_size, psum
from .distributed import init_distributed
from .mesh import build_mesh
from .sharded import no_rows, scale_rows
from .time_sharded import _TimeSharded

__all__ = ['FullShardedSSQCWT', 'make_mesh3']


def make_mesh3(batch=1, scale=None, time=None, device_type='cuda'):
    """Mesh over ('batch', 'scale', 'time'); a missing size takes what the
    others leave (with neither 'scale' nor 'time', all on 'scale')."""
    init_distributed(device_type=device_type)
    n = dist.get_world_size()
    if scale is None and time is None:
        scale, time = n // batch, 1
    elif scale is None:
        scale = n // (batch * time)
    elif time is None:
        time = n // (batch * scale)
    return build_mesh(('batch', 'scale', 'time'), (batch, scale, time),
                      device_type)


class FullShardedSSQCWT(_TimeSharded):
    """Plan for a batch x scale x time sharded ssq_cwt, made on every rank
    of a ('batch', 'scale', 'time') mesh.

    x: the global (B, N); B divisible by the 'batch' size, N by the 'time'
    size. Returns this rank's Tx (B_local, nbins, C), its columns
    [i C, (i + 1) C), the same on every rank of its 'scale' group;
    `plan.gather(Tx)` puts the global (B, nbins, N) together.
    `deriv_lowprec` is taken for the JAX signature."""

    def __init__(self, N, wavelet='gmw', scales='log', nv=32, fs=1.,
                 halo=None, halo_mult=8.0, maprange='peak', flipud=True,
                 gamma=None, mesh=None, deriv_lowprec=None):
        mesh = mesh if mesh is not None else make_mesh3()
        self._init_time(N, wavelet, scales, nv, fs, halo, halo_mult,
                        maprange, flipud, gamma, mesh)
        self.n_scale = dim_size(mesh, 'scale')
        self._group = mesh.get_group('scale')
        sc, c = self._tensor(self.scales_np), self._tensor(self.const_np)
        lo, hi = scale_rows(mesh, self.n_hi - self.n_lo)
        self._mid = sc[self.n_lo + lo:self.n_lo + hi]
        self._mid_const = c[self.n_lo + lo:self.n_lo + hi]
        ex = torch.as_tensor(np.r_[0:self.n_lo, self.n_hi:len(sc)],
                             dtype=torch.long, device=self.device)
        self.n_exact = len(ex)
        self._exact = sc[ex]
        self._exact_const = c[ex] / self.n_scale

    def __call__(self, x):
        xc = self._chunk(x)
        # every rank of the 'time' group exchanges its edges, whatever its
        # block of rows
        src = self._interior(xc)
        if len(self._mid) and self._kernel:
            Wx, k = self._bins(*src, self._mid)
            Tx = self._scatter(Wx.contiguous(), k.contiguous(),
                               self._mid_const)
        elif len(self._mid):
            Wx, dWx = self._planes(*src, self._mid)
            Tx = self._fused(Wx.contiguous(), dWx.contiguous(),
                             self._mid_const)
        else:
            Tx = no_rows(xc, (xc.shape[0], self.nbins, self.C))
        if self.n_exact:
            Wg, dWg = self._planes(*self._global(xc), self._exact)
            Tx = Tx + self._fused(Wg.contiguous(), dWg.contiguous(),
                                  self._exact_const)
        return psum(Tx, self._group)
