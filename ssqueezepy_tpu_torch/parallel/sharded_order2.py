# -*- coding: utf-8 -*-
"""Scale-sharded second-order synchrosqueezed CWT (WSST2).

Counterpart of `ssqueezepy_tpu/parallel/sharded_order2.py`. The per-cell
chirp regression couples only the five transforms of one scale row, so
scale sharding is as first order's: each rank runs the CWT kernel's
order-2 bins mode (B8, `ops/cwt_cuda.py::cwt_bins2`: the five banks, the
regression and the bins of w2 in one launch pair) on its `row_block` of
the scales, scatters its partial Tx into the full bin space (B2), and one
sum over 'scale' completes the reassignment. (The JAX package runs its
XLA twin `_wsst2_rows` and `compute_bins` here; B8's bins equal the bins
of that w2.)
"""
from ..models.cwt import cwt_spectrum
from ..models.ssq_cwt2 import _supports_order2
from ..ops.cwt_cuda import cwt_bins2
from ..ops.ssq_cuda import scatter_kv
from ..streaming import _one_signal, _rebatch
from .sharded import ShardedSSQCWT

__all__ = ['ShardedSSQCWT2']


class ShardedSSQCWT2(ShardedSSQCWT):
    """Plan for a batched, scale-sharded second-order SSQ-CWT, made on
    every rank of a ('batch', 'scale') mesh.

    Usage (on every rank)::

        plan = ShardedSSQCWT2(N, mesh=make_mesh(batch=2, scale=4))
        Tx, Wx = plan(x)   # x: the global (B, N)

    Shards and `gather` as `ShardedSSQCWT`'s. Any wavelet that
    `ssq_cwt2` takes (`models/ssq_cwt2.py::_supports_order2`)."""

    def __init__(self, N, wavelet='gmw', scales='log-piecewise', nv=32,
                 fs=1., padtype='reflect', maprange='peak', flipud=True,
                 gamma=None, mesh=None, squeezing='sum'):
        super().__init__(N, wavelet, scales, nv, fs, padtype, maprange,
                         flipud, gamma, mesh, squeezing=squeezing)
        ok, why = _supports_order2(self.wavelet, self.dtype)
        if not ok:
            raise NotImplementedError("ShardedSSQCWT2 %s" % why)

    def _rows(self, xt):
        xh, n_up, n1 = cwt_spectrum(xt, self.padtype, 5)
        xh, one = _one_signal(xh)
        W, k = _rebatch(one, *cwt_bins2(
            xh, self._scales, self.wavelet, n_up, n1, self.N, self.dt,
            self.params, self.gamma, self.flipud))
        return scatter_kv(self._squeeze(W), k, self._const, self.nbins), W

