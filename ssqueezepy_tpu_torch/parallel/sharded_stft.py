# -*- coding: utf-8 -*-
"""Row-sharded synchrosqueezed STFT, first and second order.

Counterpart of `ssqueezepy_tpu/parallel/sharded_stft.py`. At hop 1 each
STFT row is an independent correlation of the signal with its own window
table (`ops/stft_conv.py`), so rows shard as CWT scales do, over the
'scale' dimension of a ('batch', 'scale') mesh: each rank holds its
`row_block` of the window tables' rows, runs the STFT table kernel on the
full spectrum of its signals for those rows (B6 in bins mode,
`ops/stft_cuda.py::stft_conv`; the FSST2 mode B7, `fsst2_conv`, on the
five tables for `ShardedSSQSTFT2`), scatters its partial Tx into the full
bin space (B2), and one sum over 'scale' completes the squeeze. The JAX
plan pads the tables' rows to a multiple of the 'scale' size with zero
rows (which its gamma gate drops) and `Sfs` by its edge value; a rank's
block here is its real rows alone.
"""
import numpy as np

from ..configs import default_dtype
from ..models.ssq_stft import (_device_consts, fsst2_general, fsst2_plan,
                               squeeze_planes, stft_plan)
from ..models.ssqueezing import _check_ssqueezing_args
from ..models.stft import signal_spectrum, stft_general
from ..models.windows import _check_NOLA
from ..ops.fft import next_fft_len
from ..ops.ssq_cuda import scatter_fits, scatter_kv
from ..ops.ssq_kernels import indexed_sum_onfly, scatter_general
from ..ops.stft_conv import fsst2_tables, row_block, stft_tables
from ..ops.stft_cuda import fsst2_conv, stft_conv, stft_kernel_fits
from ..streaming import _one_signal, _rebatch
from .sharded import _ScaleSharded, _gamma

__all__ = ['ShardedSSQSTFT', 'ShardedSSQSTFT2', 'sharded_ssq_stft']


class ShardedSSQSTFT(_ScaleSharded):
    """Plan for a batched, frequency-row-sharded synchrosqueezed STFT
    (hop 1, modulated: the invertible configuration), made on every rank
    of a ('batch', 'scale') mesh.

    Usage (on every rank)::

        plan = ShardedSSQSTFT(N, mesh=make_mesh(batch=2, scale=4))
        Tx, Sx = plan(x)   # x: the global (B, N)

    Tx (B_local, nbins, N) is the same on every rank of a 'scale' group;
    Sx (B_local, hi - lo, N) holds this rank's rows [lo, hi) = `plan.rows`
    of the n_fft//2 + 1; `plan.gather(Tx, Sx)` puts the global arrays
    together."""

    _planes = 2

    def __init__(self, N, window=None, n_fft=None, win_len=None, fs=1.,
                 padtype='reflect', squeezing='sum', gamma=None,
                 flipud=False, mesh=None, dtype=None):
        _check_ssqueezing_args(squeezing)
        if not (squeezing is None or isinstance(squeezing, str)):
            raise ValueError("callable `squeezing` is unsupported on the "
                             "sharded path")
        self.N = int(N)
        self.squeezing = squeezing
        self.n_fft = int(n_fft or min(self.N, 512))
        win_len = int(win_len or self.n_fft)
        self.dtype = dtype or default_dtype()
        self.gamma = _gamma(gamma, self.dtype)
        self.flipud = bool(flipud)
        self.fs = float(fs)
        self.padtype = padtype
        plan = self._host_plan(window, win_len)
        self.Sfs = self.ssq_freqs = plan.Sfs
        self.const = plan.const
        self.params = plan.params
        self.nbins = self.params['omax'] + 1
        self.n_rows = self.n_fft // 2 + 1
        # the routes, as the one-device calls decide them
        itemsize = 2 * np.dtype(self.dtype).itemsize
        self.Np2 = next_fft_len(self.N + self.n_fft - 1)
        self._fits = scatter_fits(self.nbins, itemsize)
        self._general = not (self._fits and stft_kernel_fits(
            self.Np2, itemsize, self._planes))
        self._init_mesh(mesh, self.n_rows)
        sfs, const = _device_consts(plan, self.dtype, self.device)
        lo, hi = self.rows
        self._const = const[lo:hi]
        self._bins = dict(Sfs=sfs[lo:hi], params=self.params,
                          gamma=self.gamma, flipud=self.flipud)
        self._plan, self._sfs = plan, sfs
        self._tables = (None if self._general else
                        self._device_tables(plan, lo, hi))

    def _host_plan(self, window, win_len):
        plan = stft_plan(window, None, self.n_fft, win_len, self.fs,
                         self.dtype)
        _check_NOLA(plan.window, 1, self.dtype)
        self.window = plan.window
        return plan

    def _device_tables(self, plan, lo, hi):
        return tuple(row_block(t, lo, hi) for t in stft_tables(
            plan.window, plan.diff_window, self.n_fft, self.Np2, True,
            self.dtype, self.device))

    def _transform(self, xh):
        return stft_conv(xh, *self._tables, self.N, self.fs, self._bins)

    def _rows(self, xt):
        if self._general:
            return self._general_rows(xt)
        xh, one = _one_signal(signal_spectrum(xt, self.n_fft, self.padtype,
                                              self._planes))
        Sx, k = _rebatch(one, *self._transform(xh))
        Sx_s = self._squeeze(Sx)
        return (scatter_kv(Sx_s, k, self._const, self.nbins) if self._fits
                else scatter_general(Sx_s, k, k >= 0, self.nbins,
                                     self._const)), Sx

    def _general_rows(self, xt):
        """(Tx, Sx) of this rank's rows on the general route, as the
        one-device `ssq_stft` runs all rows there."""
        Sx, dSx = stft_general(xt, [self._plan.window,
                                    self._plan.diff_window], self.n_fft,
                               self.padtype, True, rows=self.rows)
        dSx.mul_(self.fs)
        return squeeze_planes(Sx, dSx, self._bins['Sfs'], self._const,
                              self.params, self.gamma, self.flipud,
                              self.squeezing, self._squeeze, self._fits), Sx

    @property
    def ssq_freqs_out(self):
        return (self.ssq_freqs[::-1].copy() if self.flipud
                else self.ssq_freqs)


def sharded_ssq_stft(x, window=None, n_fft=None, fs=1., mesh=None, **kw):
    """One-shot batched row-sharded ssq_stft of the global (B, N) `x`, on
    every rank: (Tx (B, nbins, N), Sx (B, n_fft//2 + 1, N), ssq_freqs,
    Sfs), as the one-device `ssq_stft` returns them."""
    plan = ShardedSSQSTFT(np.shape(x)[-1], window, n_fft, fs=fs, mesh=mesh,
                          **kw)
    Tx, Sx = plan.gather(*plan(x))
    return Tx, Sx, plan.ssq_freqs_out, plan.Sfs


class ShardedSSQSTFT2(ShardedSSQSTFT):
    """Frequency-row-sharded second-order synchrosqueezed STFT (FSST2).
    The chirp regression couples only the five transforms of one row, so
    rows shard as first order: each rank holds its block of the five
    windows' tables (g, g', t g, t g', g''), runs the STFT table kernel's
    FSST2 mode (B7) and the scatter from bins (B2); one sum over 'scale'.
    Returns (Tx, V) as `ShardedSSQSTFT` returns (Tx, Sx)."""

    _planes = 5

    def _host_plan(self, window, win_len):
        super()._host_plan(window, win_len)
        return fsst2_plan(window, None, self.n_fft, win_len, self.fs,
                          self.dtype)

    def _device_tables(self, plan, lo, hi):
        return row_block(fsst2_tables(plan.bank, self.n_fft, self.Np2, True,
                                      self.dtype, self.device), lo, hi)

    def _transform(self, xh):
        return fsst2_conv(xh, self._tables, self.N, self.fs, self._bins)

    def _general_rows(self, xt):
        """(Tx, V) of this rank's rows on the general route, as the
        one-device `ssq_stft2` runs all rows there."""
        V, w2 = fsst2_general(xt, self._plan.bank, self.n_fft, self.padtype,
                              True, self.fs, self._sfs, self.gamma,
                              rows=self.rows)
        return indexed_sum_onfly(self._squeeze(V), w2, None, self._const,
                                 params=self.params, flipud=self.flipud,
                                 device=self.device), V
