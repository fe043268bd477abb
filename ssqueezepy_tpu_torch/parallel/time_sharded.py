# -*- coding: utf-8 -*-
"""Time-sharded (sequence / context-parallel) CWT and synchrosqueezed CWT.

Counterpart of `ssqueezepy_tpu/parallel/time_sharded.py`. The signal's
time axis is split over the 'time' dimension of a ('batch', 'time') mesh;
each rank transforms its chunk of C = N / n_time samples in overlap-save
form: the chunk extended by a halo of `halo` samples each side from its
neighbours' edges (one `all_gather` of every rank's (B, 2 halo) edges in
the 'time' group, in place of the JAX package's ring `ppermute`; a
signal-boundary rank reflects its own samples), reflected on to
n_up = `next_fft_len(C + 2 halo)` (2^a {1, 3, 5, 9, 15}, 7-smooth, so the
CWT kernel takes it, on its mixed engine where n_up is not a power of
two). Everything after the convolution is pointwise in time, so Tx needs
no reduction.

Two kinds of rows cannot ride overlap-save and are computed exactly from
the global signal (an `all_gather` of the chunks, reflect-padded as the
one-device CWT pads it), at this rank's columns only: scales whose time
support (`halo_mult` standard deviations) exceeds the halo, and small
scales whose wavelet is not negligible at Nyquist (its spectral
truncation rings with a slow 1/t decay). Per rank, for the interior rows
[n_lo, n_local) on the extended chunk (n1 = halo, N = C) and the exact
rows on the global spectrum (n1 = its pad + the chunk's offset, N = C):

  * `derivative=True` (the default): the CWT kernel's derivative mode
    (B3, `cwt_fused`, two planes), then the fused phase + bins + scatter
    kernel (B4, `ssq_fused`); returns (Tx, Wx, dWx);
  * `derivative=False`: the bins mode (B1 / B3b, `cwt_bins`) on both
    kinds of rows, the bins merged, then the scatter from bins (B2);
    returns (Tx, Wx).

A wavelet off the CWT kernel's route runs `cwt_general` for (Wx, dWx),
then B4. The overlap-save rows equal the global transform up to the
wavelet's decay tail beyond the halo; the exact rows equal it. The
collectives carry no gradient: a signal that requires grad raises.
"""
import numpy as np
import torch
import torch.distributed as dist

from ..configs import device_dtype
from ..models.cwt import cwt_general, resolve_wavelet, _kernel_route
from ..models.ssq_cwt import _ssq_cwt_plan
from ..models.wavelets import time_resolution
from ..ops.cwt_cuda import cwt_bins, cwt_fused, cwt_length_rule
from ..ops.fft import next_fft_len, rfft
from ..ops.pad import _reflect, pad_params, padsignal
from ..ops.ssq_cuda import scatter_kv, scatter_rule, ssq_fused
from ..streaming import _one_signal, _rebatch
from .collectives import all_gather, dim_size, gather_shards
from .distributed import init_distributed
from .mesh import build_mesh, mesh_device, split_sizes
from .sharded import _gamma, batch_block

__all__ = ['TimeShardedSSQCWT', 'time_sharded_cwt', 'time_sharded_ssq_cwt',
           'make_mesh_time']


def _default_halo(wavelet, max_scale, n_up, halo_mult=8.0):
    """Halo samples = halo_mult * std_t(max_scale); capped at n_up // 2."""
    try:
        std_t = float(time_resolution(wavelet, float(max_scale), N=n_up,
                                      nondim=False, force_int=False))
    except Exception:
        std_t = float(max_scale)
    h = int(np.ceil(halo_mult * std_t))
    return max(64, min(h, n_up // 2))


def _row_split(wavelet, scales_np, N, halo, halo_mult):
    """(n_lo, n_hi): rows [0, n_lo) ring at Nyquist and rows [n_hi, na)
    outlive the halo (scales ascend, so each is a prefix or a suffix);
    the rows between ride overlap-save."""
    sq = scales_np.squeeze()
    s_ref = float(np.clip(10., sq.min(), sq.max()))
    try:
        sigma1 = float(time_resolution(wavelet, s_ref, N=N, nondim=False,
                                       force_int=False)) / s_ref
    except Exception:
        sigma1 = 3.5
    over = halo_mult * sigma1 * sq > halo
    n_hi = int(np.argmax(over)) if over.any() else len(sq)
    fb = wavelet.filterbank_np(sq, N=64, nohalf=True)
    nyq_ring = fb[:, 32] > 1e-3 * fb.max()
    n_lo = int(np.nonzero(nyq_ring)[0].max()) + 1 if nyq_ring.any() else 0
    return min(n_lo, n_hi), n_hi


class _TimeSharded:
    """The plans over a 'time' dimension: the wavelet, the one-device plan
    (scales, ssq frequency grid, squeeze constant, bin map, memoized with
    `ssq_cwt`'s), the halo, the row split, the chunk's extension and the
    exact rows' global spectrum."""

    def _init_time(self, N, wavelet, scales, nv, fs, halo, halo_mult,
                   maprange, flipud, gamma, mesh):
        self.mesh = mesh
        self.device = mesh_device(mesh)
        self.n_time = dim_size(mesh, 'time')
        if N % self.n_time:
            raise ValueError("N=%d is not divisible by the mesh's 'time' "
                             "size %d" % (N, self.n_time))
        self.N = int(N)
        self.C = self.N // self.n_time
        self._time = mesh.get_group('time')
        self._i = mesh.get_local_rank('time')
        self.wavelet = resolve_wavelet(wavelet, l1_norm=True, N=self.N)
        self.dtype = device_dtype(self.wavelet.dtype)
        self.dt = 1. / fs
        plan, _ = _ssq_cwt_plan(self.wavelet, self.N, scales, nv, None,
                                maprange, True, self.dt)
        self.scales_np = plan.scales
        self.ssq_freqs = plan.ssq_freqs
        self.params = plan.params
        self.nbins = self.params['omax'] + 1
        self.flipud = bool(flipud)
        self.gamma = _gamma(gamma, self.dtype)
        na = len(plan.scales)
        self.const_np = np.array(np.broadcast_to(
            np.asarray(plan.const, np.float64).reshape(-1), (na,)))
        if halo is None:
            halo = _default_halo(self.wavelet, float(np.max(plan.scales)),
                                 self.C, halo_mult)
        # reflection at the signal boundary provides at most C - 1 samples
        self.halo = int(min(halo, self.C - 1))
        n_ext = self.C + 2 * self.halo
        self.n_up = next_fft_len(n_ext)
        self.pad_extra = self.n_up - n_ext
        self.n_lo, self.n_hi = _row_split(self.wavelet, plan.scales, self.N,
                                          self.halo, halo_mult)
        self.g_nup, self.g_n1, _ = pad_params(self.N, 'reflect')
        self._kernel = _kernel_route(self.wavelet)
        itemsize = 2 * np.dtype(self.dtype).itemsize
        scatter_rule(self.nbins, itemsize)
        if self._kernel:
            for n in (self.n_up, self.g_nup):
                cwt_length_rule(n, itemsize, 2)

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, np.float64).reshape(-1),
                               dtype=getattr(torch, self.dtype),
                               device=self.device)

    def _chunk(self, x):
        """This rank's chunk (B_local, C) of the global (B, N) `x`."""
        if isinstance(x, torch.Tensor) and torch.is_grad_enabled() and \
                x.requires_grad:
            raise NotImplementedError("the time-sharded plans' collectives "
                                      "carry no gradient")
        i, C = self._i, self.C
        return batch_block(x, self.mesh, self.dtype, self.device,
                           slice(i * C, (i + 1) * C))

    def _extend(self, xc):
        """The chunk with its halo each side (the neighbours' edges, one
        all_gather in the 'time' group; reflection at the signal's ends)
        and the reflected tail up to n_up."""
        H, i, n_t = self.halo, self._i, self.n_time
        edges = all_gather(torch.cat([xc[:, :H], xc[:, -H:]], -1)[None],
                           self._time, 0)
        left = (_reflect(xc, H, True) if i == 0 else edges[i - 1, :, H:])
        right = (_reflect(xc, H, False) if i == n_t - 1
                 else edges[i + 1, :, :H])
        xe = torch.cat([left, xc, right], dim=-1)
        if self.pad_extra:
            xe = torch.cat([xe, _reflect(xe, self.pad_extra, False)], dim=-1)
        return xe

    def _interior(self, xc):
        """(spectrum or padded signal, n_up, n1) of the extended chunk."""
        xe = self._extend(xc)
        return (rfft(xe) if self._kernel else xe), self.n_up, self.halo

    def _global(self, xc):
        """(spectrum or padded signal, n_up, n1) of the global signal, for
        this rank's columns of the exact rows."""
        xg = padsignal(all_gather(xc, self._time, -1), 'reflect')
        n1 = self.g_n1 + self._i * self.C
        return (rfft(xg) if self._kernel else xg), self.g_nup, n1

    def _planes(self, src, n_up, n1, scales, derivative=True):
        """(Wx, dWx) of `scales` at columns [n1, n1 + C) of the padded
        signal of spectrum (or, off the kernel's route, padded signal)
        `src`."""
        if self._kernel:
            xh, one = _one_signal(src.contiguous())
            return _rebatch(one, *cwt_fused(
                xh, scales, self.wavelet, n_up, n1, self.C, self.dt,
                derivative, True))
        return cwt_general(src, self.wavelet, scales, n1, self.C, self.dt,
                           derivative, True)

    def _bins(self, xh, n_up, n1, scales):
        xh, one = _one_signal(xh.contiguous())
        return _rebatch(one, *cwt_bins(
            xh, scales, self.wavelet, n_up, n1, self.C, self.dt, True,
            self.params, self.gamma, self.flipud))

    def gather(self, *shards):
        """The global arrays (B, rows, N) of this rank's shards (B_local,
        rows, C), on every rank."""
        B = shards[0].shape[0] * dim_size(self.mesh, 'batch')
        return tuple(gather_shards(s, self.mesh, {'time': (-1, self.N),
                                                  'batch': (0, B)})
                     for s in shards)

    @property
    def ssq_freqs_out(self):
        return np.asarray(self.ssq_freqs)[::-1].copy()


class TimeShardedSSQCWT(_TimeSharded):
    """Plan for a batched, time-sharded synchrosqueezed CWT, made on every
    rank of a ('batch', 'time') mesh.

    x: the global (B, N) with N divisible by the 'time' size; each rank
    owns the contiguous chunk [i C, (i + 1) C) of its batch rows. Returns
    this rank's (Tx (B_local, nbins, C), Wx (B_local, na, C)[, dWx]);
    `plan.gather(...)` puts the global arrays together. `deriv_lowprec` is
    taken for the JAX signature."""

    def __init__(self, N, wavelet='gmw', scales='log', nv=32, fs=1.,
                 halo=None, halo_mult=8.0, maprange='peak', flipud=True,
                 gamma=None, mesh=None, derivative=True,
                 deriv_lowprec=None):
        self._init_time(N, wavelet, scales, nv, fs, halo, halo_mult,
                        maprange, flipud, gamma,
                        mesh if mesh is not None else make_mesh_time())
        self.derivative = bool(derivative)
        # exact rows' indices, interior in between (`cat` order)
        self.n_local = self.n_hi
        sc = self._tensor(self.scales_np)
        self._mid = sc[self.n_lo:self.n_hi]
        self._exact = torch.cat([sc[:self.n_lo], sc[self.n_hi:]])
        self._const = self._tensor(self.const_np)

    def _merge(self, ex, mid):
        """Planes in scale order from the exact rows' planes `ex` and the
        interior's `mid` (either None where it has no rows)."""
        if ex is None or mid is None:
            return mid if ex is None else ex
        n_lo = self.n_lo
        return tuple(torch.cat([e[:, :n_lo], m, e[:, n_lo:]], dim=1)
                     for e, m in zip(ex, mid))

    def __call__(self, x):
        xc = self._chunk(x)
        bins = self._kernel and not self.derivative
        run = self._bins if bins else self._planes
        Wx, P2 = self._merge(
            run(*self._global(xc), self._exact) if len(self._exact)
            else None,
            run(*self._interior(xc), self._mid) if len(self._mid) else None)
        Wx, P2 = Wx.contiguous(), P2.contiguous()
        if bins:
            return scatter_kv(Wx, P2, self._const, self.nbins), Wx
        Tx = ssq_fused(Wx, P2, self._const, self.params, self.gamma,
                       self.flipud)
        return (Tx, Wx, P2) if self.derivative else (Tx, Wx)


def make_mesh_time(batch=None, time=None, device_type='cuda'):
    """Mesh over ('batch', 'time'); with no sizes given, every rank on
    'time'."""
    init_distributed(device_type=device_type)
    return build_mesh(('batch', 'time'),
                      split_sizes(dist.get_world_size(), batch, time),
                      device_type)


def time_sharded_cwt(x, wavelet='gmw', scales='log', nv=32, fs=1.,
                     halo=None, mesh=None):
    """One-shot time-sharded CWT of the global (B, N) `x`, on every rank:
    (Wx (B, na, N), scales)."""
    plan = TimeShardedSSQCWT(np.shape(x)[-1], wavelet, scales, nv, fs,
                             halo=halo, mesh=mesh)
    Wx, = plan.gather(plan(x)[1])
    return Wx, plan.scales_np.squeeze()


def time_sharded_ssq_cwt(x, wavelet='gmw', scales='log', nv=32, fs=1.,
                         halo=None, mesh=None, **kw):
    """One-shot time-sharded ssq_cwt of the global (B, N) `x`, on every
    rank: (Tx (B, nbins, N), Wx (B, na, N), ssq_freqs, scales)."""
    plan = TimeShardedSSQCWT(np.shape(x)[-1], wavelet, scales, nv, fs,
                             halo=halo, mesh=mesh, **kw)
    Tx, Wx = plan.gather(*plan(x)[:2])
    return Tx, Wx, plan.ssq_freqs_out, plan.scales_np.squeeze()
