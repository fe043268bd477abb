# -*- coding: utf-8 -*-
"""Sharded (multi-rank) CWT / synchrosqueezed CWT.

Counterpart of `ssqueezepy_tpu/parallel/sharded.py`. A plan is made on
every rank of a ('batch', 'scale') `DeviceMesh`; each rank holds its
block of the filterbank rows (scales) and its block of the signals:

  * 'batch': data parallelism over independent signals;
  * 'scale': each rank runs the CWT of its scale block on its signals
    (`torch.fft.rfft` of the padded signals, then the fused CWT + bins
    kernel: `ops/cwt_cuda.py::cwt_bins`, B1 for one signal, B3b for a
    batch), scatters its partial Tx over the FULL bin space (the
    reassignment scatter B2, `ops/ssq_cuda.py::scatter_kv`, with its
    block's squeeze constant), and one sum over 'scale'
    (`collectives.psum`) completes the synchrosqueezing bin reduction,
    the only communication of the forward pass.

A wavelet off the CWT kernel's route, or a padded length past its rule
(`models/cwt.py::_public_route`, as the one-device calls decide it, once,
before the signal's FFT), runs `cwt_general` on the block, then the fused
phase + bins + scatter kernel (B4) for 'sum' squeezing, or the phase
transform and the generic scatter (B5) for another, as the one-device
`ssq_cwt` routes it; bins past the reassignment kernels' rule
(`scatter_fits`) take `ops/ssq_kernels.py::scatter_general` in B2's
place (after the torch phase transform and bin map in B4's:
`ssq_fused_general`). A rank's
block is its `row_block` of the scales: the JAX plan's padded rows
(const 0, `_pad_scales`) add nothing to Tx and are not computed, so the
last blocks are shorter, or empty (no launch). Plans take the global
(B, N) batch on every rank and return that rank's shards; the one-shot
functions return the global arrays (`collectives.gather_shards`).
"""
import numpy as np
import torch

from ..configs import device_dtype
from ..models.cwt import (cwt_general, cwt_spectrum, padded_length,
                          padded_signal, resolve_wavelet, _cached_scales,
                          _public_route)
from ..models.ssq_cwt import _device_plan, _ssq_cwt_plan
from ..models.ssqueezing import _apply_squeezing, _check_ssqueezing_args
from ..ops.cwt_cuda import cwt_bins, cwt_fused
from ..ops.phase import phase_cwt
from ..ops.ssq_cuda import scatter_fits, scatter_kv, ssq_fused
from ..ops.ssq_kernels import (indexed_sum_onfly, scatter_general,
                               ssq_fused_general)
from ..streaming import _one_signal, _rebatch
from ..utils.common import EPS32, EPS64, to_device
from .collectives import (dim_size, gather_shards, psum, replicated_in,
                          row_block)
from .mesh import make_mesh, mesh_device

__all__ = ['sharded_cwt', 'sharded_ssq_cwt', 'ShardedSSQCWT',
           'dryrun_multichip']


def batch_block(x, mesh, dtype, device, cols=None):
    """This rank's signals of the global (B, N) batch `x` (numpy or a
    tensor): its block of B / mesh['batch'] rows (and of the columns
    `cols`, a slice), as a real tensor of `dtype` on `device`, non-finite
    samples zeroed."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    if x.ndim != 2:
        raise ValueError("a sharded plan takes the (B, N) batch (got "
                         "x.ndim == %d)" % x.ndim)
    nb = dim_size(mesh, 'batch')
    if x.shape[0] % nb:
        raise ValueError("B=%d is not divisible by the mesh's 'batch' size "
                         "%d" % (x.shape[0], nb))
    bl = x.shape[0] // nb
    b = mesh.get_local_rank('batch')
    xt = to_device(x[b * bl:(b + 1) * bl, cols or slice(None)],
                   device).to(getattr(torch, dtype))
    return torch.where(torch.isfinite(xt), xt, torch.zeros_like(xt))


def scale_rows(mesh, n_rows):
    """(lo, hi): this rank's `row_block` of `n_rows` over 'scale'."""
    return row_block(n_rows, dim_size(mesh, 'scale'),
                     mesh.get_local_rank('scale'))


def no_rows(xt, shape):
    """Zeros of `shape` (B, rows, N), the result of a block without rows,
    in the complex type of the real (B, N) signals `xt`. Where autograd
    records they depend on `xt` (0 * xt), so that a rank with an empty
    block issues the same collectives in the backward as the ranks that
    hold rows, and its x.grad gets their share."""
    z = xt.new_zeros(shape, dtype=torch.promote_types(xt.dtype,
                                                      torch.complex64))
    if torch.is_grad_enabled() and xt.requires_grad:
        z = z + 0 * xt[:, None, :1]
    return z


def _gamma(gamma, dtype):
    if gamma is None:
        gamma = 10 * (EPS64 if dtype == 'float64' else EPS32)
    return float(gamma)


class _ScaleSharded:
    """Shared by the plans over ('batch', 'scale'): the mesh, this rank's
    device and row block, and the call: its signals in, the partial Tx of
    its rows summed over 'scale' out."""

    def _init_mesh(self, mesh, n_rows):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.device = mesh_device(self.mesh)
        self._group = self.mesh.get_group('scale')
        self.rows = scale_rows(self.mesh, n_rows)

    def __call__(self, x):
        """(Tx, W) of this rank: Tx (B_local, nbins, N), the same on every
        rank of its 'scale' group, and W (B_local, rows, N), its rows
        `self.rows` of the transform."""
        xt = replicated_in(batch_block(x, self.mesh, self.dtype,
                                       self.device), self._group)
        lo, hi = self.rows
        if hi == lo:
            B = xt.shape[0]
            Tx, W = (no_rows(xt, (B, self.nbins, self.N)),
                     no_rows(xt, (B, 0, self.N)))
        else:
            Tx, W = self._rows(xt)
        return psum(Tx, self._group), W

    def _squeeze(self, W):
        """The values the scatter sums for this block of rows: as
        `_apply_squeezing`, but 'lebesgue' is 1 / the whole transform's
        rows."""
        if self.squeezing == 'lebesgue':
            return torch.full_like(W, 1. / self.n_rows)
        return _apply_squeezing(W, self.squeezing)

    def gather(self, Tx, W):
        """The global (Tx (B, nbins, N), W (B, n_rows, N)) from this rank's
        shards, on every rank."""
        B = Tx.shape[0] * dim_size(self.mesh, 'batch')
        return (gather_shards(Tx, self.mesh, {'batch': (0, B)}),
                gather_shards(W, self.mesh, {'scale': (1, self.n_rows),
                                             'batch': (0, B)}))


class ShardedSSQCWT(_ScaleSharded):
    """Plan for a batched, scale-sharded synchrosqueezed CWT, made on every
    rank of a ('batch', 'scale') mesh.

    Usage (on every rank)::

        plan = ShardedSSQCWT(N, mesh=make_mesh(batch=2, scale=4))
        Tx, Wx = plan(x)   # x: the global (B, N), B divisible by 'batch'

    Tx (B_local, nbins, N) is this rank's batch rows, the same on every
    rank of its 'scale' group; Wx (B_local, hi - lo, N) its rows
    [lo, hi) = `plan.rows` of the transform. `plan.gather(Tx, Wx)` puts
    the global arrays together. `squeezing` as `ssq_cwt` takes it;
    `derivative_out` and `deriv_lowprec` are taken for the JAX signature
    (the derivative runs in the plan's precision, as in `ssq_cwt`)."""

    def __init__(self, N, wavelet='gmw', scales='log-piecewise', nv=32,
                 fs=1., padtype='reflect', maprange='peak', flipud=True,
                 gamma=None, mesh=None, derivative_out=False,
                 deriv_lowprec=None, squeezing='sum'):
        _check_ssqueezing_args(squeezing)
        self.N = int(N)
        self.wavelet = resolve_wavelet(wavelet, l1_norm=True, N=self.N)
        self.dtype = device_dtype(self.wavelet.dtype)
        self.dt = 1. / fs
        self.padtype = padtype
        self.squeezing = squeezing
        self.flipud = bool(flipud)
        self.gamma = _gamma(gamma, self.dtype)
        plan, key = _ssq_cwt_plan(self.wavelet, self.N, scales, nv, None,
                                  maprange, padtype is not None, self.dt)
        self.scales_np = plan.scales
        self.ssq_freqs = plan.ssq_freqs
        self.params = plan.params
        self.nbins = self.params['omax'] + 1
        self.n_rows = self.na = len(plan.scales)
        self._init_mesh(mesh, self.na)
        sc, c = _device_plan(key, plan.scales, plan.const, self.dtype,
                             self.device)
        lo, hi = self.rows
        self._scales, self._const = sc[lo:hi], c[lo:hi]
        # the routes, as the one-device `ssq_cwt` decides them
        self._fits = scatter_fits(self.nbins, 2 * sc.element_size())
        self._kernel = _public_route(self.wavelet,
                                     padded_length(self.N, self.padtype),
                                     sc, 2)

    def _rows(self, xt):
        sc, c, N, dt = self._scales, self._const, self.N, self.dt
        if self._kernel:
            xh, n_up, n1 = cwt_spectrum(xt, self.padtype, 2)
            xh, one = _one_signal(xh)
            Wx, k = _rebatch(one, *cwt_bins(
                xh, sc, self.wavelet, n_up, n1, N, dt, True, self.params,
                self.gamma, self.flipud))
            Wx_s = self._squeeze(Wx)
            return (scatter_kv(Wx_s, k, c, self.nbins) if self._fits else
                    scatter_general(Wx_s, k, k >= 0, self.nbins, c)), Wx
        xp, n_up, n1 = padded_signal(xt, self.padtype)
        Wx, dWx = cwt_general(xp, self.wavelet, sc, n1, N, dt, True, True)
        if self.squeezing == 'sum':
            Wx, dWx = Wx.contiguous(), dWx.contiguous()
            return (ssq_fused if self._fits else ssq_fused_general)(
                Wx, dWx, c, self.params, self.gamma, self.flipud), Wx
        w = phase_cwt(Wx, dWx, 'trig', self.gamma)
        return indexed_sum_onfly(self._squeeze(Wx), w, None, c,
                                 params=self.params, flipud=self.flipud,
                                 device=self.device), Wx

    @property
    def ssq_freqs_out(self):
        return np.asarray(self.ssq_freqs)[::-1].copy()


def sharded_ssq_cwt(x, wavelet='gmw', scales='log-piecewise', nv=32, fs=1.,
                    mesh=None, **kw):
    """One-shot batched scale-sharded ssq_cwt of the global (B, N) `x`, on
    every rank: (Tx (B, nbins, N), Wx (B, na, N), ssq_freqs, scales), the
    global arrays on this rank's device."""
    plan = ShardedSSQCWT(np.shape(x)[-1], wavelet, scales, nv, fs,
                         mesh=mesh, **kw)
    Tx, Wx = plan.gather(*plan(x))
    return Tx, Wx, plan.ssq_freqs_out, plan.scales_np.squeeze()


def sharded_cwt(x, wavelet='gmw', scales='log-piecewise', nv=32, fs=1.,
                mesh=None, padtype='reflect'):
    """Batched scale-sharded forward CWT of the global (B, N) `x`, on every
    rank: (Wx (B, na, N), scales). Each rank runs the CWT kernel's plain
    mode (B3, `cwt_fused`) on its scale block and signals (`cwt_general`
    for a wavelet off the kernel's route or a padded length past its
    rule: `_public_route`, as `cwt` decides it); the shards are then
    gathered."""
    N = np.shape(x)[-1]
    mesh = mesh if mesh is not None else make_mesh()
    wavelet = resolve_wavelet(wavelet, l1_norm=True, N=N)
    dtype = device_dtype(wavelet.dtype)
    device = mesh_device(mesh)
    scales_np, sc = _cached_scales(scales, N, wavelet, nv,
                                   getattr(torch, dtype), device)
    na = len(scales_np)
    lo, hi = scale_rows(mesh, na)
    sc = sc[lo:hi]
    xt = batch_block(x, mesh, dtype, device)
    if hi == lo:
        Wx = no_rows(xt, (xt.shape[0], 0, N))
    elif _public_route(wavelet, padded_length(N, padtype), xt, 1):
        xh, n_up, n1 = cwt_spectrum(xt, padtype, 1)
        xh, one = _one_signal(xh)
        Wx, = _rebatch(one, cwt_fused(xh, sc, wavelet, n_up, n1, N, 1.,
                                      False, True)[0])
    else:
        xp, n_up, n1 = padded_signal(xt, padtype)
        Wx = cwt_general(xp, wavelet, sc, n1, N, 1., False, True)[0]
    B = xt.shape[0] * dim_size(mesh, 'batch')
    Wx = gather_shards(Wx, mesh, {'scale': (1, na), 'batch': (0, B)})
    return Wx, scales_np.squeeze()


def _rel(a, b, trim=0):
    """max |a - b| / max |b| over columns [trim, N - trim)."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if trim:
        a, b = a[..., trim:-trim], b[..., trim:-trim]
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def _dryrun_rank(rank, world, device_type):
    """One rank of `dryrun_multichip`: every leg, checked on rank 0."""
    import ssqueezepy_tpu_torch as stt
    from ..streaming import StreamingSSQCWT, _drive
    from ..streaming_multirate import StreamingMultirateSSQCWT
    from .distributed import init_distributed, make_host_chip_mesh
    from .full_sharded import FullShardedSSQCWT, make_mesh3
    from .inverse import sharded_icwt, sharded_issq_cwt
    from .sharded_order2 import ShardedSSQCWT2
    from .sharded_stft import ShardedSSQSTFT, ShardedSSQSTFT2
    from .time_sharded import TimeShardedSSQCWT, make_mesh_time
    import torch.distributed as dist

    batch_axis = 2 if world % 2 == 0 and world > 1 else 1
    mesh = make_mesh(batch=batch_axis, scale=world // batch_axis,
                     device_type=device_type)
    dev = mesh_device(mesh)
    B, N = batch_axis * 2, 256
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, N)).astype(np.float32)
    g32 = ('gmw', {'dtype': 'float32'})
    lead = rank == 0

    def check(ok, what):
        if lead and not ok:
            raise AssertionError("dryrun_multichip: " + what)

    Tx_1, Wx_1, *_ = stt.ssq_cwt(x, g32, scales='log', nv=8, device=dev)
    # forward
    plan = ShardedSSQCWT(N, g32, 'log', nv=8, mesh=mesh)
    Tx_s, Wx_s = plan(x)
    Tx, Wx = plan.gather(Tx_s, Wx_s)
    check(_rel(Wx, Wx_1) < 1e-5, "forward Wx %.3g" % _rel(Wx, Wx_1))
    check(_rel(Tx, Tx_1) < 6e-3, "forward Tx %.3g" % _rel(Tx, Tx_1))
    check(_rel(Tx.sum(-2), Tx_1.sum(-2)) < 1e-4, "forward Tx column sums")

    # gradient step: a reconstruction loss through the sharded forward
    # (CWT, bins, scatter, the sum over 'scale'); each rank's x.grad is
    # the gradient of its batch rows, summed over 'batch' here
    def loss(Tx_, xb):
        return ((Tx_.real.sum(-2) - xb) ** 2).mean()

    xg = torch.as_tensor(x, device=dev).requires_grad_()
    Tg, _ = plan(xg)
    bl = B // batch_axis
    b = mesh.get_local_rank('batch')
    loss(Tg, xg[b * bl:(b + 1) * bl]).backward()
    g = xg.grad.clone()
    dist.all_reduce(g, group=mesh.get_group('batch'))
    x1 = torch.as_tensor(x, device=dev).requires_grad_()
    T1, *_ = stt.ssq_cwt(x1, g32, scales='log', nv=8, device=dev)
    # the one-device loss is the mean over each batch block's loss
    (sum(loss(T1[i:i + bl], x1[i:i + bl]) for i in range(0, B, bl))
     ).backward()
    check(bool(torch.isfinite(g).all()) and _rel(g, x1.grad) < 1e-5,
          "gradient %.3g" % _rel(g, x1.grad))

    # time-sharded: halo exchange + exact rows for over-support scales
    tmesh = make_mesh_time(batch=batch_axis, time=world // batch_axis,
                           device_type=device_type)
    tplan = TimeShardedSSQCWT(N, g32, 'log', nv=8, mesh=tmesh)
    Tt, Wt = tplan.gather(*tplan(x)[:2])
    check(_rel(Wt, Wx_1, trim=32) < 5e-3, "time Wx")
    check(_rel(Tt.sum(-2), Tx_1.sum(-2), trim=32) < 5e-3, "time Tx")

    if world % 4 == 0:
        m3 = make_mesh3(batch=batch_axis, scale=2,
                        time=world // (2 * batch_axis),
                        device_type=device_type)
        p3 = FullShardedSSQCWT(N, g32, 'log', nv=8, mesh=m3)
        T3, = p3.gather(p3(x))
        check(_rel(T3.sum(-2), Tx_1.sum(-2), trim=32) < 5e-3, "3-axis Tx")

    # STFT rows over a host x card mesh
    pidx, pcnt = init_distributed(device_type=device_type)
    check(pidx == 0 and pcnt == world, "init_distributed")
    hmesh = make_host_chip_mesh('scale', device_type=device_type)
    splan = ShardedSSQSTFT(N, n_fft=64, mesh=hmesh, dtype='float32')
    Ts, Ss = splan.gather(*splan(x))
    Ts_1, Ss_1, *_ = stt.ssq_stft(x, n_fft=64, dtype='float32', device=dev)
    check(_rel(Ss, Ss_1) < 1e-5, "STFT Sx")
    check(_rel(Ts, Ts_1) < 6e-3, "STFT Tx")
    check(_rel(Ts.sum(-2), Ts_1.sum(-2)) < 1e-4, "STFT Tx column sums")

    # second order
    p2 = ShardedSSQCWT2(N, g32, 'log', nv=8, mesh=mesh)
    T2, _ = p2.gather(*p2(x))
    T2_1, *_ = stt.ssq_cwt2(x, g32, scales='log', nv=8, device=dev)
    check(_rel(T2.sum(-2), T2_1.sum(-2)) < 1e-3, "order 2 Tx")
    s2 = ShardedSSQSTFT2(N, n_fft=64, mesh=hmesh, dtype='float32')
    Ts2, _ = s2.gather(*s2(x))
    T2s_1, *_ = stt.ssq_stft2(x, n_fft=64, dtype='float32', device=dev)
    check(_rel(Ts2.sum(-2), T2s_1.sum(-2)) < 1e-3, "STFT2 Tx")

    # sharded inverses on the forward's shards
    xr = sharded_icwt(Wx_s, g32, 'log', nv=8, x_len=N, mesh=mesh)
    xr_1 = stt.icwt(Wx_1, g32, scales='log', nv=8, x_len=N)
    check(xr.shape == (B, N) and _rel(xr, xr_1) < 1e-3, "icwt")
    xr2 = sharded_issq_cwt(Tx_s, g32, mesh=mesh)
    check(_rel(xr2, stt.issq_cwt(Tx_1, g32)) < 1e-3, "issq_cwt")

    # streaming + multirate (one-device plans, on rank 0)
    if lead:
        Ns, chunk, ctx = 2048, 512, 512
        xs = rng.standard_normal(Ns).astype(np.float32)
        sc = np.geomspace(1., 16., 33).reshape(-1, 1)
        Tx_off, *_ = stt.ssq_cwt(xs, g32, scales=sc, nv=None, device=dev)
        sp = StreamingSSQCWT(chunk, g32, scales=sc, nv=None, N=Ns,
                             history=ctx, lookahead=ctx, device=dev)
        Txs, _ = _drive(sp, xs, chunk)
        m = int(min(np.ceil(sp.support_np).max(), ctx))
        check(_rel(Txs.sum(-2), Tx_off.sum(-2), trim=m) < 5e-3, "streaming")
        mp_ = StreamingMultirateSSQCWT(chunk, g32, scales=sc, nv=None, N=Ns,
                                       device=dev)
        Txm, _ = _drive(mp_, xs, chunk)
        mm = max(m, int(np.ceil(mp_.support_np).max()) + 64)
        check(Txm.shape[-1] == Ns and bool(torch.isfinite(Txm).all()) and
              _rel(Txm.sum(-2), Tx_off.sum(-2), trim=mm) < 5e-3, "multirate")
    return True


def dryrun_multichip(n_devices):
    """Run every sharded leg once on `n_devices` spawned ranks at tiny
    shapes, each against the port's one-device call with the JAX
    function's tolerances: the forward `ShardedSSQCWT`, a gradient step
    through it, the time-sharded plan, the three-axis plan (n % 4 == 0),
    the STFT rows on a host x card mesh, order 2 (CWT and STFT), the
    sharded inverses, and the streaming and multirate plans. Ranks run
    under NCCL on as many cards where there are enough, else under gloo
    on the CPU. Returns True; a failed leg raises."""
    device_type = ('cuda' if torch.cuda.is_available() and
                   torch.cuda.device_count() >= n_devices else 'cpu')
    from .distributed import spawn
    return all(spawn(_dryrun_rank, n_devices, (device_type,),
                     device_type=device_type, timeout=300.))
