# -*- coding: utf-8 -*-
"""Streaming (chunked, online) CWT, STFT and their synchrosqueezed forms.

Counterpart of `ssqueezepy_tpu/streaming.py`. The signal arrives in
fixed-size chunks; each chunk is transformed in overlap-save form: the
window ``hist | pend | chunk`` (`history` samples of carried past signal,
the `lookahead` samples received but not yet emitted, the new chunk) is
transformed, and only its emit region ``[history, history + chunk)`` is
kept. The carry state (`hist`, `pend`) is a pair of tensors on the plan's
device and never crosses to the host between chunks.

Everything a chunk needs but the signal is built once, when the plan is
made, on its device: scales, the ssq frequency grid, the squeeze
constant, the bin map, the length rules of the kernels, the reflection
indices, the wavelet table where the CWT kernel reads one, the STFT
window tables. Each chunk then runs one of the offline port's routes on
its window, as the kernels already take it:

  * `StreamingSSQCWT`: pad the window to ``n_up = next_fft_len(history +
    chunk + lookahead)`` by reflection, `torch.fft.rfft`, then the CWT
    kernel in bins mode (`ops/cwt_cuda.py::cwt_bins` with n1 = history
    and N = chunk: B1 for one signal, B3b for a (B > 1, chunk) batch) and
    the scatter from bins (`ops/ssq_cuda.py::scatter_kv`, B2). A wavelet
    off the kernel's route (`models/cwt.py::_kernel_route`) takes the JAX
    package's XLA branch: `cwt_general` with the derivative, the phase
    transform, `compute_bins` and the generic scatter (B5).
    `StreamingCWT` runs the kernel's Wx-only mode (`cwt_fused`, B3).
  * `StreamingSSQCWT2`: the order-2 bins mode (`cwt_bins2`, B8), then B2.
  * `StreamingSSQSTFT`: the window IS the padded signal (``chunk + n_fft
    - 1`` samples), so ``fft(window, Np2)`` with Np2 =
    `next_fft_len(chunk + n_fft - 1)`, then the STFT table kernel in bins
    mode (`ops/stft_cuda.py::stft_conv`, B6) and B2, for every squeezing
    and for a batch (B6's batch rows and the batched B2; the JAX package
    sends a batch to its fused kernel instead: the outputs agree by the
    bins criterion). `StreamingSTFT` runs B6's Sx mode and
    `StreamingSSQSTFT2` the FSST2 mode (`fsst2_conv`, B7), then B2.

Past a kernel's rule the plan keeps its geometry and runs the general
functions the offline calls take there, on the same window: the route is
fixed when the plan is made, with the offline calls' predicates
(`ops/cwt_cuda.py::cwt_kernel_fits`, `ops/stft_cuda.py::
stft_kernel_fits`, `ops/ssq_cuda.py::scatter_fits`). A CWT window past
the kernel's rule takes the XLA branch above; an order-2 one
`models/ssq_cwt2.py::wsst2_general` and the generic scatter by the bins
of w2; an STFT window past the table kernel's rule or the scatters'
`models/stft.py::stft_general` (then B4, or the phase transform and the
generic scatter for a squeezing other than 'sum') or `models/ssq_stft.py
::fsst2_general` (then the generic scatter); bins past the scatters'
rule `ops/ssq_kernels.py::scatter_general` in B2's place.

A (chunk,) or (1, chunk) stream launches the kernels' one-signal
counters, a (B > 1, chunk) stream the batched ones. `deriv_lowprec` is
taken for the JAX signature: the derivative runs in the plan's precision,
as in the offline port (the TPU's bfloat16 split of it is a TPU
mechanic). Latency, reliability (`support_np`, `n_reliable`) and the
emission schedule are the JAX package's; see `StreamingSSQCWT`.

Plans run on ``device='cuda'`` unless the caller passes ``device='cpu'``
(the kernels' plain versions); a CUDA request without a card raises.
"""
import numpy as np
import torch

from .configs import default_dtype, device_dtype
from .models.cwt import cwt_general, resolve_wavelet, _kernel_route
from .models.ssq_cwt import _ssq_cwt_plan
from .models.ssq_cwt2 import _supports_order2, wsst2_general
from .models.ssq_stft import (_device_consts, _fsst2_bank, fsst2_general,
                              squeeze_planes, stft_plan)
from .models.ssqueezing import _apply_squeezing, _natural_bins
from .models.stft import stft_general
from .models.wavelets import time_resolution
from .models.windows import _check_NOLA
from .ops.cwt_cuda import (cwt_bins, cwt_bins2, cwt_fused, cwt_kernel_fits,
                           wavelet_table)
from .ops.fft import fft, next_fft_len, rfft
from .ops.pad import _pad_index, reflect_index
from .ops.phase import _imag_ratio_over_2pi
from .ops.ssq_cuda import scatter_fits, scatter_kv
from .ops.ssq_kernels import (_dispatch_scatter, compute_bins,
                              indexed_sum_onfly, scatter_general)
from .ops.stft_conv import fsst2_tables, stft_tables
from .ops.stft_cuda import fsst2_conv, stft_conv, stft_kernel_fits
from .utils.common import EPS32, EPS64, resolve_device, to_device

__all__ = ['StreamingSSQCWT', 'StreamingSSQCWT2', 'StreamingCWT',
           'StreamingSSQSTFT', 'StreamingSSQSTFT2', 'StreamingSTFT',
           'stream_ssq_cwt', 'stream_cwt', 'stream_ssq_stft',
           'stream_ssq_stft2', 'stream_stft']


class _StreamingBase:
    """Carry state shared by the streaming plans: the (history | pending
    lookahead) tensors threaded through the per-chunk body `_body`, and
    the emission ledger (which columns of each body's output are real
    signal positions).

    Subclasses set ``chunk, history, lookahead, dtype, ssq, device`` and
    `_body(window) -> (Tx or None, Wx)` over a (B, history + chunk +
    lookahead) window, and call `_init_state` and `_init_carry`."""

    def _init_state(self):
        self._hist = None
        self._pend = None
        self._done = False
        self._ncalls = 0

    def _init_carry(self):
        """The carry's torch dtype and the reflection indices of the
        first chunk's pre-signal context and of `finalize`'s synthetic
        tail, built once per plan."""
        h, c, l = self.history, self.chunk, self.lookahead
        self._tdtype = getattr(torch, self.dtype)
        self._pre_idx = reflect_index(c, h + l, True, self.device)
        self._synth_idx = (reflect_index(h + l, -(-l // c) * c, False,
                                         self.device) if l else None)

    def _init_cwt(self, chunk, wavelet, scales, nv, fs, N, halo_mult,
                  maprange, flipud, gamma, ssq, device):
        """The CWT plans' constants: the wavelet, the offline plan
        (`models/ssq_cwt.py::_ssq_cwt_plan`: scales, ssq frequency grid,
        squeeze constant, bin map, memoized as `ssq_cwt` keeps it), each
        row's time support (`halo_mult` standard deviations, the
        reliability contract), and the constants' tensors."""
        self.device = resolve_device(device)
        self.chunk = int(chunk)
        self.N_plan = int(N) if N is not None else 16 * self.chunk
        self.ssq = bool(ssq)
        # a user's callable is kept by this plan alone, as its table is
        self.wavelet = resolve_wavelet(wavelet, l1_norm=True, N=self.N_plan)
        self.dtype = device_dtype(self.wavelet.dtype)
        self.dt = 1. / fs
        plan, _ = _ssq_cwt_plan(self.wavelet, self.N_plan, scales, nv, None,
                                maprange, True, self.dt)
        self.scales_np = np.array(plan.scales)
        self.ssq_freqs = np.array(plan.ssq_freqs)
        self.const_np = np.array(np.broadcast_to(
            np.asarray(plan.const, np.float64).reshape(-1),
            (len(self.scales_np),)))
        self.params = dict(plan.params)
        self.nbins = self.params['omax'] + 1
        sq = self.scales_np.squeeze()
        # sigma_t grows linearly in scale: its slope at a reference scale
        s_ref = float(np.clip(10., sq.min(), sq.max()))
        try:
            sigma1 = float(time_resolution(
                self.wavelet, s_ref, N=self.N_plan, nondim=False,
                force_int=False)) / s_ref
        except Exception:
            # the JAX package's fallback for a wavelet whose time spread
            # cannot be integrated
            sigma1 = 3.5
        self.halo_mult = float(halo_mult)
        self.support_np = halo_mult * sigma1 * sq
        self.flipud = bool(flipud)
        if gamma is None:
            gamma = 10 * (EPS64 if self.dtype == 'float64' else EPS32)
        self.gamma = float(gamma)
        tdt = getattr(torch, self.dtype)
        self._scales_t = torch.as_tensor(sq.reshape(-1), dtype=tdt,
                                         device=self.device)
        self._const_t = torch.as_tensor(self.const_np, dtype=tdt,
                                        device=self.device)
        self._gamma2 = torch.tensor(self.gamma, dtype=tdt,
                                    device=self.device) ** 2

    def _scatter(self, Wx, k):
        """Tx from the bins k of Wx: B2, or `scatter_general` past the
        scatters' rule (`self._fits`)."""
        if self._fits:
            return scatter_kv(Wx, k, self._const_t, self.nbins)
        return scatter_general(Wx, k, k >= 0, self.nbins, self._const_t)

    def _ssq_from_derivative(self, Wx, dWx):
        """Tx from (Wx, dWx) as the JAX package's XLA body runs it: the
        phase transform, gated at gamma, its bins, the generic scatter
        (B5) with the per-row constant."""
        ww = torch.abs(_imag_ratio_over_2pi(Wx, dWx))
        valid = Wx.real * Wx.real + Wx.imag * Wx.imag > self._gamma2
        ww = torch.where(valid, ww, float('inf'))
        k, kvalid = compute_bins(ww, self.params, self.flipud)
        return _dispatch_scatter(Wx, k, valid & kvalid, self.nbins,
                                 self._const_t)

    # -- host-side driver --------------------------------------------
    def _as_batch(self, x):
        arr = to_device(x, self.device).to(self._tdtype)
        squeeze = arr.dim() == 1
        if squeeze:
            arr = arr[None]
        if arr.shape[-1] != self.chunk:
            raise ValueError("chunk length %d != plan chunk %d"
                             % (arr.shape[-1], self.chunk))
        return arr, squeeze

    def _step(self, x):
        w = torch.cat([self._hist, self._pend, x], dim=-1)
        # carry for the next call: the history samples preceding the next
        # emit region, and the trailing lookahead samples
        h, c = self.history, self.chunk
        self._hist = w[..., c:c + h]
        self._pend = w[..., h + c:]
        return self._body(w)

    def process(self, x):
        """Feed `chunk` new samples ((chunk,) or (B, chunk), numpy or a
        tensor); return (Tx_cols, Wx_cols), complex tensors on the plan's
        device (Tx None without ssq), for the newly emittable columns.
        The emit region trails the newest sample by `lookahead`, so the
        first ``ceil(lookahead/chunk)`` calls return fewer, possibly
        zero, columns."""
        if self._done:
            raise RuntimeError("stream already finalized; call reset()")
        x, squeeze = self._as_batch(x)
        if self._hist is None:
            self._squeeze = squeeze
            # pre-signal context: the first chunk reflected from its start
            # (padsignal's 'reflect', repeated when the context exceeds
            # the chunk)
            pre = x.index_select(-1, self._pre_idx)
            self._hist = pre[..., :self.history]
            self._pend = pre[..., self.history:]
        Tx, Wx = self._step(x)
        # columns at global index < 0 are pre-signal reflection: drop
        lo = min(max(self.lookahead - self._ncalls * self.chunk, 0),
                 self.chunk)
        self._ncalls += 1
        return self._emit(Tx, Wx, lo, self.chunk)

    def finalize(self):
        """Flush the last `lookahead` columns (reflected right padding).
        Returns (Tx_cols, Wx_cols); (None, None) when lookahead == 0."""
        if self._hist is None:
            raise RuntimeError("no chunks processed")
        self._done = True
        c, l = self.chunk, self.lookahead
        if l == 0:
            return None, None
        # continue the stream by reflecting its received end: enough
        # material to fill every remaining window's look region
        tail = torch.cat([self._hist, self._pend], dim=-1)
        synth = tail.index_select(-1, self._synth_idx)
        parts = []
        T = self._ncalls * c             # total real samples received
        for j in range(synth.shape[-1] // c):
            Tx, Wx = self._step(synth[..., j * c:(j + 1) * c])
            # this step's emit region covers global columns [pos, pos + c);
            # clamp to the real signal [0, T)
            pos = (self._ncalls + j) * c - l
            lo = min(max(-pos, 0), c)
            hi = min(max(T - pos, 0), c)
            parts.append(self._emit(Tx, Wx, lo, hi))
        if len(parts) == 1:
            return parts[0]
        Wx = torch.cat([p[1] for p in parts], dim=-1)
        Tx = torch.cat([p[0] for p in parts], dim=-1) if self.ssq else None
        return Tx, Wx

    def _emit(self, Tx, Wx, lo, hi):
        def sl(a):
            return a[0, ..., lo:hi] if self._squeeze else a[..., lo:hi]
        return (sl(Tx) if self.ssq else None), sl(Wx)

    def reset(self):
        """Forget all carried state; the plan is kept."""
        self._init_state()

    # -- checkpoint / resume ------------------------------------------
    def state_dict(self):
        """Host-side (numpy) snapshot of all carried state, with the JAX
        package's keys: persist it, make the same plan in another
        process, `load_state`, continue."""
        def host(t):
            return None if t is None else t.cpu().numpy()
        return {'hist': host(self._hist), 'pend': host(self._pend),
                'done': self._done, 'ncalls': self._ncalls,
                'squeeze': getattr(self, '_squeeze', None)}

    def load_state(self, state):
        """Restore a `state_dict` snapshot (this package's or the JAX
        package's plan's) onto this same plan, on its device; the next
        `process`/`finalize` continues the stream exactly."""
        def dev(a):
            return (None if a is None else
                    to_device(np.asarray(a), self.device).to(self._tdtype))
        self._hist = dev(state['hist'])
        self._pend = dev(state['pend'])
        self._done = bool(state['done'])
        self._ncalls = int(state['ncalls'])
        if state['squeeze'] is not None:
            self._squeeze = bool(state['squeeze'])
        return self


def _one_signal(xh):
    """(spectra, one): a (1, n) batch as its one signal (n,), so that the
    kernels count it on their one-signal counters."""
    one = xh.shape[0] == 1
    return (xh[0] if one else xh), one


def _rebatch(one, *planes):
    """The planes of a one-signal launch with the batch axis back."""
    return tuple(p[None] if one and p is not None else p for p in planes)


class StreamingSSQCWT(_StreamingBase):
    """Online synchrosqueezed CWT over fixed-size chunks.

    Usage::

        plan = StreamingSSQCWT(chunk=1024, wavelet='gmw', N=16384)
        for c in chunks:              # each (chunk,) or (B, chunk)
            Tx_cols, Wx_cols = plan.process(c)
        Tx_tail, Wx_tail = plan.finalize()

    `process` returns the transform columns for `chunk` signal positions
    delayed by `lookahead` samples (the first call returns
    ``chunk - lookahead`` columns; `finalize` flushes the final
    `lookahead` columns using reflected right-padding). Concatenating
    every emitted block reproduces one column per input sample.

    Parameters
    ----------
    chunk : int
        Samples per `process` call. All calls must use this size.
    N : int
        Planning length for scale selection and the ssq frequency grid
        (the true signal length when known; any representative record
        length otherwise). Defaults to ``16 * chunk``.
    history, lookahead : int
        Left / right context in samples. Both default to the largest
        scale's time support (`halo_mult` standard deviations) capped at
        ``4 * chunk``; a row is reliable (equal to the offline transform
        away from the signal's ends) when its support (`support_np`) fits
        ``min(history, lookahead)`` (`n_reliable`).
    deriv_lowprec : accepted and ignored (see the module's docstring).
    device : 'cuda' (default) or 'cpu'.
    The batch size is taken from the first chunk.
    """

    def __init__(self, chunk, wavelet='gmw', scales='log', nv=32, fs=1.,
                 N=None, history=None, lookahead=None, halo_mult=8.0,
                 maprange='peak', flipud=True, gamma=None,
                 deriv_lowprec=None, ssq=True, device='cuda'):
        self._init_cwt(chunk, wavelet, scales, nv, fs, N, halo_mult,
                       maprange, flipud, gamma, ssq, device)
        ctx = max(64, min(int(np.ceil(self.support_np.max())),
                          4 * self.chunk))
        self.history = int(history) if history is not None else ctx
        self.lookahead = int(lookahead) if lookahead is not None else ctx
        if self.history < 0 or self.lookahead < 0:
            raise ValueError("history/lookahead must be >= 0")
        n_ext = self.history + self.chunk + self.lookahead
        self.n_up = next_fft_len(n_ext)
        self.pad_extra = self.n_up - n_ext
        self.deriv_lowprec = deriv_lowprec
        self._init_state()
        self._init_carry()
        self._pad_idx = (_pad_index(n_ext, 0, self.pad_extra, 'reflect',
                                    self.device) if self.pad_extra else None)
        self._build()

    # -- the per-chunk body ---------------------------------------------
    def _build(self, order2=False):
        """The route and its plan constants: the kernel's where the wavelet
        takes it (any order-2 one does) and n_up fits its rule for its
        planes, the scatters' where nbins fits theirs, and the wavelet
        table where the kernel reads one (any wavelet but the order-0
        GMW)."""
        itemsize = 2 * np.dtype(self.dtype).itemsize
        self._kernel = ((order2 or _kernel_route(self.wavelet, self.n_up))
                        and cwt_kernel_fits(self.n_up, itemsize,
                                            5 if order2 else
                                            (2 if self.ssq else 1)))
        self._fits = not self.ssq or scatter_fits(self.nbins, itemsize)
        self._table = None
        if (self._kernel and
                getattr(self.wavelet.fn, 'kernel_params', None) is None):
            self._table = wavelet_table(self.wavelet, self._scales_t,
                                        self.n_up, order2=order2)

    def _padded(self, w):
        """The window padded to n_up by reflection from its end."""
        return w if self._pad_idx is None else w.index_select(-1,
                                                              self._pad_idx)

    def _body(self, w):
        h, c, dt = self.history, self.chunk, self.dt
        if not self._kernel:
            Wx, dWx = cwt_general(self._padded(w), self.wavelet,
                                  self._scales_t, h, c, dt, self.ssq, True)
            return (self._ssq_from_derivative(Wx, dWx) if self.ssq
                    else None), Wx
        xh, one = _one_signal(rfft(self._padded(w)).contiguous())
        if self.ssq:
            Wx, k = cwt_bins(xh, self._scales_t, self.wavelet, self.n_up, h,
                             c, dt, True, self.params, self.gamma,
                             self.flipud, self._table)
            Tx = self._scatter(Wx, k)
        else:
            Tx = None
            Wx, _ = cwt_fused(xh, self._scales_t, self.wavelet, self.n_up,
                              h, c, dt, False, True, self._table)
        return _rebatch(one, Tx, Wx)

    @property
    def n_reliable(self):
        """Scale rows whose time support fits the context (rows are
        support-ascending, so rows [0, n_reliable) meet the offline
        equality criterion away from the global signal edges)."""
        ctx = min(self.history, self.lookahead) if self.lookahead else \
            self.history
        return int((self.support_np <= ctx).sum())

    @property
    def ssq_freqs_out(self):
        return self.ssq_freqs[::-1].copy()


class StreamingSSQCWT2(StreamingSSQCWT):
    """Online second-order synchrosqueezed CWT (WSST2): the streaming
    CWT's overlap-save machinery with the order-2 bins mode of the CWT
    kernel (`cwt_bins2`, B8) and the scatter from bins (B2), as offline
    `ssq_cwt2` runs. Same latency/reliability contract as first order,
    with `support_np` widened by ``(halo_mult + 2) / halo_mult``: the
    t- and t^2-weighted kernels carry their mass ~1-2 sigma_t further
    out than psi itself. A wavelet `ssq_cwt2` refuses raises here. Past
    the kernel's rule for five planes each chunk runs `wsst2_general`
    on the window, then the generic scatter by the bins of w2."""

    def __init__(self, *args, **kw):
        kw.pop('ssq', None)
        kw.pop('deriv_lowprec', None)
        super().__init__(*args, ssq=True, **kw)
        self.support_np = (self.support_np
                           * (self.halo_mult + 2.) / self.halo_mult)

    def _build(self):
        ok, why = _supports_order2(self.wavelet, self.dtype)
        if not ok:
            raise NotImplementedError("StreamingSSQCWT2 %s" % why)
        super()._build(order2=True)

    def _body(self, w):
        if not self._kernel:
            W, w2 = wsst2_general(self._padded(w), None, self._scales_t,
                                  self.wavelet, self.chunk, self.dt,
                                  self.gamma, n1=self.history)
            return indexed_sum_onfly(W, w2, None, self._const_t,
                                     params=self.params, flipud=self.flipud,
                                     device=self.device), W
        xh, one = _one_signal(rfft(self._padded(w)).contiguous())
        W, k = cwt_bins2(xh, self._scales_t, self.wavelet, self.n_up,
                         self.history, self.chunk, self.dt, self.params,
                         self.gamma, self.flipud, self._table)
        return _rebatch(one, self._scatter(W, k), W)


class StreamingCWT(StreamingSSQCWT):
    """Online CWT (no reassignment): `process` returns Wx columns."""

    def __init__(self, chunk, wavelet='gmw', scales='log', nv=32, fs=1.,
                 **kw):
        kw.pop('ssq', None)
        super().__init__(chunk, wavelet, scales, nv, fs, ssq=False, **kw)

    def process(self, x):
        return super().process(x)[1]

    def finalize(self):
        return super().finalize()[1]


class StreamingSSQSTFT(_StreamingBase):
    """Online synchrosqueezed STFT (hop 1) over fixed-size chunks.

    The STFT kernel's time support is finite (`n_fft` samples), so the
    streaming transform is exact: with ``history = ceil((n_fft-1)/2)``
    and ``lookahead = (n_fft-1)//2`` (fixed by the plan: the offline
    pad geometry, `ops/pad.py::pad_params`, the odd sample on the left)
    every emitted column equals the offline `stft`/`ssq_stft` column up
    to FFT rounding, the global edges included when ``chunk >= n_fft``
    (the edge reflections then draw on identical samples). Latency is
    fixed at `lookahead` samples.

    `process` returns (Tx_cols, Sx_cols). `squeezing` is 'sum' (or None),
    'lebesgue', 'abs' or a function of Sx, as `ssq_stft` takes it.
    """

    def __init__(self, chunk, window=None, n_fft=None, win_len=None,
                 fs=1., modulated=True, ssq_freqs=None, squeezing='sum',
                 gamma=None, flipud=False, dtype=None, ssq=True,
                 device='cuda'):
        self.device = resolve_device(device)
        self.chunk = int(chunk)
        self.ssq = bool(ssq)
        n_fft = int(n_fft or min(512, self.chunk))
        self.n_fft = n_fft
        self.history = (n_fft - 1) - (n_fft - 1) // 2
        self.lookahead = (n_fft - 1) // 2
        self.dtype = dtype or default_dtype()
        self.fs = float(fs)
        self.modulated = bool(modulated)
        if gamma is None:
            gamma = 10 * (EPS64 if self.dtype == 'float64' else EPS32)
        self.gamma = float(gamma)
        self.flipud = bool(flipud)
        # the JAX package squeezes None as 'sum'
        self.squeezing = 'sum' if squeezing is None else squeezing

        self.win_len = int(win_len or n_fft)
        self._window_spec = window
        plan = stft_plan(window, ssq_freqs, n_fft, self.win_len, self.fs,
                         self.dtype)
        _check_NOLA(plan.window, 1, self.dtype)
        n_rows = n_fft // 2 + 1
        self.Sfs = plan.Sfs
        self.ssq_freqs = np.asarray(plan.ssq_freqs)
        self.const = plan.const
        self.params = plan.params
        self.nbins = self.params['omax'] + 1
        self._natural = _natural_bins('stft', None, self.ssq_freqs,
                                      self.params, self.flipud, n_rows,
                                      1. / self.fs)
        self._init_state()
        self._init_carry()
        # the window (history + chunk + lookahead == chunk + n_fft - 1
        # samples) is the padded signal; its FFT length is the offline one
        self.Np2 = next_fft_len(self.chunk + n_fft - 1)
        self._Sfs_t, self._const_t = _device_consts(plan, self.dtype,
                                                    self.device)
        self._bins = dict(Sfs=self._Sfs_t, params=self.params,
                          gamma=self.gamma, flipud=self.flipud)
        self._build(plan)

    def _route(self, planes):
        """Whether the table kernel takes the window (its rule for
        `planes` planes and, with ssq, the scatters'), as the offline
        hop-1 calls decide it; sets `self._fits`."""
        itemsize = 2 * np.dtype(self.dtype).itemsize
        self._fits = not self.ssq or scatter_fits(self.nbins, itemsize)
        self._general = not (self._fits and stft_kernel_fits(
            self.Np2, itemsize, planes))

    def _build(self, plan):
        self._route(2 if self.ssq else 1)
        self._windows = [plan.window, plan.diff_window][:1 + self.ssq]
        if not self._general:
            self._H, self._Hd = stft_tables(
                plan.window, plan.diff_window, self.n_fft, self.Np2,
                self.modulated, self.dtype, self.device, self.ssq)

    def _general_body(self, w):
        """(Tx, Sx) of the window on the general route, as the offline
        `ssq_stft` runs it there."""
        planes = stft_general(w, self._windows, self.n_fft, None,
                              self.modulated, padded=True)
        if not self.ssq:
            return None, planes[0]
        Sx, dSx = planes
        dSx.mul_(self.fs)
        return squeeze_planes(
            Sx, dSx, self._Sfs_t, self._const_t, self.params, self.gamma,
            self.flipud, self.squeezing,
            lambda S: _apply_squeezing(S, self.squeezing), self._fits), Sx

    def _body(self, w):
        if self._general:
            return self._general_body(w)
        xh, one = _one_signal(fft(w, n=self.Np2).contiguous())
        if self.ssq:
            Sx, k = stft_conv(xh, self._H, self._Hd, self.chunk, self.fs,
                              self._bins)
            Tx = self._scatter(_apply_squeezing(Sx, self.squeezing), k)
        else:
            Tx = None
            Sx = stft_conv(xh, self._H, None, self.chunk, self.fs)[0]
        return _rebatch(one, Tx, Sx)

    @property
    def ssq_freqs_out(self):
        return self.ssq_freqs[::-1].copy() if self.flipud \
            else self.ssq_freqs.copy()


class StreamingSSQSTFT2(StreamingSSQSTFT):
    """Online second-order synchrosqueezed STFT (FSST2), exact like the
    first-order stream: all five analysis windows (g, g', t g, t g', g'')
    share the finite `n_fft` support, so the window ``history + chunk +
    lookahead`` pins every emitted column to the offline `ssq_stft2`
    geometry. Each chunk runs the FSST2 mode of the STFT table kernel
    (`fsst2_conv`, B7) over the five tables, built once, then B2; past
    either rule `fsst2_general` on the window, then the generic scatter
    by the bins of w2, as the offline `ssq_stft2` runs it there."""

    def _build(self, plan):
        self._route(5)
        self._bank = _fsst2_bank(self._window_spec, self.win_len,
                                 self.n_fft, self.dtype)
        if not self._general:
            self._tables = fsst2_tables(self._bank, self.n_fft, self.Np2,
                                        self.modulated, self.dtype,
                                        self.device)

    def _body(self, w):
        if self._general:
            V, w2 = fsst2_general(w, self._bank, self.n_fft, None,
                                  self.modulated, self.fs, self._Sfs_t,
                                  self.gamma, padded=True)
            return indexed_sum_onfly(
                _apply_squeezing(V, self.squeezing), w2, None,
                self._const_t, params=self.params, flipud=self.flipud,
                device=self.device), V
        xh, one = _one_signal(fft(w, n=self.Np2).contiguous())
        Sx, k = fsst2_conv(xh, self._tables, self.chunk, self.fs, self._bins)
        Tx = self._scatter(_apply_squeezing(Sx, self.squeezing), k)
        return _rebatch(one, Tx, Sx)


class StreamingSTFT(StreamingSSQSTFT):
    """Online STFT (no reassignment): `process` returns Sx columns."""

    def __init__(self, chunk, window=None, n_fft=None, win_len=None,
                 fs=1., **kw):
        kw.pop('ssq', None)
        super().__init__(chunk, window, n_fft, win_len, fs, ssq=False,
                         **kw)

    def process(self, x):
        return super().process(x)[1]

    def finalize(self):
        return super().finalize()[1]


def _record(x):
    return x if isinstance(x, torch.Tensor) else np.asarray(x)


def _drive(plan, x, chunk):
    """Feed `x` ((N,) or (B, N), numpy or a tensor, uploaded once)
    through `plan` chunkwise; concatenate the emitted columns."""
    x = to_device(_record(x), plan.device)
    squeeze = x.dim() == 1
    xb = x[None] if squeeze else x
    N = xb.shape[-1]
    if N % chunk:
        raise ValueError("signal length %d not divisible by chunk %d"
                         % (N, chunk))
    txs, wxs = [], []
    for i in range(N // chunk):
        t, w = _StreamingBase.process(plan, xb[..., i * chunk:
                                               (i + 1) * chunk])
        txs.append(t)
        wxs.append(w)
    t, w = _StreamingBase.finalize(plan)
    if w is not None:
        txs.append(t)
        wxs.append(w)
    Wx = torch.cat(wxs, dim=-1)
    Tx = torch.cat(txs, dim=-1) if plan.ssq else None
    if squeeze:
        # _drive feeds (1, chunk) blocks, so the emitted parts kept a
        # batch dim of 1
        Wx = Wx[0]
        Tx = Tx[0] if Tx is not None else None
    return Tx, Wx


def stream_ssq_cwt(x, chunk, wavelet='gmw', scales='log', nv=32, fs=1.,
                   **kw):
    """Offline convenience: run the streaming plan over a full signal
    (`device` and the plan's other options in `kw`). Returns (Tx, Wx,
    ssq_freqs, scales) matching `ssq_cwt`'s column count."""
    x = _record(x)
    N = kw.pop('N', x.shape[-1])
    plan = StreamingSSQCWT(chunk, wavelet, scales, nv, fs, N=N, **kw)
    Tx, Wx = _drive(plan, x, chunk)
    return Tx, Wx, plan.ssq_freqs_out, plan.scales_np.squeeze()


def stream_cwt(x, chunk, wavelet='gmw', scales='log', nv=32, fs=1.,
               **kw):
    """Offline convenience for the streaming CWT. Returns (Wx, scales)."""
    x = _record(x)
    kw.pop('ssq', None)
    N = kw.pop('N', x.shape[-1])
    plan = StreamingSSQCWT(chunk, wavelet, scales, nv, fs, N=N, ssq=False,
                           **kw)
    _, Wx = _drive(plan, x, chunk)
    return Wx, plan.scales_np.squeeze()


def stream_ssq_stft(x, chunk, window=None, n_fft=None, fs=1., **kw):
    """Offline convenience: streaming ssq_stft over a full signal.
    Returns (Tx, Sx, ssq_freqs, Sfs)."""
    x = _record(x)
    plan = StreamingSSQSTFT(chunk, window, n_fft, fs=fs, **kw)
    Tx, Sx = _drive(plan, x, chunk)
    return Tx, Sx, plan.ssq_freqs_out, plan.Sfs


def stream_ssq_stft2(x, chunk, window=None, n_fft=None, fs=1., **kw):
    """Offline convenience: streaming second-order ssq_stft (FSST2) over
    a full signal. Returns (Tx, Sx, ssq_freqs, Sfs)."""
    x = _record(x)
    plan = StreamingSSQSTFT2(chunk, window, n_fft, fs=fs, **kw)
    Tx, Sx = _drive(plan, x, chunk)
    return Tx, Sx, plan.ssq_freqs_out, plan.Sfs


def stream_stft(x, chunk, window=None, n_fft=None, fs=1., **kw):
    """Offline convenience for the streaming STFT. Returns Sx."""
    x = _record(x)
    kw.pop('ssq', None)
    plan = StreamingSSQSTFT(chunk, window, n_fft, fs=fs, ssq=False, **kw)
    _, Sx = _drive(plan, x, chunk)
    return Sx
