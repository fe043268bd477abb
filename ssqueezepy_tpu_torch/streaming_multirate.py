# -*- coding: utf-8 -*-
"""Octave-cascaded (multirate) streaming synchrosqueezed CWT.

Counterpart of `ssqueezepy_tpu/streaming_multirate.py`. `StreamingSSQCWT`
computes every scale at the full sample rate, so its window, and its
transform's cost, is sized by the largest scale's time support. A scale
whose passband lies below ``pi / 2^j`` can be computed on a 2^j-decimated
stream, where its support is 2^j times fewer samples. This plan splits
the scale axis into octave blocks, runs a halfband decimation cascade
(`ops/multirate.py`) over each chunk's window, transforms each block at
its own rate, interpolates the block's Wx/dWx rows back to the full rate,
and reassigns all rows in one scatter. Latency does not change: the plan
derives (history, lookahead) from the slowest octave's geometry.

Alignment (all plan-time, as in the JAX package): with taps-long
halfband filters, g = (taps-1)/2, an octave-j sample at decimated index m
sits at full-rate time ``m 2^j + g (2^j - 1)``; j interpolation stages
add another ``g (2^j - 1)``, so emitting full-rate columns [h, h + c) of
the window needs decimated columns from ``a_j = floor((h - 2g(2^j-1)) /
2^j)`` with the sub-sample crop ``o_j = h - a_j 2^j - 2g(2^j-1)``. The
plan grows (history, lookahead) until every octave's columns lie an
octave support away from its decimated window's edges.

Per chunk: the cascade (`conv_valid` then every second sample, once per
level, shared by the blocks), each block's window padded by reflection to
`next_fft_len` of its length, `torch.fft.rfft`, the CWT kernel with two
planes (`ops/cwt_cuda.py::cwt_fused(..., derivative=True)`, B3) at
scales/2^j, dt 2^j, n1 = a_j, N = L_j; `interp2` j times and the crop;
then the phase transform, `compute_bins` and the generic scatter (B5), as
the JAX package's body runs. A wavelet off the kernel's route, or a
block whose n_up is past the kernel's rule (`ops/cwt_cuda.py::
cwt_kernel_fits`, asked per block when the plan is made), takes
`models/cwt.py::cwt_general`; the scatter is `ops/ssq_kernels.py::
scatter_general` past its rule. The scales, pad indices, wavelet tables
and FIR taps of every block are built once, with the plan.
"""
import numpy as np
import torch

from .models.cwt import cwt_general, _kernel_route
from .ops.cwt_cuda import cwt_fused, cwt_kernel_fits, wavelet_table
from .ops.fft import next_fft_len, rfft
from .ops.multirate import conv_valid, halfband_fir, interp2
from .ops.pad import _pad_index
from .streaming import _StreamingBase, _one_signal, _rebatch

__all__ = ['StreamingMultirateSSQCWT']


def _freq_support(wavelet, thresh=1e-6):
    """Largest w with |psih(w)| > thresh*max at scale 1 (rad/sample)."""
    w = np.linspace(0, 32 * np.pi, 1 << 15)
    try:
        p = np.abs(np.asarray(wavelet.fn(w, xp=np), np.float64))
    except Exception:
        # the JAX package's fallback for a fn that takes no numpy input
        return np.pi
    keep = p > thresh * p.max()
    return float(w[keep][-1]) if keep.any() else np.pi


class StreamingMultirateSSQCWT(_StreamingBase):
    """Online SSQ-CWT with per-octave decimated computation.

    Same `process`/`finalize` contract as `StreamingSSQCWT`; the plan
    sizes (history, lookahead) itself so every scale row is reliable
    (pass `lookahead` to cap latency: a value below what the slowest
    octave needs raises). Full-rate rows match `StreamingSSQCWT`;
    decimated rows add the halfband cascade's passband error (~1e-4
    relative).
    """

    def __init__(self, chunk, wavelet='gmw', scales='log', nv=32, fs=1.,
                 N=None, lookahead=None, halo_mult=8.0, taps=63,
                 maprange='peak', flipud=True, gamma=None, ssq=True,
                 guard_frac=0.4, device='cuda'):
        self._init_cwt(chunk, wavelet, scales, nv, fs, N, halo_mult,
                       maprange, flipud, gamma, ssq, device)
        self.taps = int(taps)
        sq = self.scales_np.squeeze()

        # octave per scale: wmax(s) = wmax(1)/s must sit below
        # guard_frac * pi at the octave's rate (guard below the halfband
        # cutoff pi/2 so the cascade's passband error stays at ripple level)
        wmax1 = _freq_support(self.wavelet)
        wmax = wmax1 / sq
        oct_f = np.floor(np.log2(np.maximum(guard_frac * np.pi / wmax,
                                            1.0)))
        # chunk divisibility caps the cascade depth
        j_cap = 0
        while self.chunk % (2 ** (j_cap + 1)) == 0 and j_cap < 8:
            j_cap += 1
        self.octaves = np.minimum(oct_f.astype(int), j_cap)
        self.octaves = np.maximum.accumulate(self.octaves)

        J = int(self.octaves.max())
        blocks = []                      # (j, row_lo, row_hi)
        for j in sorted(set(self.octaves.tolist())):
            idx = np.nonzero(self.octaves == j)[0]
            blocks.append((int(j), int(idx[0]), int(idx[-1]) + 1))
        self._blocks = blocks
        # per-row support (full-rate samples) -> per-octave context at the
        # octave's own rate
        ctx = {}
        for j, lo, hi in blocks:
            ctx[j] = int(np.ceil(self.support_np[lo:hi].max() / 2 ** j)) + 8
        self._ctx = ctx

        # ---- window geometry: grow (h, l) until every octave fits ----
        g = (self.taps - 1) // 2
        t1 = self.taps - 1
        c = self.chunk
        h = ctx.get(0, 64)
        for j, lo, hi in blocks:
            if j > 0:
                h = max(h, 2 * g * (2 ** j - 1) + (ctx[j] + 1) * 2 ** j)
        l_req = ctx.get(0, 64)
        while True:
            Wn = h + c + l_req
            ok = True
            geo = {}
            for j, lo, hi in blocks:
                if j == 0:
                    continue
                a = (h - 2 * g * (2 ** j - 1)) // 2 ** j
                o = h - a * 2 ** j - 2 * g * (2 ** j - 1)
                # interp2 consumes `taps` per stage: j stages from L inputs
                # emit 2^j*L - (2^j - 1)*(t1 + 1) columns
                L = -(-(o + c + (2 ** j - 1) * (t1 + 1)) // 2 ** j)
                M = Wn
                for _ in range(j):
                    M = (M - t1 + 1) // 2
                geo[j] = (a, o, L, M)
                if a < ctx[j] or a + L + ctx[j] > M:
                    ok = False
            if ok:
                break
            l_req += max(64, 2 ** J * 8)
        self.history = h
        if lookahead is not None and int(lookahead) < l_req:
            raise ValueError(
                "lookahead=%d is below the %d samples the slowest octave"
                " needs; raise it (or cap the scale range)"
                % (int(lookahead), l_req))
        self.lookahead = int(lookahead) if lookahead is not None \
            else l_req
        # right-margin geometry at the final window size
        Wn = h + c + self.lookahead
        for j in list(geo):
            a, o, L, M = geo[j]
            M = Wn
            for _ in range(j):
                M = (M - t1 + 1) // 2
            geo[j] = (a, o, L, M)
        self._geo = geo

        self._init_state()
        self._init_carry()
        self._build()

    def _build(self):
        """Per block: its rows' scales at the block's rate, the window
        slice or cascade level it transforms, the reflection index to its
        `next_fft_len`, the CWT column span, the crop, its route (the
        kernel's where the wavelet takes it and n_up fits its rule) and
        the wavelet table where the kernel reads one."""
        h, c = self.history, self.chunk
        tdt = getattr(torch, self.dtype)
        itemsize = 2 * np.dtype(self.dtype).itemsize
        self._hfir = halfband_fir(self.taps)
        synth = getattr(self.wavelet.fn, 'kernel_params', None) is not None
        Wn = h + c + self.lookahead
        plans = []
        for j, lo, hi in self._blocks:
            scales = torch.as_tensor(
                np.asarray(self.scales_np[lo:hi], np.float64).reshape(-1)
                / 2 ** j, dtype=tdt, device=self.device)
            if j == 0:
                m = self._ctx[0]
                span, n1, N, crop = (h - m, h + c + m), m, c, None
                n = span[1] - span[0]
            else:
                a, o, L, M = self._geo[j]
                span, n1, N, crop = None, a, L, o
                n = Wn
                for _ in range(j):
                    n = (n - self.taps + 1 + 1) // 2
            n_up = next_fft_len(n)
            kernel = (_kernel_route(self.wavelet, n_up) and
                      cwt_kernel_fits(n_up, itemsize, 2 if self.ssq else 1))
            plans.append(dict(
                j=j, scales=scales, span=span, n1=n1, N=N, crop=crop,
                n_up=n_up, dt=self.dt * 2 ** j, kernel=kernel,
                pad=(_pad_index(n, 0, n_up - n, 'reflect', self.device)
                     if n_up > n else None),
                table=(wavelet_table(self.wavelet, scales, n_up)
                       if kernel and not synth else None)))
        self._plans = plans
        self._kernel = all(p['kernel'] for p in plans)

    def _rows(self, wj, p):
        """(Wx, dWx or None) of one block's rows, at its own rate, over
        columns [n1, n1 + N) of its padded window `wj`."""
        if p['pad'] is not None:
            wj = wj.index_select(-1, p['pad'])
        if not p['kernel']:
            return cwt_general(wj, self.wavelet, p['scales'], p['n1'],
                               p['N'], p['dt'], self.ssq, True)
        xh, one = _one_signal(rfft(wj).contiguous())
        return _rebatch(one, *cwt_fused(
            xh, p['scales'], self.wavelet, p['n_up'], p['n1'], p['N'],
            p['dt'], self.ssq, True, p['table']))

    def _body(self, w):
        c = self.chunk
        levels = [w]                     # the cascade, level j at index j
        parts = []
        for p in self._plans:
            j = p['j']
            while len(levels) <= j:
                levels.append(conv_valid(levels[-1], self._hfir)[..., ::2])
            wj = (w[..., p['span'][0]:p['span'][1]] if j == 0
                  else levels[j])
            planes = [q for q in self._rows(wj, p) if q is not None]
            if j:
                # re and im of Wx (and dWx) up the cascade as one batch
                r = torch.stack([t for q in planes
                                 for t in (q.real, q.imag)])
                for _ in range(j):
                    r = interp2(r, taps=self.taps)
                r = r[..., p['crop']:p['crop'] + c]
                planes = [torch.complex(r[2 * i], r[2 * i + 1])
                          for i in range(len(planes))]
            parts.append(planes)
        Wx = torch.cat([q[0] for q in parts], dim=-2)
        if not self.ssq:
            return None, Wx
        dWx = torch.cat([q[1] for q in parts], dim=-2)
        return self._ssq_from_derivative(Wx, dWx), Wx

    @property
    def ssq_freqs_out(self):
        return self.ssq_freqs[::-1].copy()

    @property
    def compute_ratio(self):
        """Approximate FLOP fraction vs computing every row at full rate
        with the slowest octave's window (the full-rate plan at equal
        accuracy): rows weighted by their octave's decimation."""
        w = 2.0 ** -self.octaves
        return float(w.mean())
