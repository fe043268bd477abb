# -*- coding: utf-8 -*-
"""Hop-1 STFT rows from precomputed window tables: the kernel
`csrc/stft_conv.cu` and its plain PyTorch version.

Replaces `ssqueezepy_tpu/ops/stft_conv.py::_make_stft_kernel`
(`stft_pallas_rows`, `stft_conv_bins`, `stft_conv`). From the full
spectrum xh (Np2,) of the padded signal, or a batch of them (B, Np2),
and the row tables H, Hd (n_rows, Np2) of `ops/stft_conv.py` it returns,
for output columns [0, N), planes (n_rows, N) or (B, n_rows, N):

  * Sx = ifft(H * xh)                                  (Hd None)
  * Sx and dSx = fs * ifft(Hd * xh)                    (bins None)
  * Sx and the int32 bin plane k of the synchrosqueezed STFT, k = -1 on
    gamma-gated cells; dSx stays inside the kernel     (bins given)

`fsst2_conv` (B7) is the kernel's FSST2 mode, replacing
`ssqueezepy_tpu/ops/stft_conv.py::fsst2_pallas_rows`: from the five
tables of `conv_bank` (windows g, g', t g, t g', g'') it returns V, the
STFT with g, and the int32 bin plane k of the chirp-corrected frequency
w2 (`fsst2_rows`); the four auxiliary transforms stay inside the kernel.
`fsst2_w` is the same mode with w2 written in place of its bins (V, w2),
for `ssq_stft2(get_w=True)`; the JAX package computes that plane on its
XLA path (`ssqueezepy_tpu/models/ssq_stft.py::_fsst2_rows`).

The inverse DFT runs inside the kernel (four-step, mixed radix 4/2/3/5 in
shared memory; design and bound are noted in the source). A table is
full, (n_rows, Np2), or a `BandedTable`: the TPU kernel's band plan, each
row cut to the rows of its (f1, f2) view that hold its spectral band
(`ops/stft_conv.py` plans and builds them). The kernel reads only those
and takes the products outside the band as zero; the plain versions
expand the band into a zero-filled full table. `stft_length_rule` is the
kernel's one rule on the transform length, checked on every device (by
each wrapper, and by the models before the signal's FFT, through
`stft_kernel_fits`: past it they take the general route).

`stft_conv`, `fsst2_conv` and `fsst2_w` launch the kernel for CUDA
tensors and run their plain versions for CPU tensors. Where autograd
records and xh (or a table) requires grad, each runs the same launch
through its `torch.autograd.Function` (`StftConvGrad`, `Fsst2ConvGrad`,
`Fsst2WGrad`; base `ops/adjoint.py::Adjoint`), whose backward is the
gradient of the plain formulation of the floating outputs (torch ops on
the tensors' device; the bins carry none). The JAX package defines no
VJP for its STFT kernels and differentiates its STFT on the XLA path;
these keep one rule on every device: the CPU path differentiates the
plain versions, the card the same formulation around its kernel. A batch
runs as B * n_rows rows of one launch pair per chunk, each row
bit-identical to its signal run alone. `stft_conv.launches`, `fsst2_conv.launches` and
`fsst2_w.launches` (one signal), and the same wrappers'
`batched_launches` (a batch) count calls of the C entry point (one per
chunk of rows); each issues two CUDA launches. Of those, the calls on
banded tables also count on `banded_launches` / `banded_batched_launches`.
"""
import collections
import ctypes
import functools

import numpy as np
import torch

from ..utils.common import not_ported
from . import _build
from .adjoint import Adjoint, needs_grad
from .phase import cdiv, cmul, div_tiny

__all__ = ['stft_conv', 'stft_conv_plain', 'fsst2_conv', 'fsst2_conv_plain',
           'fsst2_w', 'fsst2_rows', 'split_fft_len', 'launch_plan',
           'stft_length_rule', 'stft_kernel_fits', 'radices',
           'BandedTable', 'full_table', 'StftConvGrad', 'Fsst2ConvGrad',
           'Fsst2WGrad']

_TWO_PI = 6.283185307179586
_MODE_SX, _MODE_SX_DSX, _MODE_BINS, _MODE_FSST2, _MODE_FSST2_W = range(5)
_PLANES = {_MODE_SX: 1, _MODE_SX_DSX: 2, _MODE_BINS: 2, _MODE_FSST2: 5,
           _MODE_FSST2_W: 5}
# the bin map's arguments where a mode writes no bin
_NO_BINS = dict(mode='lin', vmin=0., dv=1., omax=0)

_SCRATCH_BUDGET = 2 << 30
_SMEM_TARGET = 112 * 1024
_SMEM_MAX = 220 * 1024
_MAX_LEN = 1 << 22
_MAX_GRID_Y = 65535
# bytes of shared memory one wavefront serves: 16 threads of 8-byte
# (complex64) or 8 of 16-byte (complex128) accesses
_WAVEFRONT = 128
# columns per block at most
_MAX_COLUMNS = 8
# planes per block up to which the first pass reads device memory itself
# (`Direct` in csrc/stft_conv.cu holds the same number); with more, a
# gather into shared memory comes first
_DIRECT_MAX_PLANES = 2


def split_fft_len(n):
    """(f1, f2) with n = f1 * f2 for the kernel's four-step transform:
    n must be 2^a * {1, 3, 5, 9, 15} (the lengths `next_fft_len` gives)
    with 4 <= n <= 2^22; f2 is the power of two that makes the larger
    factor smallest."""
    a, r = 0, int(n)
    while r % 2 == 0:
        r //= 2
        a += 1
    if r not in (1, 3, 5, 9, 15) or not 4 <= n <= _MAX_LEN:
        not_ported("the CUDA STFT kernel at transform length %d (it takes "
                   "2^a * {1, 3, 5, 9, 15} in [4, 2^22], the lengths of "
                   "N + n_fft - 1 <= 2^22; the ceiling stays with the "
                   "band plan, which cuts each table row to its band but "
                   "keeps the spectrum and the scratch planes at full "
                   "length)" % n, 'C1b')
    best = None
    for b in range(a + 1):
        f1, f2 = n >> b, 1 << b
        key = (max(f1, f2), -f1)
        if best is None or key < best[0]:
            best = (key, f1, f2)
    return best[1], best[2]


def radices(L):
    """The passes of the kernel's length-L transform, in order: (radix R,
    Ns = the product of the radices before it); radix 4 while 4 divides
    what is left, then 2, 3, 5, 7 (Stockham autosort, natural order in and
    out; csrc/dft_mixed.cuh, also the CWT kernel's mixed path)."""
    out, Ns, rem = [], 1, int(L)
    while rem > 1:
        R = (4 if rem % 4 == 0 else 2 if rem % 2 == 0 else
             3 if rem % 3 == 0 else 5 if rem % 5 == 0 else 7)
        out.append((R, Ns))
        Ns *= R
        rem //= R
    return out


def _columns(L, other, itemsize, planes, stride):
    """Columns per block P: the fewest (a power of two, at most
    `_MAX_COLUMNS`) that give the passes at least 8 sequences (planes * P:
    a half-warp then spans two indices j at most) and the gathers whole
    32-byte sectors (P * itemsize >= 32), halved until P divides `other`
    and the block's shared memory (the L twiddles and two buffers of
    planes * P sequences `stride` elements apart) fits the target; one
    column up to the card's limit, and None where not even one fits.
    Fewer columns leave room for more blocks per SM, which times faster
    than conflict-free passes over 16 sequences
    (scripts/torch_stft_plan_sweep.py)."""
    smem = lambda P: (L + 2 * planes * P * stride) * itemsize
    P = 1
    while P < _MAX_COLUMNS and (planes * P < 8 or P * itemsize < 32):
        P *= 2
    while P > 1 and (other % P or smem(P) > _SMEM_TARGET):
        P //= 2
    return P if smem(P) <= _SMEM_MAX else None


LaunchPlan = collections.namedtuple(
    'LaunchPlan', 'f1 f2 direct P1 P2 S1 S2 sw1 sw2 smem1 smem2')


@functools.lru_cache(maxsize=256)
def launch_plan(Np2, itemsize, planes):
    """Launch plan of the DFT engine for `planes` planes (1: Sx; 2: Sx and
    dSx, or bins mode; 5: FSST2; both launches take all of them per
    block): whether the first pass reads device memory itself (`direct`,
    up to `_DIRECT_MAX_PLANES`) or a gather first, and per stage the
    columns per block P, the sequence stride S = L | 1 (L + 1 for even L:
    odd, so the sequences at one position fall on distinct bank pairs),
    the swizzle width sw (the low bits reversed where a thread group walks
    P columns fastest and positions next, in a gather and in the stage-2
    epilogue, so that its 16 / P positions lie P apart: log2 of the
    elements one wavefront serves, at most the power of two in L, which
    keeps the walk a bijection on [0, L)) and the dynamic shared bytes."""
    f1, f2 = split_fft_len(Np2)
    wave = (_WAVEFRONT // itemsize).bit_length() - 1

    def stage(L, other):
        S = L | 1
        P = _columns(L, other, itemsize, planes, S)
        if P is None:
            not_ported("the CUDA STFT kernel at transform length %d, %d "
                       "plane(s) of %d-byte elements (its DFT factor %d "
                       "exceeds one block's shared memory)"
                       % (Np2, planes, itemsize, L), 'C1b')
        sw = min(wave, (L & -L).bit_length() - 1)
        return P, S, sw, (L + 2 * planes * P * S) * itemsize

    (P1, S1, sw1, sm1), (P2, S2, sw2, sm2) = stage(f1, f2), stage(f2, f1)
    return LaunchPlan(f1, f2, planes <= _DIRECT_MAX_PLANES, P1, P2, S1, S2,
                      sw1, sw2, sm1, sm2)


def stft_length_rule(Np2, itemsize, planes):
    """The STFT table kernel's one rule on the transform length, checked
    on every device before the signal's FFT and by each wrapper: Np2 =
    2^a * {1, 3, 5, 9, 15} in [4, 2^22] (`split_fft_len`), whose plan for
    `planes` planes (1: Sx; 2: Sx and dSx, or bins mode; 5: FSST2) of
    complex elements of `itemsize` bytes fits one block's shared memory
    (`launch_plan`). Beyond either it raises naming C1b. The band plan
    (`BandedTable`) does not move the ceiling: it cuts each table row to
    its band, but the spectrum and the scratch planes keep rows x Np2
    elements. Returns the plan."""
    return launch_plan(int(Np2), int(itemsize), int(planes))


def stft_kernel_fits(Np2, itemsize, planes):
    """Whether `stft_length_rule` admits the transform length Np2 for
    `planes` planes of `itemsize`-byte complex elements. The public entry
    points ask it before the signal's FFT and take the general route
    (`models/stft.py::stft_general`) where it is False; the wrappers keep
    the rule, and raise past it."""
    try:
        stft_length_rule(Np2, itemsize, planes)
    except NotImplementedError:
        return False
    return True


class BandedTable:
    """A window table, or a stack of them, cut to each row's spectral
    band (the TPU kernel's band plan; `ops/stft_conv.py` plans and builds
    it). `t` (..., n_rows, br, f2) complex: row i holds the rows
    m1 = (r0[i] + r) % f1, r < br, of the full table's (f1, f2) view
    (spectrum index m = m1 f2 + m2, the split of `split_fft_len`); the
    rows outside the band are zero. `r0` the (n_rows,) int32 band starts
    on t's device, `r0_host` their numpy copy (the wrappers check it,
    with no device sync). A full table is the band br = f1, r0 = 0.
    `band[lo:hi]` is the row block lo:hi (t's rows and r0; br kept),
    `band.plane(q)` the q-th table of a stack."""

    def __init__(self, t, r0, f1, r0_host=None):
        self.t, self.r0, self.f1 = t, r0, int(f1)
        self.r0_host = r0.cpu().numpy() if r0_host is None else r0_host

    @property
    def br(self):
        return self.t.shape[-2]

    @property
    def n_rows(self):
        return self.t.shape[-3]

    def with_t(self, t):
        """The band of `self` holding `t` (t's shape)."""
        return BandedTable(t, self.r0, self.f1, self.r0_host)

    def __getitem__(self, rows):
        if not isinstance(rows, slice) or rows.step not in (None, 1):
            raise TypeError("a BandedTable takes a row block [lo:hi]")
        return BandedTable(self.t[..., rows, :, :].contiguous(),
                           self.r0[rows], self.f1, self.r0_host[rows])

    def plane(self, q):
        return self.with_t(self.t[q])

    def expand(self):
        """The full (..., n_rows, f1 * f2) table, zero outside the band
        (differentiable in t)."""
        t = self.t
        n_rows, br, f2 = t.shape[-3:]
        idx = (self.r0.long()[:, None]
               + torch.arange(br, device=t.device)) % self.f1
        full = t.new_zeros(t.shape[:-3] + (n_rows, self.f1, f2))
        return full.scatter(-2, idx[:, :, None].expand(t.shape), t).reshape(
            t.shape[:-3] + (n_rows, self.f1 * f2))


def full_table(tab):
    """`tab` as a full table: a `BandedTable` expanded, a tensor (or
    None) as it is."""
    return tab.expand() if isinstance(tab, BandedTable) else tab


def _tensor(tab):
    """The tensor of a table (a band's packed `t`), or None."""
    return tab.t if isinstance(tab, BandedTable) else tab


def _like(t, tab):
    """The tensor `t` in the form of the table `tab`: on tab's band where
    tab is a `BandedTable`, else t itself."""
    return tab.with_t(t) if isinstance(tab, BandedTable) else t


def _n_rows(tab):
    return tab.n_rows if isinstance(tab, BandedTable) else tab.shape[-2]


def _check_band(xh, band):
    """A banded (n_rows, br, f2) table against the spectrum xh: the
    kernel's split, br in [1, f1], r0 (n_rows,) int32 on xh's device,
    0 <= r0 < f1."""
    f1, f2 = split_fft_len(xh.shape[-1])
    t, r0 = band.t, band.r0
    if (t.dim() != 3 or band.f1 != f1 or t.shape[-1] != f2
            or not 1 <= band.br <= f1):
        raise ValueError("a banded table must be (n_rows, br, %d) with "
                         "1 <= br <= f1 = %d for Np2=%d (got %s, f1=%d)"
                         % (f2, f1, xh.shape[-1], tuple(t.shape), band.f1))
    if (not isinstance(r0, torch.Tensor) or r0.dtype != torch.int32
            or r0.shape != (band.n_rows,) or r0.device != xh.device
            or not r0.is_contiguous()
            or np.shape(band.r0_host) != (band.n_rows,)):
        raise ValueError("a band's r0 must be a contiguous (n_rows,) int32 "
                         "tensor on xh's device")
    if not ((band.r0_host >= 0) & (band.r0_host < f1)).all():
        raise ValueError("a band's r0 must lie in [0, f1=%d)" % f1)


def _check(xh, H, Hd, N, bins, planes=None):
    banded = isinstance(H, BandedTable)
    if Hd is not None and isinstance(Hd, BandedTable) != banded:
        raise TypeError("H and Hd must both be full or both banded")
    if xh.dim() not in (1, 2):
        raise ValueError("xh must be (Np2,) or a (B, Np2) batch (got %s)"
                         % (tuple(xh.shape),))
    if banded:
        for t in (H, Hd):
            if t is not None:
                _check_band(xh, t)
        if Hd is not None and (Hd.t.shape != H.t.shape or
                               not np.array_equal(Hd.r0_host, H.r0_host)):
            raise ValueError("Hd must be banded as H is (its shape and r0)")
    elif H.dim() != 2 or H.shape[1] != xh.shape[-1]:
        raise ValueError("xh must be (Np2,) or a (B, Np2) batch and H "
                         "(n_rows, Np2) (got %s, %s)"
                         % (tuple(xh.shape), tuple(H.shape)))
    elif Hd is not None and Hd.shape != H.shape:
        raise ValueError("Hd must have H's shape (got %s)"
                         % (tuple(Hd.shape),))
    if bins is not None and Hd is None:
        raise ValueError("bins mode needs Hd")
    if not 1 <= N <= xh.shape[-1]:
        raise ValueError("N=%d must lie in [1, Np2=%d]" % (N, xh.shape[-1]))
    if xh.dtype not in (torch.complex64, torch.complex128):
        raise TypeError("xh must be complex64 or complex128 (got %s)"
                        % xh.dtype)
    tabs = tuple(_tensor(t) for t in (H, Hd) if t is not None)
    if any(t.dtype != xh.dtype or t.device != xh.device for t in tabs):
        raise TypeError("H and Hd must share xh's dtype and device")
    if not all(t.is_contiguous() for t in (xh,) + tabs):
        raise ValueError("xh, H and Hd must be contiguous")
    if bins is not None:
        _check_bins(xh, _n_rows(H), bins)
    # the one length rule, every device
    stft_length_rule(xh.shape[-1], xh.element_size(),
                     planes or (1 if Hd is None else 2))


def _check_bins(xh, n_rows, bins):
    sfs = bins['Sfs']
    rdt = torch.float32 if xh.dtype == torch.complex64 else torch.float64
    if (sfs.shape != (n_rows,) or sfs.dtype != rdt
            or sfs.device != xh.device or not sfs.is_contiguous()):
        raise ValueError("bins['Sfs'] must be a contiguous (n_rows,) "
                         "tensor of xh's real type on its device")
    if bins['params']['mode'] != 'lin':
        raise ValueError("the STFT bin map is 'lin' (got %r)"
                         % bins['params']['mode'])


def stft_conv_plain(xh, H, Hd, N, fs=1., bins=None):
    """Plain version: the row products, `torch.fft.ifft`, and in bins
    mode `phase_transform_w(..., Sfs)` and `compute_bins`; one spectrum
    or a batch; banded tables expanded to full ones first."""
    from .phase import phase_transform_w
    from .ssq_kernels import compute_bins
    H, Hd = full_table(H), full_table(Hd)
    xr = xh[..., None, :]
    Sx = torch.fft.ifft(H * xr, dim=-1)[..., :N].contiguous()
    if Hd is None:
        return Sx, None
    dSx = (torch.fft.ifft(Hd * xr, dim=-1)[..., :N] * fs).contiguous()
    if bins is None:
        return Sx, dSx
    w = phase_transform_w(Sx, dSx, bins['gamma'], bins['Sfs'])
    k, valid = compute_bins(w, bins['params'], bins['flipud'])
    return Sx, torch.where(valid, k, torch.full_like(k, -1))


def stft_conv(xh, H, Hd, N, fs=1., bins=None):
    """STFT rows [0, N) from the spectrum `xh` (Np2,) of the padded
    signal, or a (B, Np2) batch of them, and the row tables `H`, `Hd`
    (n_rows, Np2), or two `BandedTable`s of one band (`Hd` None: Sx
    only). `bins`, when given, is a dict with `Sfs` (n_rows,) tensor,
    `params` (a 'lin' `ssq_bin_params`), `gamma` and `flipud`. Returns
    (Sx, dSx), (Sx, k) or (Sx, None), each (n_rows, N) or
    (B, n_rows, N)."""
    _check(xh, H, Hd, N, bins)
    tab_H, tab_Hd = H, Hd

    def run(xh, H, Hd):
        H, Hd = _like(H, tab_H), _like(Hd, tab_Hd)
        if xh.device.type == 'cpu':
            return stft_conv_plain(xh, H, Hd, N, fs, bins)
        if xh.device.type != 'cuda':
            raise RuntimeError("stft_conv runs on CUDA or CPU tensors (got "
                               "%s)" % xh.device)
        mode = (_MODE_SX if Hd is None else
                _MODE_SX_DSX if bins is None else _MODE_BINS)
        shape, dev = xh.shape[:-1] + (_n_rows(H), N), xh.device
        Sx = torch.empty(shape, dtype=xh.dtype, device=dev)
        out2 = None
        if mode == _MODE_SX_DSX:
            out2 = torch.empty(shape, dtype=xh.dtype, device=dev)
        elif mode == _MODE_BINS:
            out2 = torch.empty(shape, dtype=torch.int32, device=dev)
        _launch(stft_conv, mode, xh, H, Hd, N, fs, bins, Sx, out2)
        return Sx, out2

    H, Hd = _tensor(H), _tensor(Hd)
    if not needs_grad(xh, H, Hd):
        return run(xh, H, Hd)

    def vjp(xh, H, Hd):
        # the bins mode differentiates Sx alone
        return stft_conv_plain(xh, _like(H, tab_H), None if bins is not None
                               else _like(Hd, tab_Hd), N, fs)
    return StftConvGrad.apply(run, vjp, xh, H, Hd)


class StftConvGrad(Adjoint):
    """`stft_conv` (B6, three modes) under autograd: (Sx, dSx), (Sx, k)
    or (Sx, None), k carrying no gradient. Backward: the gradient of
    `stft_conv_plain` (Sx, or Sx and dSx; the bins mode's Sx alone,
    neither the phase transform nor the bins recomputed) with respect to
    xh and the tables (a band's packed rows)."""


stft_conv.launches = 0
stft_conv.batched_launches = 0
stft_conv.banded_launches = 0
stft_conv.banded_batched_launches = 0


def _launch(wrapper, mode, xh, H, Hd, N, fs, bins, Sx, out2):
    """Run the two-launch kernel over every row of `Sx` ((B *) n_rows
    rows, global row b * n_rows + i), chunking rows to the scratch
    budget; counts each C call on `wrapper.launches` (one signal) or
    `wrapper.batched_launches` (a batch). In the FSST2 mode `H` is the
    bank and `Hd` is None. Banded tables pass their packed rows, r0 and
    br; full ones br = f1 and no r0."""
    lib = _build.load('stft_conv')
    Np2 = xh.shape[-1]
    planes = _PLANES[mode]
    itemsize = xh.element_size()
    sp = launch_plan(Np2, itemsize, planes)
    if isinstance(H, BandedTable):
        r0, br = H.r0.data_ptr(), H.br
    else:
        r0, br = None, sp.f1
    tab_rows = _n_rows(H)
    H, Hd = _tensor(H), _tensor(Hd)
    n_rows = Sx.numel() // N
    counter = 'batched_launches' if xh.dim() == 2 else 'launches'
    banded = 'banded_' + counter if r0 is not None else None
    dev = xh.device
    rows = max(1, min(n_rows, _MAX_GRID_Y,
                      _SCRATCH_BUDGET // (planes * Np2 * itemsize)))
    scratch = torch.empty((planes, rows, Np2), dtype=xh.dtype, device=dev)
    if bins is not None:
        p = bins['params']
        omax, flipud, sfs = p['omax'], bins['flipud'], bins['Sfs'].data_ptr()
        dp = (ctypes.c_double * 8)(1.0 / Np2, fs, bins['gamma'], p['vmin'],
                                   p['dv'], div_tiny(xh.dtype), _TWO_PI,
                                   fs / _TWO_PI)
    else:
        omax, flipud, sfs = 0, False, None
        dp = (ctypes.c_double * 8)(1.0 / Np2, fs, 0., 0., 1., 0., _TWO_PI,
                                   fs / _TWO_PI)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn = (lib.stft_conv_f32 if xh.dtype == torch.complex64
          else lib.stft_conv_f64)
    for row0 in range(0, n_rows, rows):
        nr = min(rows, n_rows - row0)
        # ip: Np2, f1, f2, N, P1, P2, rows, row0, mode, omax, flipud,
        # table rows, S1, S2, sw1, sw2, br
        ip = (ctypes.c_int * 17)(Np2, sp.f1, sp.f2, N, sp.P1, sp.P2, nr,
                                 row0, mode, int(omax), int(bool(flipud)),
                                 tab_rows, sp.S1, sp.S2, sp.sw1, sp.sw2, br)
        err = fn(xh.data_ptr(), H.data_ptr(),
                 None if Hd is None else Hd.data_ptr(), r0, sfs, ip, dp,
                 scratch.data_ptr(), Sx.data_ptr(),
                 None if out2 is None else out2.data_ptr(), stream)
        _build.check(err, wrapper.__name__)
        setattr(wrapper, counter, getattr(wrapper, counter) + 1)
        if banded:
            setattr(wrapper, banded, getattr(wrapper, banded) + 1)


def fsst2_rows(xh, tables, N, fs, Sfs, gamma):
    """(V, w2) of the second-order STFT, step by step with torch.fft (the
    XLA twin `_fsst2_rows` of `ssqueezepy_tpu/models/ssq_stft.py`), for
    one spectrum xh (Np2,) or a (B, Np2) batch: the
    five rows V, Vg1, Vt, Vtd, Vd2 = ifft(tables * xh)[..., :N] of the
    windows g, g', t g, t g', g'' (per-sample units), then
    w1 = Sfs - fs Im(Vg1 / V) / 2pi, q = Im((Vd2 V - Vg1^2) /
    (Vtd V - Vt Vg1)), w2 = |w1 + (fs / 2pi) q Re(Vt / V)|, regularized
    divides; inf where not finite or where |V|^2 <= gamma^2. A banded
    bank is expanded to full tables first."""
    V, Vg1, Vt, Vtd, Vd2 = torch.fft.ifft(
        full_table(tables) * xh[..., None, None, :],
        dim=-1)[..., :N].unbind(-3)
    tiny = div_tiny(xh.dtype)
    sfs = Sfs.to(V.real.dtype).reshape(-1, 1)
    w1 = sfs - fs * cdiv(Vg1, V, tiny).imag / _TWO_PI
    trel = cdiv(Vt, V, tiny).real
    q = cdiv(cmul(Vd2, V) - cmul(Vg1, Vg1), cmul(Vtd, V) - cmul(Vt, Vg1),
             tiny).imag
    w2 = (w1 + (fs / _TWO_PI) * q * trel).abs()
    inf = torch.full_like(w2, float('inf'))
    w2 = torch.where(torch.isfinite(w2), w2, inf)
    big = V.real * V.real + V.imag * V.imag > \
        torch.tensor(gamma, dtype=w2.dtype) ** 2
    return V.contiguous(), torch.where(big, w2, inf)


def fsst2_conv_plain(xh, tables, N, fs, bins):
    """Plain version: `fsst2_rows`, then `compute_bins` on w2."""
    from .ssq_kernels import compute_bins
    V, w2 = fsst2_rows(xh, tables, N, fs, bins['Sfs'], bins['gamma'])
    k, valid = compute_bins(w2, bins['params'], bins['flipud'])
    return V, torch.where(valid, k, torch.full_like(k, -1))


def _check_bank(xh, tables, N, bins):
    t = _tensor(tables)
    banded = isinstance(tables, BandedTable)
    if t.dim() != 3 + banded or t.shape[0] != 5:
        raise ValueError("tables must be the (5, n_rows, Np2) FSST2 bank "
                         "or its band (5, n_rows, br, f2) (got %s)"
                         % (tuple(t.shape),))
    _check(xh, _plane0(tables), None, N, None, _PLANES[_MODE_FSST2])
    _check_bins(xh, t.shape[1], bins)
    if not t.is_contiguous():
        raise ValueError("tables must be contiguous")


def _plane0(tables):
    """The first table of a bank, full or banded."""
    return (tables.plane(0) if isinstance(tables, BandedTable)
            else tables[0])


def fsst2_conv(xh, tables, N, fs, bins):
    """(V, k) of the second-order synchrosqueezed STFT (FSST2), rows
    [0, N), from the spectrum `xh` (Np2,) of the padded signal, or a
    (B, Np2) batch of them, and the (5, n_rows, Np2) tables of
    `conv_bank` (windows g, g', t g, t g', g''), or their `BandedTable`
    (5, n_rows, br, f2). `bins` as for `stft_conv`. V (n_rows, N) or
    (B, n_rows, N) is the STFT with g; k of V's shape int32 the lin bin
    of w2, -1 on gamma-gated or non-finite cells."""
    _check_bank(xh, tables, N, bins)
    bank = tables

    def run(xh, tables):
        tables = _like(tables, bank)
        if xh.device.type == 'cpu':
            return fsst2_conv_plain(xh, tables, N, fs, bins)
        if xh.device.type != 'cuda':
            raise RuntimeError("fsst2_conv runs on CUDA or CPU tensors (got "
                               "%s)" % xh.device)
        shape = xh.shape[:-1] + (_n_rows(tables), N)
        V = torch.empty(shape, dtype=xh.dtype, device=xh.device)
        k = torch.empty(shape, dtype=torch.int32, device=xh.device)
        _launch(fsst2_conv, _MODE_FSST2, xh, tables, None, N, fs, bins, V,
                k)
        return V, k

    tables = _tensor(tables)
    if not needs_grad(xh, tables):
        return run(xh, tables)

    def vjp(xh, tables):
        return stft_conv_plain(xh, _plane0(_like(tables, bank)), None,
                               N)[0], None
    return Fsst2ConvGrad.apply(run, vjp, xh, tables)


class Fsst2ConvGrad(Adjoint):
    """`fsst2_conv` (B7) under autograd: (V, k), k carrying no gradient.
    Backward: the gradient of V alone, ifft(tables[0] * xh)[..., :N] (the
    first plane of `fsst2_rows`, by `stft_conv_plain`), with respect to
    xh and the tables; the four auxiliary transforms and the bins are
    never recomputed."""


fsst2_conv.launches = 0
fsst2_conv.batched_launches = 0
fsst2_conv.banded_launches = 0
fsst2_conv.banded_batched_launches = 0


def fsst2_w(xh, tables, N, fs, Sfs, gamma):
    """(V, w2) of the second-order STFT (FSST2), rows [0, N), from the
    spectrum `xh` (Np2,) of the padded signal, or a (B, Np2) batch of
    them, and the (5, n_rows, Np2) tables of `conv_bank` or their
    `BandedTable`: V (n_rows, N) or (B, n_rows, N) the STFT with g, w2 of
    V's shape and real type the
    chirp-corrected frequency, inf where not finite or where |V|^2 <=
    gamma^2 (the plane whose bins `fsst2_conv` returns: B7's w2 mode).
    `Sfs` (n_rows,) the row frequencies. Plain version: `fsst2_rows`."""
    bins = dict(Sfs=Sfs, gamma=float(gamma), params=_NO_BINS, flipud=False)
    _check_bank(xh, tables, N, bins)
    bank = tables

    def plain(xh, tables, Sfs):
        return fsst2_rows(xh, _like(tables, bank), N, fs, Sfs, gamma)

    def run(xh, tables, Sfs):
        if xh.device.type == 'cpu':
            return plain(xh, tables, Sfs)
        if xh.device.type != 'cuda':
            raise RuntimeError("fsst2_w runs on CUDA or CPU tensors (got %s)"
                               % xh.device)
        shape = xh.shape[:-1] + (tables.shape[1], N)
        V = torch.empty(shape, dtype=xh.dtype, device=xh.device)
        w2 = torch.empty(shape, dtype=Sfs.dtype, device=xh.device)
        _launch(fsst2_w, _MODE_FSST2_W, xh, _like(tables, bank), None, N,
                fs, bins, V, w2)
        return V, w2

    tables = _tensor(tables)
    if not needs_grad(xh, tables, Sfs):
        return run(xh, tables, Sfs)
    return Fsst2WGrad.apply(run, plain, xh, tables, Sfs)


class Fsst2WGrad(Adjoint):
    """`fsst2_w` (B7's w2 mode) under autograd: (V, w2). Backward: the
    gradient of `fsst2_rows` in both outputs with respect to xh, the
    tables and Sfs (the JAX package's `get_w` differentiates its XLA twin
    `_fsst2_rows`)."""


fsst2_w.launches = 0
fsst2_w.batched_launches = 0
fsst2_w.banded_launches = 0
fsst2_w.banded_batched_launches = 0
