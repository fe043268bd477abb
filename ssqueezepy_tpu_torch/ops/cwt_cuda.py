# -*- coding: utf-8 -*-
"""Fused CWT kernels in `csrc/cwt_bins.cu` and their plain PyTorch
versions. All replace modes of `ssqueezepy_tpu/ops/cwt_pallas.py::
_make_kernel`:

  * `cwt_bins` (B1), its bins + direct mode (`cwt_fused_bins_direct`):
    from the half spectrum of the padded signal, Wx (na, N) complex and
    the reassignment bin plane k (na, N) int32, k = -1 on gamma-gated
    cells; dWx stays inside the kernel. Over a batch of spectra (B3b,
    the bins mode of `cwt_fused_bins_pallas`) it returns Wx and k
    (B, na, N), each row bit-identical to its signal run alone.
  * `cwt_fused` (B3), its plain/derivative mode (`cwt_fused_pallas`):
    Wx, and dWx when asked, for one spectrum (na, N) or a batch of them
    (B, na, N); L1 or L2 (sqrt(scale)) row norm.
  * `cwt_bins2` (B8), its order-2 mode (`cwt_fused_bins2_direct`): the
    five WSST2 banks, the per-cell chirp regression and the bin map ->
    (W, k), for one spectrum (na, N) or a batch of them (B, na, N), each
    row bit-identical to its signal run alone; the four auxiliary
    transforms stay inside the kernel. `cwt_w2` is the same mode with
    w2 written in place of its bins (W, w2), for `ssq_cwt2(get_w=True)`;
    the JAX package computes that plane on its XLA path
    (`ssqueezepy_tpu/models/ssq_cwt2.py::_wsst2_rows`).

Every mode takes any real-valued wavelet: the order-0 GMW is synthesized
in the kernel in closed form (`fn.kernel_params`), any other wavelet is
read from a table that `wavelet_table` evaluates with torch on the
device, psih(a xi) on the half grid (and psih', psih'' for order 2, from
`fn.derivatives` or torch autograd), memoized for the kernel per
wavelet, scales and length, as the JAX kernel traces the wavelet fn into
its body. The plain versions take every wavelet through the same table
function, evaluated anew on each call.

Stage 1 of the kernel forms, for each scale, only the leading rows m1
(f2-wide blocks of the half spectrum, `four_step`) where its wavelet can be
nonzero, and skips the DFT levels that would only copy them, as the JAX
kernel prunes its stage-1 contraction (`ops/cwt_pallas.py::
support_klims`): the limits come from `support_klims` for the closed-form
GMW (its float32 or float64 subnormal threshold, one row of margin, one
more for order 2) and from `table_klims` for a table (exact), one (na,)
int32 tensor on the card per scales or table tensor (`_stage1_klims`),
with no host-device sync on a memo hit. The pruning is exact: beyond a
limit every spectrum term is a zero the unpruned kernel multiplies in
too, so the outputs keep their bits but, at most, the sign of a zero.

The inverse DFT is computed in the kernel itself, four-step, in shared
memory laid out against bank conflicts, for every mode: radix-4 passes
for a power-of-two n_up, the mixed-radix (4, 2, 3, 5, 7) passes of
`csrc/dft_mixed.cuh` for any other n_up >= 4 whose prime factors are at
most 7; design and bound are noted in the source. `cwt_length_rule` is
the kernel's one rule on the length, checked on every device (by each
wrapper, and by the models before the signal's FFT): `four_step` takes
the 7-smooth n_up (`kernel_length`; another raises, and the public entry
points route such lengths to the general path before anything runs) and
`bins_plan` sizes either engine for the mode's planes, one column per
block at most `_SMEM_MAX` bytes (beyond it raises naming C1b).

Each wrapper launches the kernel for CUDA tensors and runs its plain
version for CPU tensors. Where autograd records and xh or the scales
require grad, it runs the same launch through its `torch.autograd.Function`
(`CwtBinsGrad`, `CwtFusedGrad`, `CwtBins2Grad`, `CwtW2Grad`; base
`ops/adjoint.py::Adjoint`), the counterparts of the JAX package's
`_cwt_fused_vjp_fn`, `_cwt_fused_bins_vjp_fn`,
`_cwt_fused_bins_direct_vjp_fn` and `_cwt_fused_bins2_direct_vjp_fn`:
the backward is the gradient of the plain formulation of the
differentiable outputs (torch ops on the tensors' device), the bins
carry none. `cwt_bins.launches`, `cwt_bins2.launches` and
`cwt_w2.launches` (one signal), `cwt_bins.batched_launches`,
`cwt_bins2.batched_launches` and `cwt_w2.batched_launches` (a batch),
and `cwt_fused.launches` count calls of the C entry point on the
radix-4 engine (one per chunk of rows), and the same names prefixed
`mixed_` (`cwt_bins.mixed_launches`, ...) its calls on the mixed engine;
each such call issues two CUDA launches, stage 1 and stage 2. Calls with
a wavelet table count on the same names prefixed `table_`
(`cwt_bins.table_launches`, `cwt_bins.table_mixed_launches`, ...).
"""
import collections
import ctypes
import functools
import math
import weakref

import numpy as np
import torch

from ..models.wavelets import _xifn
from ..utils.common import not_ported
from . import _build
from .adjoint import Adjoint, needs_grad
from .fft import ifft
from .phase import cdiv, cmul, div_tiny

__all__ = ['cwt_bins', 'cwt_bins_plain', 'cwt_fused', 'cwt_fused_plain',
           'cwt_bins2', 'cwt_bins2_plain', 'cwt_w2', 'wsst2_rows',
           'wavelet_table', 'kernel_length', 'four_step', 'bins_plan',
           'cwt_length_rule', 'stage1_rows', 'support_klims', 'table_klims',
           'smem_index', 'swz', 'CwtBinsGrad', 'CwtFusedGrad',
           'CwtBins2Grad', 'CwtW2Grad']

_MODES = {'lin': 0, 'log': 1, 'log-piecewise': 2}
# stage-1 scratch held at once (all planes); rows are chunked beyond it
_SCRATCH_BUDGET = 2 << 30
# the columns per block are halved until a stage fits this target...
_SMEM_BUDGET = 96 * 1024
# ...and one column of either engine may take up to this much (the
# card's limit per block is 227 KB)
_SMEM_MAX = 220 * 1024
_ENGINE_RADIX4, _ENGINE_MIXED = 0, 1
_MAX_GRID_Y = 65535
_OUT_BINS, _OUT_W, _OUT_W_DW, _OUT_BINS2, _OUT_W2 = 0, 1, 2, 3, 4
_PLANES = {_OUT_BINS: 2, _OUT_W: 1, _OUT_W_DW: 2, _OUT_BINS2: 5,
           _OUT_W2: 5}
_TWO_PI = 6.283185307179586
# bytes of shared memory one wavefront serves: 16 threads of 8-byte
# (complex64) or 8 of 16-byte (complex128) accesses
_WAVEFRONT = 128
# columns per block at most: at the main path's plan 8 (4 for 5 planes,
# by the budget) times best in every mode (scripts/torch_cwt_plan_sweep.py),
# also with one plane, where 16 would give the passes 16 sequences and no
# bank conflicts but half the blocks per SM
_MAX_COLUMNS = 8
# wavelet tables held at once (`wavelet_table`)
_TABLE_SLOTS = 4
_TABLES = collections.OrderedDict()
# stage 1's support plan: the smallest subnormal of the dtype the kernel
# computes in (1.4e-45 is the JAX package's float32 constant), the host
# limits of the closed form held at once, and the card's limits per
# source tensor held at once
_SUBNORMAL = {'float32': 1.4e-45, 'float64': 4.9e-324}
_KLIM_HOST_SLOTS = 64
_KLIM_HOST = collections.OrderedDict()
_KLIM_SLOTS = 16
_KLIMS = collections.OrderedDict()


def kernel_length(n_up):
    """True where the CWT kernel's DFT engines take the padded length:
    n_up >= 4 with no prime factor above 7 (the JAX package's kernel gate
    `cwt_pallas_applicable` likewise looks at n_up). The entry points
    decide their route by it before the signal's FFT: another n_up runs
    the general path (`models/cwt.py::cwt_general`, and for order 2
    `models/ssq_cwt2.py::wsst2_general`), as the JAX package's XLA
    branch runs it."""
    n_up = int(n_up)
    r = n_up
    for p in (2, 3, 5, 7):
        while r and r % p == 0:
            r //= p
    return n_up >= 4 and r == 1


@functools.lru_cache(maxsize=256)
def four_step(n_up):
    """(f1, f2) with n_up = f1 * f2, f1 >= f2: for a power of two both
    powers of two, f1 = 2^ceil(lg n_up / 2) (the radix-4 engine); for any
    other n_up >= 4 whose prime factors are at most 7, the split whose
    larger factor is smallest, as `ssqueezepy_tpu/ops/fft.py::_factorize`
    splits (the mixed engine; 160000 = 400 x 400, 99225 = 315 x 315).
    Any other length raises (`kernel_length`): this is the CWT kernel's
    one length rule."""
    n_up = int(n_up)
    if not kernel_length(n_up):
        raise NotImplementedError(
            "the CWT kernel takes a padded length n_up >= 4 whose prime "
            "factors are at most 7 (got %d); the public entry points route "
            "other lengths to the general path (torch.fft, then the "
            "reassignment kernels)" % n_up)
    lg = n_up.bit_length() - 1
    if (1 << lg) == n_up:
        f1 = 1 << ((lg + 1) // 2)
    else:
        f1 = next(d for d in range(math.isqrt(n_up - 1) + 1, n_up + 1)
                  if n_up % d == 0)
    return f1, n_up // f1


def smem_bytes(engine, L, planes, P, stride, itemsize):
    """Dynamic shared bytes of one stage (csrc/cwt_bins.cu::smem_bytes):
    the radix-4 engine's L/2 twiddles and one buffer of planes * P
    sequences `stride` elements apart, the mixed engine's L twiddles and
    two such buffers."""
    if engine == _ENGINE_RADIX4:
        return (L // 2 + planes * P * stride) * itemsize
    return (L + 2 * planes * P * stride) * itemsize


def _columns(engine, L, other, itemsize, planes, stride):
    """Columns per block P, a power of two <= `_MAX_COLUMNS`, halved until
    the stage fits the shared-memory budget; one column may take up to
    `_SMEM_MAX`, and None where not even one fits. Radix 4: P divides
    `other`. Mixed: P starts at the least power of two covering `other`
    (the kernel guards the last block's columns, so P need not divide
    it)."""
    P = min(_MAX_COLUMNS, other if engine == _ENGINE_RADIX4
            else 1 << (other - 1).bit_length())
    size = lambda P: smem_bytes(engine, L, planes, P, stride, itemsize)
    while P > 1 and size(P) > _SMEM_BUDGET:
        P //= 2
    return P if size(P) <= _SMEM_MAX else None


def swz(r, b):
    """`r` with its low `b` bits reversed (an int or an integer array): a
    bijection on every aligned block of 2^b, the DFT engine's walk over
    positions (csrc/cwt_bins.cu::swz)."""
    out = (r >> b) << b
    for t in range(b):
        out = out | (((r >> t) & 1) << (b - 1 - t))
    return out


def smem_index(s, i, S):
    """Shared-memory element (after the twiddle table) of position `i` of
    sequence `s` in the DFT engine: s * S + i (csrc/cwt_bins.cu)."""
    return s * S + i


BinsPlan = collections.namedtuple(
    'BinsPlan', 'f1 f2 P1 P2 S1 S2 sw1 sw2 smem1 smem2 engine')


@functools.lru_cache(maxsize=256)
def bins_plan(n_up, itemsize, planes):
    """Launch plan of the DFT engine for `planes` planes (1: Wx; 2: bins
    mode or Wx and dWx; 5: order 2): the engine (radix 4 for a power-of-two
    n_up, else mixed), per stage the columns per block P (`_columns`), the
    sequence stride S (L + 1 for an even L, L for an odd one: odd, so
    sequences at one position fall on distinct bank pairs), the swizzle
    width sw (the low bits reversed when a half-warp walks P columns by
    positions: log2 of the elements one wavefront serves, at most the
    power of two in L, which keeps the walk a bijection on [0, L)) and the
    dynamic shared bytes."""
    f1, f2 = four_step(n_up)
    engine = _ENGINE_RADIX4 if n_up & (n_up - 1) == 0 else _ENGINE_MIXED
    wave = (_WAVEFRONT // itemsize).bit_length() - 1

    def stage(L, other):
        S = L | 1
        P = _columns(engine, L, other, itemsize, planes, S)
        if P is None:
            not_ported("the CUDA CWT kernel at n_up=%d, %d plane(s) of "
                       "%d-byte elements (its DFT factor %d exceeds one "
                       "block's shared memory)" % (n_up, planes, itemsize,
                                                   L), 'C1b')
        return (P, S, min(wave, (L & -L).bit_length() - 1),
                smem_bytes(engine, L, planes, P, S, itemsize))

    (P1, S1, sw1, sm1), (P2, S2, sw2, sm2) = stage(f1, f2), stage(f2, f1)
    return BinsPlan(f1, f2, P1, P2, S1, S2, sw1, sw2, sm1, sm2, engine)


def cwt_length_rule(n_up, itemsize, planes):
    """The CWT kernel's one rule on the padded length, checked on every
    device before the signal's FFT and by each wrapper: n_up >= 4 with
    no prime factor above 7 (`kernel_length`; `four_step` raises on
    another, which the public entry points route to the general path
    before they reach this rule), whose plan for `planes` planes (1: Wx; 2: bins mode, or Wx and dWx;
    5: order 2) of complex elements of `itemsize` bytes fits one block's
    shared memory (`bins_plan`; beyond it raises naming C1b). On the
    radix-4 engine that takes n_up up to 2^28, 2^26 and 2^24 for 1, 2
    and 5 planes in complex64, 2^26, 2^24 and 2^22 in complex128.
    Returns the plan."""
    return bins_plan(int(n_up), int(itemsize), int(planes))


def _wavelet_derivatives(fn, w):
    """(psih, psih', psih'') of the elementwise wavelet fn at `w`: the
    closed form `fn.derivatives` where the fn has one, else torch autograd
    of the sum (the derivative of an elementwise map is the gradient of
    its sum), as the JAX package takes `jax.grad` of it."""
    derivatives = getattr(fn, 'derivatives', None)
    if derivatives is not None:
        return fn(w, xp=torch), *derivatives(w)
    wg = w.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        psih = fn(wg, xp=torch)
        d1, = torch.autograd.grad(psih.sum(), wg, create_graph=True,
                                  allow_unused=True)
        if d1 is None:
            d1 = torch.zeros_like(w)
        d2 = None
        if d1.requires_grad:
            d2, = torch.autograd.grad(d1.sum(), wg, allow_unused=True)
        if d2 is None:
            d2 = torch.zeros_like(w)
    return psih.detach(), d1.detach(), d2.detach()


def wavelet_table(wavelet, scales, n_up, order2=False, memo=False):
    """The CWT kernel's wavelet table: psih(a xi) on the half grid
    xi_m = 2 pi m / n_up, m <= n_up // 2, for each scale a of `scales`
    ((na,) real, on its device): (na, n_up//2 + 1) in the scales' dtype,
    and for `order2` (3, na, n_up//2 + 1), psih, psih' and psih''. No row
    norm and no Nyquist halving: the kernel and the plain versions apply
    both. With `memo` (the kernel's launches) memoized per (wavelet,
    scales tensor, n_up, order2), `_TABLE_SLOTS` at once, for a named
    wavelet; a user's callable, and every call of a plain version, is
    evaluated anew."""
    from ..models.cwt import _is_custom, _wavelet_key
    key = None
    if memo and not _is_custom(wavelet):
        key = (_wavelet_key(wavelet), id(scales), scales._version,
               int(n_up), bool(order2))
        hit = _TABLES.get(key)
        if hit is not None and hit[0] is scales:
            _TABLES.move_to_end(key)
            return hit[1]
    half = n_up // 2 + 1
    xi = torch.as_tensor(_xifn(1., n_up)[:half], dtype=scales.dtype,
                         device=scales.device)
    w = scales.reshape(-1, 1) * xi
    if order2:
        table = torch.stack(_wavelet_derivatives(wavelet.fn, w))
    else:
        table = wavelet.fn(w, xp=torch)
    if isinstance(table, tuple) or table.is_complex():
        raise TypeError("the CWT kernel's wavelet table takes a real-valued "
                        "wavelet (got %s)" % wavelet.name)
    table = table.to(scales.dtype).contiguous()
    if key is not None:
        _TABLES[key] = (scales, table)
        while len(_TABLES) > _TABLE_SLOTS:
            _TABLES.popitem(last=False)
    return table


def stage1_rows(n_up):
    """Rows stage 1 of the CWT kernel contracts over unpruned: the f2-wide
    blocks m1 of the half spectrum m = m1 f2 + m2 <= n_up/2 (`four_step`),
    ceil((n_up//2 + 1) / f2); f1/2 + 1 on the radix-4 engine, the last
    holding the Nyquist bin alone."""
    return -(-(int(n_up) // 2 + 1) // four_step(n_up)[1])


def _memo_put(memo, key, value, slots):
    memo[key] = value
    while len(memo) > slots:
        memo.popitem(last=False)


def support_klims(wavelet, scales, n_up, dtype='float32', order2=False):
    """The support plan of stage 1 for a wavelet the kernel synthesizes
    (the JAX package's `ops/cwt_pallas.py::support_klims`, on this
    kernel's split `four_step`): per scale, the count of leading rows
    (`stage1_rows`' f2-wide blocks m1) where psih(a xi) can be nonzero in
    `dtype`. psih is sampled in float64 numpy (`wavelet.fn(w, xp=np)`) at
    row boundaries and midpoints, floor(k f2 / 2) (the JAX package's
    k (f2 // 2) for an even f2, and still each row's start and middle for
    an odd one, down to f2 = 1); a row counts up to the last sample above
    the smallest subnormal of `dtype` (1.4e-45 for float32, 4.9e-324 for
    float64), plus one row of margin, row 0 always, capped at
    `stage1_rows`; `order2` adds one row for the derivative banks (as the
    JAX package's `models/ssq_cwt2.py` does). Beyond it psih is exactly 0
    in `dtype` (tests/test_torch_cwt_prune.py). (na,) int32 numpy,
    memoized per (wavelet, scales, n_up, dtype, order2) for this
    package's wavelets; read-only."""
    from ..models.cwt import _is_custom, _wavelet_key
    scales = np.asarray(scales, np.float64).reshape(-1)
    n_up, dtype, order2 = int(n_up), str(dtype), bool(order2)
    key = None
    if not _is_custom(wavelet):
        key = (_wavelet_key(wavelet), scales.tobytes(), n_up, dtype, order2)
        hit = _KLIM_HOST.get(key)
        if hit is not None:
            _KLIM_HOST.move_to_end(key)
            return hit
    f2 = four_step(n_up)[1]
    half = n_up // 2 + 1
    rows0 = stage1_rows(n_up)
    samp = np.minimum(np.arange(2 * rows0 + 1) * f2 // 2, half - 1)
    psis = np.abs(np.asarray(wavelet.fn(scales[:, None]
                                        * _xifn(1., n_up)[samp], xp=np),
                             np.float64))
    need = psis > _SUBNORMAL[dtype]
    last = need.shape[1] - 1 - need[:, ::-1].argmax(axis=1)
    klim = np.clip(np.where(need.any(axis=1), last // 2 + 2, 1), 1, rows0)
    klim = np.minimum(klim + order2, rows0).astype(np.int32)
    klim.setflags(write=False)                # shared by every caller
    if key is not None:
        _memo_put(_KLIM_HOST, key, klim, _KLIM_HOST_SLOTS)
    return klim


def table_klims(table, n_up):
    """The support plan of stage 1 for a wavelet read from its table
    (`wavelet_table`: (na, n_up//2 + 1), or (3, na, n_up//2 + 1) for
    order 2, the maximum over the planes): per scale, the row m1 holding
    the last nonzero entry, plus one (1 for a row of zeros). Exact: every
    entry beyond it is 0. (na,) int32 on the table's device, computed
    there with no host read."""
    f2 = four_step(n_up)[1]
    nz = table != 0
    full = nz.shape[-1] // f2 * f2
    rows = [nz[..., :full].unflatten(-1, (-1, f2)).any(-1)]
    if full < nz.shape[-1]:
        rows.append(nz[..., full:].any(-1, keepdim=True))
    rows = torch.cat(rows, -1)
    if rows.dim() == 3:
        rows = rows.any(0)
    idx = torch.arange(1, rows.shape[-1] + 1, dtype=torch.int32,
                       device=table.device)
    return torch.where(rows, idx, 0).amax(-1).clamp_min(1).to(torch.int32)


def _stage1_klims(wavelet, scales, n_up, order2, table):
    """The (na,) int32 row limits stage 1 reads on the card: from `table`
    (`table_klims`) where the wavelet comes from one, else the closed
    form's support plan (`support_klims` in the scales' dtype, whose
    scales are read to the host once per scales tensor). Memoized per
    source tensor and version (`_KLIM_SLOTS` at once; a table by a weak
    reference, the scales by a strong one, which keeps their storage and
    so their address unique), so a call that hits costs no host-device
    sync."""
    if table is not None:
        key = ('table', id(table), table._version, int(n_up))
        hit = _KLIMS.get(key)
        if hit is not None and hit[0]() is table:
            _KLIMS.move_to_end(key)
            return hit[1]
        value = (weakref.ref(table), table_klims(table, n_up))
    else:
        kp = tuple(sorted(wavelet.fn.kernel_params.items()))
        key = ('gmw', scales.data_ptr(), scales.shape[0], scales.stride(0),
               scales.dtype, str(scales.device), scales._version, int(n_up),
               bool(order2), kp)
        hit = _KLIMS.get(key)
        if hit is not None:
            _KLIMS.move_to_end(key)
            return hit[1]
        host = support_klims(wavelet, scales.detach().cpu().numpy(), n_up,
                             str(scales.dtype).split('.')[-1], order2)
        value = (scales, torch.tensor(host, device=scales.device))
    _memo_put(_KLIMS, key, value, _KLIM_SLOTS)
    return value[1]


def _halve_nyquist(xh, n_up):
    """xh with its Nyquist bin halved (even n_up), as a new tensor: the
    plain versions halve the spectrum where the kernel does, which equals
    halving the wavelet bit for bit (a power-of-two scaling)."""
    if n_up % 2:
        return xh
    xh = xh.clone()
    xh[..., n_up // 2] /= 2
    return xh


def _bin_args(params):
    mode = params['mode']
    if mode == 'lin':
        return params['vmin'], params['dv'], 0., 1., 0
    if mode == 'log':
        return params['vlmin'], params['dvl'], 0., 1., 0
    return (params['vlmin0'], params['dvl0'], params['vlmin1'],
            params['dvl1'], params['idx1'])


def _check(xh, scales, n_up, n1, N, planes, batched=False, table=None):
    if (xh.dim() not in ((1, 2) if batched else (1,))
            or xh.shape[-1] != n_up // 2 + 1):
        raise ValueError("xh must be the (n_up//2 + 1,) half spectrum%s "
                         "(got %s)" % (" or a (B, n_up//2 + 1) batch"
                                       if batched else "",
                                       tuple(xh.shape)))
    if not (n1 >= 0 and N >= 1 and n1 + N <= n_up):
        raise ValueError("output span [n1, n1+N) = [%d, %d) must lie in "
                         "[0, n_up=%d)" % (n1, n1 + N, n_up))
    if scales.dim() != 1:
        raise ValueError("scales must be 1-D (na,)")
    if xh.device != scales.device:
        raise ValueError("xh and scales must be on one device")
    cdt = {torch.float32: torch.complex64,
           torch.float64: torch.complex128}.get(scales.dtype)
    if cdt is None or xh.dtype != cdt:
        raise TypeError("dtypes: scales float32/float64 with xh of the "
                        "matching complex type (got %s, %s)"
                        % (scales.dtype, xh.dtype))
    if not (xh.is_contiguous() and scales.is_contiguous()):
        raise ValueError("xh and scales must be contiguous")
    if table is not None:
        shape = ((3,) if planes == 5 else ()) + (scales.shape[0],
                                                n_up // 2 + 1)
        if (tuple(table.shape) != shape or table.dtype != scales.dtype
                or table.device != scales.device
                or not table.is_contiguous()):
            raise ValueError("table must be the contiguous %s wavelet table "
                             "of the scales' dtype and device (got %s %s)"
                             % (shape, tuple(table.shape), table.dtype))
    # the one length rule, every device
    cwt_length_rule(n_up, xh.element_size(), planes)


def cwt_bins_plain(xh, scales, wavelet, n_up, n1, N, dt, l1_norm, params,
                   gamma, flipud, table=None):
    """Plain version: `cwt_core` (torch.fft.ifft) for Wx and dWx, then
    `phase_transform_w` and `compute_bins`; one spectrum or a batch."""
    from ..models.cwt import cwt_core
    from .phase import phase_transform_w
    from .ssq_kernels import compute_bins
    Wx, dWx = cwt_core(xh, wavelet, scales, n_up, n1, N, dt, True, l1_norm,
                       table)
    w = phase_transform_w(Wx, dWx, gamma)
    k, valid = compute_bins(w, params, flipud)
    return Wx.contiguous(), torch.where(valid, k, torch.full_like(k, -1))


def cwt_bins(xh, scales, wavelet, n_up, n1, N, dt, l1_norm, params, gamma,
             flipud, table=None):
    """(Wx, k) of the synchrosqueezed CWT from the half spectrum `xh` of
    the padded signal, (n_up//2 + 1,) or a (B, n_up//2 + 1) batch; Wx
    and k are (na, N) or (B, na, N). `scales` (na,) real, `wavelet` a
    real-valued `Wavelet`, `params` from `ssq_bin_params`; output columns
    are [n1, n1+N) of the padded transform. `table`, where given, is the
    caller's `wavelet_table` of `scales` (a streaming plan holds its own),
    read in place of the memo's; the order-0 GMW is synthesized anyway."""
    _check(xh, scales, n_up, n1, N, _PLANES[_OUT_BINS], batched=True,
           table=table)

    def run(xh, scales):
        if xh.device.type == 'cpu':
            return cwt_bins_plain(xh, scales, wavelet, n_up, n1, N, dt,
                                  l1_norm, params, gamma, flipud, table)
        if xh.device.type != 'cuda':
            raise RuntimeError("cwt_bins runs on CUDA or CPU tensors (got "
                               "%s)" % xh.device)
        return _launch(cwt_bins, _OUT_BINS, xh, scales, wavelet, n_up, n1,
                       N, dt, l1_norm, params, gamma, flipud, table=table)

    if not needs_grad(xh, scales):
        return run(xh, scales)

    def vjp(xh, scales):
        return _wx_plain(xh, scales, wavelet, n_up, n1, N, dt, l1_norm,
                         table), None
    return CwtBinsGrad.apply(run, vjp, xh, scales)


class CwtBinsGrad(Adjoint):
    """`cwt_bins` (B1, B3b) under autograd: (Wx, k), k carrying no
    gradient. Backward: the gradient of the Wx-only plain CWT
    (`cwt_fused_plain(derivative=False)`) in Wx's cotangent, with respect
    to xh and the scales; the phase transform and the bins are never
    recomputed (JAX: `_cwt_fused_bins_vjp_fn`,
    `_cwt_fused_bins_direct_vjp_fn`)."""


def _wx_plain(xh, scales, wavelet, n_up, n1, N, dt, l1_norm, table):
    """Wx alone, by the plain version of the plain mode (B3, one plane):
    the formulation the bins and order-2 modes differentiate."""
    return cwt_fused_plain(xh, scales, wavelet, n_up, n1, N, dt, False,
                           l1_norm, table)[0]


_COUNTERS = ('launches', 'mixed_launches', 'batched_launches',
             'mixed_batched_launches')


def _zero_counters(wrapper, names=_COUNTERS):
    for name in names:
        setattr(wrapper, name, 0)
        setattr(wrapper, 'table_' + name, 0)


_zero_counters(cwt_bins)


def _outputs(out_mode, xh, scales, N):
    """The kernel's outputs for `out_mode`, (B *) na x N: Wx (W) of xh's
    type, and k (int32, bins modes), dWx (derivative mode), w2 (real,
    w2 mode) or None (Wx only)."""
    shape = xh.shape[:-1] + (scales.shape[0], N)
    Wx = torch.empty(shape, dtype=xh.dtype, device=xh.device)
    if out_mode in (_OUT_BINS, _OUT_BINS2):
        return Wx, torch.empty(shape, dtype=torch.int32, device=xh.device)
    if out_mode == _OUT_W_DW:
        return Wx, torch.empty_like(Wx)
    if out_mode == _OUT_W2:
        return Wx, torch.empty(shape, dtype=scales.dtype, device=xh.device)
    return Wx, None


def _launch(wrapper, out_mode, xh, scales, wavelet, n_up, n1, N, dt,
            l1_norm, params=None, gamma=0., flipud=False, table=None,
            klims=None):
    """Run the two-launch kernel of `out_mode` over every row of its
    outputs (`_outputs`), chunking rows to the scratch budget; returns
    (Wx, out2). Counts each C call on the wrapper's attribute `launches`
    (`batched_launches` for a batch, where the wrapper has one), prefixed
    `mixed_` on the mixed engine and `table_` where the wavelet comes from
    its table (every wavelet but the order-0 GMW, which the kernel
    synthesizes): the caller's `table`, else the memo's. Stage 1 reads
    each row's support limit (`_stage1_klims`). `klims` is a private hook
    that replaces those limits by an (na,) int32 tensor on the card, for
    holding pruned against unpruned stage 1 in one run (`chip_smoke.py`,
    `tests/test_torch_cuda.py`, `scripts/torch_cwt_digest.py`):
    `stage1_rows(n_up)` in every row runs stage 1 unpruned."""
    planes = _PLANES[out_mode]
    kp = getattr(wavelet.fn, 'kernel_params', None)
    if kp is None:
        if table is None:
            table = wavelet_table(wavelet, scales, n_up, order2=planes == 5,
                                  memo=True)
        kp = dict(logconst=0., amp=0., gamma=1., beta=0., wc=1.)
    else:
        table = None
    na = scales.shape[0]
    if klims is None:
        klims = _stage1_klims(wavelet, scales, n_up, planes == 5, table)
    elif (tuple(klims.shape) != (na,) or klims.dtype != torch.int32
          or klims.device != xh.device or not klims.is_contiguous()):
        raise ValueError("klims must be a contiguous (%d,) int32 tensor on "
                         "%s" % (na, xh.device))
    Wx, out2 = _outputs(out_mode, xh, scales, N)
    lib = _build.load('cwt_bins')
    f32 = scales.dtype == torch.float32
    itemsize = xh.element_size()
    bp = bins_plan(n_up, itemsize, planes)
    f1, f2 = bp.f1, bp.f2
    counter = ('batched_launches' if xh.dim() == 2
               and hasattr(wrapper, 'batched_launches') else 'launches')
    if bp.engine == _ENGINE_MIXED:
        counter = 'mixed_' + counter
    if table is not None:
        counter = 'table_' + counter
    n_all = Wx.numel() // N
    dev = xh.device
    rows = max(1, min(n_all, _MAX_GRID_Y,
                      _SCRATCH_BUDGET // (planes * n_up * itemsize)))
    scratch = torch.empty((planes, rows, n_up), dtype=xh.dtype, device=dev)
    if params is None:
        mode, idx1, omax, bin_args = 0, 0, 0, (0., 1., 0., 1.)
    else:
        a0, d0, a1, d1, idx1 = _bin_args(params)
        mode, omax, bin_args = _MODES[params['mode']], params['omax'], \
            (a0, d0, a1, d1)
    dp = (ctypes.c_double * 14)(
        2 * math.pi / n_up, 1.0 / dt, gamma, kp['logconst'], kp['amp'],
        kp['gamma'], kp['beta'], kp['wc'], *bin_args, div_tiny(xh.dtype),
        _TWO_PI * dt)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn = lib.cwt_bins_f32 if f32 else lib.cwt_bins_f64
    for row0 in range(0, n_all, rows):
        nr = min(rows, n_all - row0)
        # ip: n_up, f1, f2, lg1, lg2, half, n1, N, P1, P2, rows, row0,
        # l1_norm, bin mode, idx1, omax, flipud, out_mode, na, S1, S2, sw1,
        # sw2, engine
        ip = (ctypes.c_int * 24)(
            n_up, f1, f2, f1.bit_length() - 1, f2.bit_length() - 1,
            n_up // 2 + 1, n1, N, bp.P1, bp.P2, nr, row0,
            int(bool(l1_norm)), mode, int(idx1), int(omax),
            int(bool(flipud)), out_mode, na, bp.S1, bp.S2, bp.sw1, bp.sw2,
            bp.engine)
        err = fn(xh.data_ptr(), scales.data_ptr(),
                 None if table is None else table.data_ptr(),
                 klims.data_ptr(), ip, dp, scratch.data_ptr(),
                 Wx.data_ptr(), None if out2 is None else out2.data_ptr(),
                 stream)
        _build.check(err, wrapper.__name__)
        setattr(wrapper, counter, getattr(wrapper, counter) + 1)
    return Wx, out2


def cwt_fused_plain(xh, scales, wavelet, n_up, n1, N, dt, derivative,
                    l1_norm, table=None):
    """Plain version: `cwt_core` (torch.fft.ifft)."""
    from ..models.cwt import cwt_core
    Wx, dWx = cwt_core(xh, wavelet, scales, n_up, n1, N, dt, derivative,
                       l1_norm, table)
    return Wx.contiguous(), (None if dWx is None else dWx.contiguous())


def cwt_fused(xh, scales, wavelet, n_up, n1, N, dt, derivative, l1_norm,
              table=None):
    """(Wx, dWx or None) of the CWT from the half spectrum `xh` of the
    padded signal, (n_up//2 + 1,) or a (B, n_up//2 + 1) batch; Wx and
    dWx are (na, N) or (B, na, N). `scales` (na,) real, `wavelet` a
    real-valued `Wavelet`; output columns are [n1, n1+N) of the padded
    transform;
    `l1_norm=False` multiplies rows by sqrt(scale). `table` as `cwt_bins`
    takes it."""
    _check(xh, scales, n_up, n1, N,
           _PLANES[_OUT_W_DW if derivative else _OUT_W], batched=True,
           table=table)

    def plain(xh, scales):
        return cwt_fused_plain(xh, scales, wavelet, n_up, n1, N, dt,
                               derivative, l1_norm, table)

    def run(xh, scales):
        if xh.device.type == 'cpu':
            return plain(xh, scales)
        if xh.device.type != 'cuda':
            raise RuntimeError("cwt_fused runs on CUDA or CPU tensors (got "
                               "%s)" % xh.device)
        return _launch(cwt_fused, _OUT_W_DW if derivative else _OUT_W, xh,
                       scales, wavelet, n_up, n1, N, dt, l1_norm,
                       table=table)

    if not needs_grad(xh, scales):
        return run(xh, scales)
    return CwtFusedGrad.apply(run, plain, xh, scales)


class CwtFusedGrad(Adjoint):
    """`cwt_fused` (B3) under autograd: (Wx, dWx or None). Backward: the
    gradient of `cwt_fused_plain` (Wx, or Wx and dWx) with respect to xh
    and the scales (JAX: `_cwt_fused_vjp_fn`)."""


_zero_counters(cwt_fused, _COUNTERS[:2])


def wsst2_rows(xh, scales, wavelet, n_up, n1, N, dt, gamma, table=None):
    """(W, w2) of the second-order CWT, step by step with torch.fft (the
    XLA twin `_wsst2_rows` of `ssqueezepy_tpu/models/ssq_cwt2.py`), for
    one half spectrum xh or a (B, n_up//2 + 1) batch: the
    five banks W = psih xh, A = i xi psih xh, B = i a psih' xh,
    Bd = -xi a psih' xh, C = -a^2 psih'' xh on the half spectrum (Nyquist
    bin halved in all five), one inverse FFT kept to [n1, n1+N), then
    p2 = (Bd W - A B) / (B^2 - C W), p1 = (A + p2 B) / W (regularized
    divides) and w2 = |Im p1| / (2 pi dt), inf where not finite or where
    |W|^2 <= gamma^2. `table`, where given, is the (3, na, n_up//2 + 1)
    `wavelet_table` of `scales`."""
    half = n_up // 2 + 1
    xi = torch.as_tensor(_xifn(1., n_up)[:half], dtype=scales.dtype,
                         device=scales.device)
    a = scales.reshape(-1, 1)
    psih, d1, d2 = (wavelet_table(wavelet, scales, n_up, order2=True)
                    if table is None else table)
    xh = _halve_nyquist(xh, n_up)                   # in all five banks
    tb, t2b = a * d1, (a * a) * d2
    xr, xim = xh.real[..., None, :], xh.imag[..., None, :]
    re = torch.stack([psih * xr, -xi * (psih * xim), -(tb * xim),
                      -xi * (tb * xr), -(t2b * xr)], dim=-3)
    im = torch.stack([psih * xim, xi * (psih * xr), tb * xr,
                      -xi * (tb * xim), -(t2b * xim)], dim=-3)
    W, A, B, Bd, C = ifft(torch.complex(re, im), n=n_up,
                          out_range=(n1, n1 + N)).unbind(-3)
    tiny = div_tiny(xh.dtype)
    p2 = cdiv(cmul(Bd, W) - cmul(A, B), cmul(B, B) - cmul(C, W), tiny)
    p1 = cdiv(A + cmul(p2, B), W, tiny)
    w2 = p1.imag.abs() / (_TWO_PI * dt)
    inf = torch.full_like(w2, float('inf'))
    w2 = torch.where(torch.isfinite(w2), w2, inf)
    big = W.real * W.real + W.imag * W.imag > \
        torch.tensor(gamma, dtype=w2.dtype) ** 2
    return W.contiguous(), torch.where(big, w2, inf)


def cwt_bins2_plain(xh, scales, wavelet, n_up, n1, N, dt, params, gamma,
                    flipud, table=None):
    """Plain version: `wsst2_rows`, then `compute_bins` on w2."""
    from .ssq_kernels import compute_bins
    W, w2 = wsst2_rows(xh, scales, wavelet, n_up, n1, N, dt, gamma, table)
    k, valid = compute_bins(w2, params, flipud)
    return W, torch.where(valid, k, torch.full_like(k, -1))


def cwt_bins2(xh, scales, wavelet, n_up, n1, N, dt, params, gamma, flipud,
              table=None):
    """(W, k) of the second-order synchrosqueezed CWT (WSST2) from the
    half spectrum `xh` of the padded signal, (n_up//2 + 1,) or a
    (B, n_up//2 + 1) batch: W (na, N) or (B, na, N) the L1 CWT, k of W's
    shape int32 the bin of the chirp-corrected frequency w2, -1 on
    gamma-gated or non-finite cells. Arguments as `cwt_bins`; `table` the
    three-plane one (`wavelet_table(..., order2=True)`)."""
    _check(xh, scales, n_up, n1, N, _PLANES[_OUT_BINS2], batched=True,
           table=table)

    def run(xh, scales):
        if xh.device.type == 'cpu':
            return cwt_bins2_plain(xh, scales, wavelet, n_up, n1, N, dt,
                                   params, gamma, flipud, table)
        if xh.device.type != 'cuda':
            raise RuntimeError("cwt_bins2 runs on CUDA or CPU tensors (got "
                               "%s)" % xh.device)
        return _launch(cwt_bins2, _OUT_BINS2, xh, scales, wavelet, n_up, n1,
                       N, dt, True, params, gamma, flipud, table=table)

    if not needs_grad(xh, scales):
        return run(xh, scales)

    def vjp(xh, scales):
        return _wx_plain(xh, scales, wavelet, n_up, n1, N, dt, True,
                         None if table is None else table[0]), None
    return CwtBins2Grad.apply(run, vjp, xh, scales)


class CwtBins2Grad(Adjoint):
    """`cwt_bins2` (B8) under autograd: (W, k), k carrying no gradient.
    Backward: the gradient of the W-only plain CWT (L1,
    `cwt_fused_plain(derivative=False)`, the first plane of `wsst2_rows`)
    in W's cotangent, with respect to xh and the scales; the four
    auxiliary transforms and the bins are never recomputed (JAX:
    `_cwt_fused_bins2_direct_vjp_fn`)."""


_zero_counters(cwt_bins2)


def cwt_w2(xh, scales, wavelet, n_up, n1, N, dt, gamma):
    """(W, w2) of the second-order CWT (WSST2) from the half spectrum `xh`
    of the padded signal, (n_up//2 + 1,) or a (B, n_up//2 + 1) batch: W
    (na, N) or (B, na, N) the L1 CWT, w2 of W's shape and real type the
    chirp-corrected frequency |Im p1| / (2 pi dt), inf where not finite
    or where |W|^2 <= gamma^2 (the plane whose bins `cwt_bins2` returns:
    B8's w2 output mode). Plain version: `wsst2_rows`."""
    _check(xh, scales, n_up, n1, N, _PLANES[_OUT_W2], batched=True)

    def plain(xh, scales):
        return wsst2_rows(xh, scales, wavelet, n_up, n1, N, dt, gamma)

    def run(xh, scales):
        if xh.device.type == 'cpu':
            return plain(xh, scales)
        if xh.device.type != 'cuda':
            raise RuntimeError("cwt_w2 runs on CUDA or CPU tensors (got %s)"
                               % xh.device)
        return _launch(cwt_w2, _OUT_W2, xh, scales, wavelet, n_up, n1, N,
                       dt, True, gamma=gamma)

    if not needs_grad(xh, scales):
        return run(xh, scales)
    return CwtW2Grad.apply(run, plain, xh, scales)


class CwtW2Grad(Adjoint):
    """`cwt_w2` (B8's w2 mode) under autograd: (W, w2). Backward: the
    gradient of `wsst2_rows` in both outputs (the JAX package's `get_w`
    differentiates its XLA twin `_wsst2_rows`)."""


_zero_counters(cwt_w2)
