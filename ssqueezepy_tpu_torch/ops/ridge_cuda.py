# -*- coding: utf-8 -*-
"""The ridge dynamic program, `csrc/ridge_dp.cu`, and its plain PyTorch
versions.

The port's counterpart of the JAX package's XLA program
`ssqueezepy_tpu/models/ridge_extraction.py::_fw_bw_jit` (no Pallas
kernel): over the penalized energy e (B, T, F), time-major, and the
penalty matrix P[f, g] = penalty * (v_f - v_g)^2 of the row coordinates v
(F,),

  * `ridge_forward`: pe[:, 0] = e[:, 0], then
    pe[:, t, f] = e[:, t, f] + min_g (pe[:, t-1, g] + P[f, g]);
  * `ridge_trace`: r[T-1] = argmin_f pe[T-1]; for t = T-2 .. 0 the last f
    with |val - (pe[t, f] + P[r[t+1], f])| < eps, val = pe[t+1, r[t+1]] -
    e[t+1, r[t+1]], else argmin_f pe[t] (first occurrence).

Each wrapper launches its kernel for CUDA tensors (one launch for the
whole batch) and runs its plain version, a loop over t that mirrors
`_fw_bw_jit` step by step, for CPU tensors; on the card the plain
versions are the kernels' oracle. `ridge_plan` decides each launch on
the host, before it: where `ridge_resident` admits F (whole rows of F in
one block's shared memory: F <= 11264 in float32, 5632 in float64) the
resident mode (the forward on one thread-block cluster per batch row,
the trace on one block with rings of rows; cluster size, rows per CTA, P
in registers or recomputed, the rings, shared bytes), past it the
row-tiled mode, whose shared bytes do not grow with F, so any F that
device memory holds: the forward one cooperative launch over the whole
card, each CTA owning tiles of 64 rows and skipping, by an exact bound,
the tiles of g that cannot hold a row's minimum; the trace a prologue
over all columns at once (each column's tile minima and first argmin)
and a walk of one warp per batch row that scans only the tiles that can
hold a qualifying f (`_trace_records`, `_trace_walk`, which only
`ridge_trace` calls with its checked inputs). `ridge_forward.launches`
and `ridge_trace.launches` count the resident mode's launches,
`.tiled_launches` the tiled mode's (the forward, the walk) and
`ridge_trace.prologue_launches` the prologue's. Design and bound are
noted in the source.
"""
from collections import namedtuple

import torch

from . import _build
from .ssq_cuda import _on_card

__all__ = ['ridge_forward', 'ridge_forward_plain', 'ridge_trace',
           'ridge_trace_plain', 'ridge_penalty', 'ridge_resident',
           'ridge_plan']

# shared bytes a block may take (the card's limit is 227 KB)
_SMEM_MAX = 220 * 1024


def ridge_resident(F, itemsize):
    """Whether the ridge kernels take rows of F elements of `itemsize`
    bytes in their resident mode: v and two pe rows (padded to a multiple
    of 4) and v with two rows each of pe and e fit one block's shared
    memory: F <= 11264 in float32, 5632 in float64. Past it `ridge_plan`
    takes the row-tiled mode, on every device's plan alike."""
    return max(3 * ((F + 3) & ~3), 5 * F) * itemsize <= _SMEM_MAX


# the forward's cluster size (8, portable: measured against 16 in
# `chip_smoke.py` 12f, PERF.md §6), its columns of e in flight and
# 16-byte pieces of P per lane in registers (csrc/ridge_dp.cu kERing,
# kQuads)
_CLUSTER = 8
_E_RING = 4
_P_QUADS = 3
# the tiled mode (csrc/ridge_dp.cu kTile, kTileWarps, kWalkTiles,
# kWalkSlot, kWalkRing): the forward's tiles of rows and of g, its warps
# per CTA; the trace's least tile width (the plan's), most tiles per row,
# elements per ring slot and ring depth
_TILE = 64
_TILE_WARPS = 8
_WALK_TILE = 256
_WALK_TILES = 512
_WALK_SLOT = _WALK_TILES + 8
_WALK_RING = 8

RidgePlan = namedtuple('RidgePlan', [
    'clusters',       # C, CTAs per batch row (forward)
    'rows',           # R = ceil(F / C), rows per CTA
    'row_ranges',     # each CTA's [lo, hi) of f, empty for a spare CTA
    'resident',       # P of each warp's row pair kept in its registers
    'warps',          # warps per forward CTA (row pairs)
    'forward_smem',   # shared bytes per forward CTA
    'trace_rows',     # G, consecutive rows per slot of the trace's rings
    'trace_depth',    # slots of the trace's pe ring
    'trace_e_depth',  # slots of its e ring
    'trace_slot',     # bytes per slot (a 16-byte aligned superset)
    'trace_smem',     # shared bytes per trace block
    'tiled',          # the row-tiled mode: then `rows` (64) and
                      # `row_ranges` are the forward's tiles of rows (and
                      # of g), `warps` and `forward_smem` its CTA's,
                      # `clusters` None; `trace_rows` the f per trace
                      # tile, `trace_depth` the walk's ring slots,
                      # `trace_slot` the bytes of a step record,
                      # `trace_smem` the walk's shared bytes
    'tiles',          # the forward's tiles (tiled)
    'trace_tiles'])   # the trace's tiles (tiled)


def _pad4(n):
    return (n + 3) & ~3


def _up16(n):
    return (n + 15) // 16 * 16


def _span_slot(n, itemsize):
    """Bytes of a slot holding n elements from any offset: a 16-byte
    aligned superset (csrc/ridge_dp.cu span_slot)."""
    return _up16(n * itemsize) + 16


def ridge_plan(F, itemsize, clusters=None, tiled=None, batch=1):
    """The launch plan of both ridge kernels for rows of F elements of
    `itemsize` bytes over `batch` rows, decided on the host
    (csrc/ridge_dp.cu states the same layouts and its launchers check the
    shared bytes). The resident mode where `ridge_resident` admits F (or
    `tiled=False`), else (or `tiled=True`) the row-tiled mode:

      * resident forward: a cluster of C = min(`clusters` or 8, F) CTAs
        per batch row, CTA c on rows [c R, min(F, (c + 1) R)), R = ceil(F
        / C), ceil(R / 2) warps of a row pair each; shared memory v, three
        pe rows and a 4-column ring of e's R rows (padded to 4) and three
        mbarriers; P resident (each warp's two rows of P in its
        registers) where F <= 384 and R <= 48, else recomputed per use;
      * resident trace: rings of pe and e, each slot G consecutive rows
        (one bulk copy, a 16-byte aligned superset), G up to 16 (about 16
        KB a slot) and 2 to 4 slots of each beside v and two mbarriers
        per slot; where not even two slots of one row fit (the largest
        resident F), two slots of pe and one of e;
      * tiled forward: work items of 64 rows (`row_ranges`, also the
        tiles of g), B x ceil(F / 64) of them over the card's co-resident
        CTAs of 8 warps, 2 x 8 x 2 x 64 elements of pe and v and the
        warps' partial minima in static shared memory;
      * tiled trace: the prologue one block of 256 threads per (b, t),
        the walk one warp per batch row; tiles of G f, G = 256 or, past
        F = 131072, the least multiple of 32 that keeps them to 512; step
        records of ceil(F / G) + 3 elements padded to 16 bytes, a ring of
        8 of them in static shared memory beside the tiles' v ranges.

    A resident plan's shared bytes are at most `_SMEM_MAX`; a resident
    plan that cannot be built raises."""
    if tiled is None:
        tiled = not ridge_resident(F, itemsize)
    if tiled:
        nt = -(-F // _TILE)
        ranges = tuple((i * _TILE, min(F, (i + 1) * _TILE))
                       for i in range(nt))
        fw = (_TILE_WARPS * (2 * 2 + 1) * _TILE + 2 * _TILE_WARPS) * \
            itemsize + 4 * _TILE_WARPS + 4
        G = max(_WALK_TILE, 32 * -(-F // (32 * _WALK_TILES)))
        nt2 = -(-F // G)
        q = 16 // itemsize
        stride = -(-(nt2 + 3) // q) * q
        walk = (_WALK_RING * _WALK_SLOT + 2 * _WALK_TILES) * itemsize + \
            8 * _WALK_RING
        return RidgePlan(None, _TILE, ranges, False, _TILE_WARPS, fw, G,
                         _WALK_RING, 0, stride * itemsize, walk, True, nt,
                         nt2)
    C = min(clusters or _CLUSTER, F)
    if not 1 <= C <= 16:
        raise ValueError("a ridge cluster has 1 to 16 CTAs (got %d)" % C)
    R = -(-F // C)
    ranges = tuple((min(F, c * R), min(F, (c + 1) * R)) for c in range(C))
    Fp = _pad4(F)
    warps = min(32, -(-R // 2))
    resident = Fp <= 128 * _P_QUADS and warps <= 24
    fw = (4 * Fp + _E_RING * _pad4(R)) * itemsize + 24
    row = F * itemsize

    def trace_bytes(G, dp, de):
        return (dp + de) * _span_slot(G * F, itemsize) + _up16(row) + \
            16 * (dp + de)
    G, dp, de = 1, 2, 1  # the largest F: two slots of pe, one of e
    for g in range(min(16, max(1, 16384 // row)), 0, -1):
        d = max((d for d in range(2, 5) if trace_bytes(g, d, d) <=
                 _SMEM_MAX), default=0)
        if d:
            G, dp, de = g, d, d
            break
    if fw > _SMEM_MAX or trace_bytes(G, dp, de) > _SMEM_MAX:
        raise ValueError("no resident ridge plan fits %d B of shared memory "
                         "at F=%d, itemsize %d" % (_SMEM_MAX, F, itemsize))
    return RidgePlan(C, R, ranges, resident, warps, fw, G, dp, de,
                     _span_slot(G * F, itemsize), trace_bytes(G, dp, de),
                     False, 0, 0)


def ridge_penalty(v, penalty):
    """P (F, F) = penalty * ((v_f - v_g) * (v_f - v_g)) in v's type, the
    JAX package's `penalty * np.subtract.outer(v, v) ** 2` bit for bit."""
    d = v.reshape(-1, 1) - v.reshape(1, -1)
    return torch.as_tensor(penalty, dtype=v.dtype, device=v.device) * (d * d)


def _check(e, v, what):
    if e.dim() != 3 or v.shape != (e.shape[-1],):
        raise ValueError("%s takes e (B, T, F) and v (F,) (got %s, %s)"
                         % (what, tuple(e.shape), tuple(v.shape)))
    if e.dtype not in (torch.float32, torch.float64) or v.dtype != e.dtype:
        raise TypeError("e and v must be float32 or float64 of one type "
                        "(got %s, %s)" % (e.dtype, v.dtype))
    if e.device != v.device:
        raise ValueError("e and v must be on one device")
    if not (e.is_contiguous() and v.is_contiguous()):
        raise ValueError("e and v must be contiguous")


def ridge_forward_plain(e, v, penalty):
    """Plain version: `_fw_bw_jit`'s forward scan, one step per column."""
    P = ridge_penalty(v, penalty)
    pe = torch.empty_like(e)
    prev = pe[:, 0] = e[:, 0]
    for t in range(1, e.shape[1]):
        prev = pe[:, t] = e[:, t] + torch.amin(prev[:, None, :] + P, dim=-1)
    return pe


def _check_launch(err, name, plan):
    if err == -2:
        raise RuntimeError("%s: the plan's shared bytes disagree with the "
                           "kernel's layout (%s)" % (name, plan))
    if err == -3:
        raise RuntimeError("%s: no cluster of %d CTAs (%d B of shared "
                           "memory each) fits this card"
                           % (name, plan.clusters, plan.forward_smem))
    _build.check(err, name)


def ridge_forward(e, v, penalty, plan=None):
    """pe (B, T, F) of the forward pass over e (B, T, F) real, time-major,
    with the row coordinates v (F,) of e's type and `penalty` a float
    (rounded to e's type). `plan` (the card only): a `ridge_plan` of F
    and e's item size in place of the default one."""
    _check(e, v, 'ridge_forward')
    if e.device.type == 'cpu':
        return ridge_forward_plain(e, v, penalty)
    _on_card(e, 'ridge_forward')
    lib = _build.load('ridge_dp')
    B, T, F = e.shape
    plan = plan or ridge_plan(F, e.element_size(), batch=B)
    pe = torch.empty_like(e)
    f32 = e.dtype == torch.float32
    if plan.tiled:
        summ = torch.empty((2, B, plan.tiles, 2), dtype=e.dtype,
                           device=e.device)
        vr = torch.empty((plan.tiles, 2), dtype=e.dtype, device=e.device)
        fn = lib.ridge_forward_tiled_f32 if f32 else \
            lib.ridge_forward_tiled_f64
        err = fn(e.data_ptr(), v.data_ptr(), float(penalty), B, F, T,
                 summ.data_ptr(), vr.data_ptr(), pe.data_ptr(),
                 torch.cuda.current_stream(e.device).cuda_stream)
        _check_launch(err, 'ridge_forward', plan)
        ridge_forward.tiled_launches += 1
        return pe
    fn = lib.ridge_forward_f32 if f32 else lib.ridge_forward_f64
    err = fn(e.data_ptr(), v.data_ptr(), float(penalty), B, F, T,
             plan.clusters, plan.rows, int(plan.resident), plan.warps,
             plan.forward_smem, pe.data_ptr(),
             torch.cuda.current_stream(e.device).cuda_stream)
    _check_launch(err, 'ridge_forward', plan)
    ridge_forward.launches += 1
    return pe


ridge_forward.launches = 0
ridge_forward.tiled_launches = 0


def ridge_trace_plain(pe, e, v, penalty, eps):
    """Plain version: `_fw_bw_jit`'s reverse scan, one step per column."""
    P = ridge_penalty(v, penalty)
    B, T, F = pe.shape
    eps = torch.as_tensor(eps, dtype=pe.dtype, device=pe.device)
    fw = torch.argmin(pe, dim=-1)                            # (B, T)
    rows = torch.arange(B, device=pe.device)
    f_rev = torch.arange(F - 1, -1, -1, device=pe.device)
    ridge = torch.empty((B, T), dtype=torch.int64, device=pe.device)
    nxt = ridge[:, T - 1] = fw[:, T - 1]
    for t in range(T - 2, -1, -1):
        val = pe[rows, t + 1, nxt] - e[rows, t + 1, nxt]
        cond = torch.abs(val[:, None] - (pe[:, t] + P[nxt])) < eps
        # the last f that qualifies, else the forward argmin
        last = f_rev[torch.argmax(cond.flip(-1).to(torch.uint8), dim=-1)]
        nxt = ridge[:, t] = torch.where(cond.any(-1), last, fw[:, t])
    return ridge


def _trace_records_plain(pe, e, v, plan):
    """Plain version of the tiled trace's prologue: (rec, vr) as
    `_trace_records` gives them, rec's padding past each record's nT + 3
    elements zero."""
    B, T, F = pe.shape
    G, nt = plan.trace_rows, plan.trace_tiles
    stride = plan.trace_slot // pe.element_size()
    inf = torch.tensor(float('inf'), dtype=pe.dtype, device=pe.device)
    tiles = torch.cat([pe, inf.expand(B, T, nt * G - F)], -1)
    fw = torch.argmin(pe, dim=-1)                          # (B, T)
    at = fw[..., None]
    rec = torch.zeros((B, T, stride), dtype=pe.dtype, device=pe.device)
    rec[..., :nt] = tiles.view(B, T, nt, G).amin(-1)
    rec[..., nt] = (pe.gather(-1, at) - e.gather(-1, at))[..., 0]
    rec[..., nt + 1] = v[fw]
    ibits = torch.int32 if pe.dtype == torch.float32 else torch.int64
    rec[..., nt + 2] = fw.to(ibits).view(pe.dtype)
    vt = torch.cat([v, v[-1:].expand(nt * G - F)]).view(nt, G)
    vr = torch.stack([vt.amin(-1), vt.amax(-1)], -1)
    return rec, vr


def _trace_records(pe, e, v, plan):
    """The tiled trace's prologue on the card: rec (B, T, stride), each
    step's record (the least of pe[t] over each of the plan's
    `trace_tiles` tiles of `trace_rows` f, NaN-propagating, then pe[t, fw]
    - e[t, fw], v[fw] and the bits of fw = argmin_f pe[t], its first
    occurrence), and vr (nT, 2), each tile's v range. Counted on
    `ridge_trace.prologue_launches`; CPU tensors take the plain version.
    pe, e and v as `ridge_trace` checks them, `plan` a tiled plan of F."""
    if pe.device.type == 'cpu':
        return _trace_records_plain(pe, e, v, plan)
    _on_card(pe, 'ridge_trace')
    B, T, F = pe.shape
    lib = _build.load('ridge_dp')
    stride = plan.trace_slot // pe.element_size()
    rec = torch.empty((B, T, stride), dtype=pe.dtype, device=pe.device)
    vr = torch.empty((plan.trace_tiles, 2), dtype=pe.dtype,
                     device=pe.device)
    fn = (lib.ridge_trace_prologue_f32 if pe.dtype == torch.float32
          else lib.ridge_trace_prologue_f64)
    err = fn(pe.data_ptr(), e.data_ptr(), v.data_ptr(), B, F, T,
             plan.trace_rows, plan.trace_tiles, stride, rec.data_ptr(),
             vr.data_ptr(), torch.cuda.current_stream(pe.device).cuda_stream)
    _check_launch(err, 'ridge_trace', plan)
    ridge_trace.prologue_launches += 1
    return rec, vr


def ridge_trace(pe, e, v, penalty, eps, plan=None):
    """ridge (B, T) int64 of the backward trace over pe and e (B, T, F),
    time-major, with v (F,), `penalty` and `eps` floats (rounded to pe's
    type). `plan` (the card only): a `ridge_plan` of F and pe's item size
    in place of the default one."""
    _check(e, v, 'ridge_trace')
    if pe.shape != e.shape or pe.dtype != e.dtype or \
            pe.device != e.device or not pe.is_contiguous():
        raise ValueError("pe must be contiguous, of e's shape, type and "
                         "device")
    if pe.device.type == 'cpu':
        return ridge_trace_plain(pe, e, v, penalty, eps)
    _on_card(pe, 'ridge_trace')
    B, T, F = pe.shape
    plan = plan or ridge_plan(F, pe.element_size(), batch=B)
    if plan.tiled:
        rec, vr = _trace_records(pe, e, v, plan)
        return _trace_walk(pe, e, v, penalty, eps, rec, vr, plan)
    lib = _build.load('ridge_dp')
    ridge = torch.empty((B, T), dtype=torch.int32, device=pe.device)
    stream = torch.cuda.current_stream(pe.device).cuda_stream
    # the rings' bulk copies read 16-byte aligned pieces of the tensors
    pe, e = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (pe, e))
    fn = (lib.ridge_trace_f32 if pe.dtype == torch.float32
          else lib.ridge_trace_f64)
    err = fn(pe.data_ptr(), e.data_ptr(), v.data_ptr(), float(penalty),
             float(eps), B, F, T, plan.trace_rows, plan.trace_depth,
             plan.trace_e_depth, plan.trace_smem, ridge.data_ptr(), stream)
    _check_launch(err, 'ridge_trace', plan)
    ridge_trace.launches += 1
    return ridge.long()


ridge_trace.launches = 0
ridge_trace.tiled_launches = 0
ridge_trace.prologue_launches = 0


def _trace_walk(pe, e, v, penalty, eps, rec, vr, plan):
    """The tiled trace's walk on the card, from `_trace_records`' `rec`
    and `vr` for the same pe, e, v and `plan`: ridge (B, T) int64, as
    `ridge_trace` gives it. Counted on `ridge_trace.tiled_launches`; CPU
    tensors take the plain trace."""
    if pe.device.type == 'cpu':
        return ridge_trace_plain(pe, e, v, penalty, eps)
    _on_card(pe, 'ridge_trace')
    B, T, F = pe.shape
    lib = _build.load('ridge_dp')
    ridge = torch.empty((B, T), dtype=torch.int32, device=pe.device)
    fn = (lib.ridge_trace_tiled_f32 if pe.dtype == torch.float32
          else lib.ridge_trace_tiled_f64)
    err = fn(pe.data_ptr(), e.data_ptr(), v.data_ptr(), rec.data_ptr(),
             vr.data_ptr(), float(penalty), float(eps), B, F, T,
             plan.trace_rows, plan.trace_tiles,
             plan.trace_slot // pe.element_size(), ridge.data_ptr(),
             torch.cuda.current_stream(pe.device).cuda_stream)
    _check_launch(err, 'ridge_trace', plan)
    ridge_trace.tiled_launches += 1
    return ridge.long()
