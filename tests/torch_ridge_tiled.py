# -*- coding: utf-8 -*-
"""CPU models of the row-tiled ridge DP kernels of `csrc/ridge_dp.cu`,
for the tests and `chip_smoke.py`; torch and numpy only (no JAX), so
`tests/test_torch_ridge_plan.py` and the smoke on the card import it.

  * `forward_mirror`, `trace_mirror`: the kernels' loops, tile tests and
    scans step by step in numpy on small inputs (the tests hold them
    against the plain versions);
  * `ridge_forward_pairs`, `ridge_trace_tiles`: the kernels' skip tests
    in torch at any size, on any device, counting the pairs and tiles the
    kernels evaluate (the smoke reports them beside the kernels' times).

Both follow the kernels: change them together.
"""
import numpy as np
import torch

from ssqueezepy_tpu_torch.ops.ridge_cuda import _TILE, _TILE_WARPS

DT = {4: np.float32, 8: np.float64}
# elements of a replica's largest intermediate (per chunk of columns)
_BUDGET = 1 << 24


# ---- the forward -----------------------------------------------------------
@np.errstate(all='ignore')
def forward_mirror(e, v, pen):
    """`ridge_forward_tiled_kernel`: column 0 (pe = e, each tile's summary
    and v range), the flag of the bound, then per column and item (b,
    tile i of 64 rows) the column's least from the summaries of column
    t - 1, the rows' upper bounds, the tests of every tile j of g, each
    kept tile evaluated by warp j % 8 (j = w + 8 lane + 256 k), the warps'
    partial minima combined, e added, pe and the summary stored. Returns
    pe and, per column, the pairs evaluated (valid rows x valid g of each
    kept tile) and the tile tests."""
    B, T, F = e.shape
    dt = DT[e.element_size()]
    en, vn = e.numpy(), v.numpy()
    pen, inf = dt(pen), dt(np.inf)
    nT = -(-F // _TILE)
    pe = np.full_like(en, np.nan)
    summ = np.full((2, B, nT, 2), np.nan, dt)          # stale contents
    vr = np.full((nT, 2), np.nan, dt)
    pairs = np.zeros(T, np.int64)
    tests = np.zeros(T, np.int64)

    def rows(i):
        r = i * _TILE + np.arange(_TILE)
        return r, r < F, vn[np.minimum(r, F - 1)]

    def store(b, t, i, x, r, ok, vf):                  # warp 0's store_item
        pe[b, t, r[ok]] = x[ok]
        k = int(np.argmin(x[ok]))                      # first NaN, else least
        summ[t & 1, b, i] = x[ok][k], vf[ok][k]

    for it in range(B * nT):
        b, i = divmod(it, nT)
        r, ok, vf = rows(i)
        store(b, 0, i, np.where(ok, en[b, 0, np.minimum(r, F - 1)], 0),
              r, ok, vf)
        if b == 0:                                     # NaN-propagating
            vr[i] = np.min(vf), np.max(vf)
    if T == 1:
        return torch.as_tensor(pe), pairs, tests
    lo, hi = np.min(vr[:, 0]), np.max(vr[:, 1])
    s = hi - lo
    prune = bool(pen >= 0 and pen < inf and lo > -inf and hi < inf
                 and s * s < inf)
    for t in range(1, T):
        sin, prev = summ[(t - 1) & 1], pe[:, t - 1]
        tests[t] = B * nT * nT
        for it in range(B * nT):
            b, i = divmod(it, nT)
            r, ok, vf = rows(i)
            k = int(np.argmin(sin[b, :, 0]))           # tile, then its row
            ms, ws = sin[b, k]
            p = prev[b, np.minimum(r, F - 1)]
            d0, d1 = vf - vf, vf - ws
            ub = np.max(np.where(ok, np.minimum(p + pen * (d0 * d0),
                                                ms + pen * (d1 * d1)), -inf))
            lo_i, hi_i = vr[i]
            D = np.maximum(np.maximum(vr[:, 0] - hi_i, lo_i - vr[:, 1]),
                           dt(0))
            keep = ~(sin[b, :, 0] + pen * (D * D) > ub) | (not prune)
            part = np.full((_TILE_WARPS, _TILE), inf, dt)
            for w in range(_TILE_WARPS):
                js = np.nonzero(keep)[0]
                js = js[js % _TILE_WARPS == w]
                if not len(js):
                    continue
                g = (js[:, None] * _TILE + np.arange(_TILE)).ravel()
                g = g[g < F]
                d = vf[:, None] - vn[g][None, :]
                part[w] = np.min(prev[b, g][None, :] + pen * (d * d), axis=1)
                pairs[t] += ok.sum() * len(g)
            x = en[b, t, np.minimum(r, F - 1)] + np.min(part, axis=0)
            store(b, t, i, x, r, ok, vf)
    return torch.as_tensor(pe), pairs, tests


# ---- the trace ---------------------------------------------------------------
@np.errstate(all='ignore')
def trace_mirror(pe, e, v, pen, eps, plan):
    """`ridge_trace_prologue_kernel` then `ridge_trace_tiled_kernel`: the
    records (tile minima, pe - e and v at fw, fw), the tiles' v ranges;
    the walk from T - 1 with, per step, lanes testing 32 tiles at a time
    from the high-f end, the kept ones scanned in that order until one
    holds a qualifying f (its last), else fw. Returns the indices, the
    tiles scanned per step and the records' parts."""
    B, T, F = pe.shape
    dt = DT[pe.element_size()]
    G, nT = plan.trace_rows, plan.trace_tiles
    p, en, vn = pe.numpy(), e.numpy(), v.numpy()
    pen, eps, inf = dt(pen), dt(eps), dt(np.inf)
    mt = np.min(np.concatenate([p, np.full((B, T, nT * G - F), inf, dt)],
                               -1).reshape(B, T, nT, G), -1)
    fw = np.argmin(p, -1)                              # first NaN, else least
    at = fw[..., None]
    fval = (np.take_along_axis(p, at, -1) -
            np.take_along_axis(en, at, -1))[..., 0]
    fv = vn[fw]
    vt = np.concatenate([vn, np.repeat(vn[-1:], nT * G - F)]).reshape(nT, G)
    lo, hi = np.min(vt, -1), np.max(vt, -1)
    out = np.empty((B, T), np.int64)
    scanned = np.zeros(T, np.int64)
    prune, none = bool(pen >= 0), not bool(eps > 0)
    for b in range(B):
        val = vq = dt(0)
        for t in range(T - 1, -1, -1):
            found = -1
            if t < T - 1 and not none and val == val:
                for k in range(-(-nT // 32)):
                    js = nT - 1 - np.arange(32) - 32 * k
                    js = js[js >= 0]
                    can = np.ones(len(js), bool)
                    if prune:
                        D = np.maximum(np.maximum(lo[js] - vq, vq - hi[js]),
                                       dt(0))
                        can = ~(val - (mt[b, t, js] + pen * (D * D)) < -eps)
                    for jj in js[can]:                 # lowest lane first
                        scanned[t] += 1
                        f = np.arange(jj * G, min(F, jj * G + G))
                        d = vq - vn[f]
                        q = np.nonzero(np.abs(val - (p[b, t, f] + pen * (
                            d * d))) < eps)[0]
                        if len(q):
                            found = int(f[q[-1]])
                            break
                    if found >= 0:
                        break
            if found >= 0:
                nval, nvq = p[b, t, found] - en[b, t, found], vn[found]
            else:
                found, nval, nvq = int(fw[b, t]), fval[b, t], fv[b, t]
            out[b, t] = found
            val, vq = nval, nvq
    return torch.as_tensor(out), scanned, (mt, fval, fv, fw, lo, hi)


# ---- replicas of the tiled kernels' skip tests ----------------------------
def _tiles(x, n, G, fill):
    """x (..., F) padded with `fill` to n tiles of G: (..., n, G)."""
    pad = n * G - x.shape[-1]
    return torch.cat([x, fill.expand(x.shape[:-1] + (pad,))], -1).view(
        x.shape[:-1] + (n, G))


def ridge_forward_pairs(pe, v, penalty):
    """The (f, g) pairs (and the tile tests) the tiled forward evaluates
    on the input whose forward pass is pe (B, T, F) (the plain version's,
    which the kernel's equals bit for bit), with v (F,) and `penalty`:
    its skip test replicated in torch, the same rounded operations on the
    same values. Returns (pairs, tests), int64 tensors (T,): column 0
    evaluates none. Without the bound (pen NaN, negative or infinite, a v
    not finite or the square of v's spread not finite) every pair."""
    B, T, F = pe.shape
    dt, dev = pe.dtype, pe.device
    n = -(-F // _TILE)
    pen = torch.as_tensor(penalty, dtype=dt, device=dev)
    inf = torch.tensor(float('inf'), dtype=dt, device=dev)
    pairs = torch.zeros(T, dtype=torch.int64, device=dev)
    tests = torch.zeros(T, dtype=torch.int64, device=dev)
    if T < 2:
        return pairs, tests
    tests[1:] = B * n * n
    vt = _tiles(v, n, _TILE, v[-1:])
    lo, hi = vt.amin(-1), vt.amax(-1)
    s = hi.max() - lo.min()
    prune = bool(pen >= 0) and bool(pen < inf) and bool(lo.min() > -inf) \
        and bool(hi.max() < inf) and bool(s * s < inf)
    if not prune:
        pairs[1:] = B * F * F
        return pairs, tests
    size = torch.full((n,), _TILE, dtype=torch.int64, device=dev)
    size[-1] = F - (n - 1) * _TILE
    w = size[:, None] * size[None, :]                        # rows x g
    D = torch.maximum(torch.maximum(lo[None, :] - hi[:, None],
                                    lo[:, None] - hi[None, :]),
                      torch.zeros((), dtype=dt, device=dev))
    PD = pen * (D * D)                                       # (i, j)
    own = pen * ((v - v) * (v - v))
    chunk = max(1, _BUDGET // (B * n * n))
    for t0 in range(1, T, chunk):
        prev = pe[:, t0 - 1:min(T, t0 + chunk) - 1]          # (B, c, F)
        m = _tiles(prev, n, _TILE, inf).amin(-1)             # (B, c, n)
        g = torch.argmin(prev, dim=-1)                       # first least
        ms = prev.gather(-1, g[..., None])
        d = v - v[g][..., None]
        ub = torch.minimum(prev + own, ms + pen * (d * d))
        ubm = _tiles(ub, n, _TILE, -inf).amax(-1)            # (B, c, n)
        keep = ~((m[:, :, None, :] + PD) > ubm[..., None])   # (B, c, i, j)
        pairs[t0:t0 + prev.shape[1]] = (keep * w).sum((0, 2, 3))
    return pairs, tests


def ridge_trace_tiles(pe, e, v, penalty, eps, ridge, plan):
    """The tiles the tiled trace's walk scans on pe, e (B, T, F) and its
    own result `ridge` (B, T) (each step's decisions depend on r[t+1]
    alone): its skip test replicated in torch. A step scans the tiles
    the bound keeps from the high-f end down to the first that holds a
    qualifying f, all kept ones where none does, none where val is NaN or
    eps not > 0, and the last column none. Returns an int64 tensor
    (T,)."""
    B, T, F = pe.shape
    dt, dev = pe.dtype, pe.device
    G, n = plan.trace_rows, plan.trace_tiles
    pen = torch.as_tensor(penalty, dtype=dt, device=dev)
    eps = torch.as_tensor(eps, dtype=dt, device=dev)
    inf = torch.tensor(float('inf'), dtype=dt, device=dev)
    out = torch.zeros(T, dtype=torch.int64, device=dev)
    if T < 2 or not bool(eps > 0):
        return out
    vt = _tiles(v, n, G, v[-1:])
    lo, hi = vt.amin(-1), vt.amax(-1)
    zero = torch.zeros((), dtype=dt, device=dev)
    idx = torch.arange(n, device=dev)
    step = max(1, _BUDGET // (B * F))
    for t0 in range(0, T - 1, step):
        t1 = min(T - 1, t0 + step)
        nx = ridge[:, t0 + 1:t1 + 1]                         # (B, c)
        val = (pe[:, t0 + 1:t1 + 1].gather(-1, nx[..., None]) -
               e[:, t0 + 1:t1 + 1].gather(-1, nx[..., None]))[..., 0]
        vn = v[nx]
        row = pe[:, t0:t1]                                   # (B, c, F)
        d = vn[..., None] - v
        cond = torch.abs(val[..., None] - (row + pen * (d * d))) < eps
        qual = _tiles(cond, n, G, torch.zeros((), dtype=torch.bool,
                                              device=dev)).any(-1)
        can = torch.ones_like(qual)
        if bool(pen >= 0):
            m = _tiles(row, n, G, inf).amin(-1)
            D = torch.maximum(torch.maximum(lo - vn[..., None],
                                            vn[..., None] - hi), zero)
            can = ~((val[..., None] - (m + pen * (D * D))) < -eps)
        top = torch.where(qual, idx, -1).amax(-1)            # (B, c)
        scanned = (can & (idx >= top[..., None])).sum(-1)
        scanned = torch.where(val.isnan(), 0, scanned)
        out[t0:t1] = scanned.sum(0)
    return out
