# -*- coding: utf-8 -*-
"""The port's generic scatter (B5) and the reassignment from a phase
transform (device='cpu', i.e. the plain PyTorch versions) against the JAX
package on the CPU:

  * `shift_scatter_plain` against the JAX `_scatter_xla` and against the
    JAX kernel `shift_scatter_pallas` in interpret mode: a negative bin
    wrapped once (k = -1 lands in bin nbins - 1), k < -nbins and
    k >= nbins dropped, invalid cells dropped; float32 and float64, one
    signal and a batch, with and without a per-row const;
  * `indexed_sum_onfly` over the lin, log and log-piecewise grids, both
    `flipud`, a scalar and a per-row const, one signal and a batch;
    `indexed_sum` (negative k included) and the `find_closest` family;
  * `phase_cwt` with difftype 'trig' and 'phase' and its default gamma.

The routes built on them are held in tests/test_torch_squeezing.py.

Tolerances: float64 planes within 1e-9 of their max; float32 scatters
within 1e-5 of max|out| (summation order); where float32 bins come from
float32 phase transforms computed apart, Tx by the bins criterion (column
sums within 1e-4 of max, energy within 5e-3).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ssqueezepy_tpu.ops.complexlib import Complex
from ssqueezepy_tpu.ops.phase import phase_cwt as jphase_cwt
from ssqueezepy_tpu.ops.ssq_kernels import (
    _scatter_xla, find_closest as jfind_closest, find_closest_brute as
    jfind_closest_brute, find_closest_lin as jfind_closest_lin,
    find_closest_log as jfind_closest_log, indexed_sum as jindexed_sum,
    indexed_sum_onfly as jindexed_sum_onfly)
from ssqueezepy_tpu.ops.ssq_pallas import shift_scatter_pallas

import ssqueezepy_tpu_torch as tstq
from ssqueezepy_tpu_torch.ops.ssq_cuda import (shift_scatter,
                                               shift_scatter_plain)
from ssqueezepy_tpu_torch.ops.ssq_kernels import (find_closest_brute,
                                                  find_closest_lin,
                                                  find_closest_log)
from torch_jax_reference import xla_reference  # noqa: F401

TOL = {'float32': 1e-5, 'float64': 1e-9}


def _np(c):
    if isinstance(c, torch.Tensor):
        return c.numpy()
    if isinstance(c, Complex):
        return np.asarray(c.re) + 1j * np.asarray(c.im)
    return np.asarray(c)


def _rel(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    return np.abs(a - b).max() / np.abs(b).max()


def _bins_criterion(Tx_t, Tx_j):
    Tx_t, Tx_j = _np(Tx_t), _np(Tx_j)
    m = np.abs(Tx_j).max()
    assert np.abs(Tx_t.sum(-2) - Tx_j.sum(-2)).max() < 1e-4 * m
    e_t, e_j = np.abs(Tx_t).sum(), np.abs(Tx_j).sum()
    assert abs(e_t - e_j) / e_j < 5e-3


def _grid(mode, n):
    """ssq frequency grid of each bin-map mode (as tests/test_ssq_pallas.py
    builds them)."""
    if mode == 'lin':
        return np.linspace(0.008, 0.5, n)
    if mode == 'log':
        return 2 ** np.linspace(np.log2(1 / 2048), np.log2(0.5), n)
    n0 = n // 2
    lo, mid = np.log2(1 / 2048), np.log2(1 / 64)
    seg0 = 2 ** (lo + (mid - lo) / n0 * np.arange(n0 + 1))
    seg1 = seg0[-1] * 2 ** ((mid - lo) / n0 / 4 * np.arange(1, n - n0))
    return np.concatenate([seg0, seg1])


def _cplx(rng, shape, dtype):
    cdt = np.complex64 if dtype == 'float32' else np.complex128
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(cdt)


def _scatter_case(shape, nbins, dtype, seed):
    """v, k spanning [-2 nbins, 2 nbins) with the edge cases planted
    (k = -1, -nbins, -nbins - 1, nbins), valid with ~20% false."""
    rng = np.random.default_rng(seed)
    v = _cplx(rng, shape, dtype)
    k = rng.integers(-2 * nbins, 2 * nbins, shape).astype(np.int32)
    k[..., 0, :4] = [-1, -nbins, -nbins - 1, nbins]
    valid = rng.random(shape) > 0.2
    valid[..., 0, :4] = True
    return v, k, valid


def _xla(v, k, valid, nbins):
    """The JAX `_scatter_xla` of one signal, or per signal of a batch (the
    JAX package vmaps it)."""
    if v.ndim == 3:
        return np.stack([_xla(*a, nbins) for a in zip(v, k, valid)])
    out = _scatter_xla(jnp.asarray(v.real), jnp.asarray(v.imag),
                       jnp.asarray(k), jnp.asarray(valid), nbins)
    return _np(out)


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
@pytest.mark.parametrize('shape', [(37, 300), (3, 21, 200)])
@pytest.mark.parametrize('const', [False, True])
def test_shift_scatter_plain_vs_xla(dtype, shape, const):
    nbins = 30
    v, k, valid = _scatter_case(shape, nbins, dtype, hash((dtype, shape))
                                % 2**32)
    c = (np.random.default_rng(1).random(shape[-2]) + .5).astype(dtype)
    out = shift_scatter(torch.from_numpy(v), torch.from_numpy(k),
                        torch.from_numpy(valid), nbins,
                        torch.from_numpy(c) if const else None)
    assert out.shape == shape[:-2] + (nbins, shape[-1])
    ref = _xla(v * c[:, None] if const else v, k, valid, nbins)
    assert _rel(out, ref) <= TOL[dtype]


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_shift_scatter_plain_vs_jax_pallas(dtype):
    """Against the TPU kernel run in interpret mode, as
    tests/test_ssq_pallas.py runs it (T = 128)."""
    na, N, nbins = 40, 256, 36
    v, k, valid = _scatter_case((na, N), nbins, dtype, 3)
    out = shift_scatter_plain(torch.from_numpy(v), torch.from_numpy(k),
                              torch.from_numpy(valid), nbins)
    ref = shift_scatter_pallas(jnp.asarray(v.real), jnp.asarray(v.imag),
                               jnp.asarray(k), jnp.asarray(valid), nbins,
                               interpret=True, T=128)
    assert _rel(out, ref) <= TOL[dtype]


def test_shift_scatter_wrap_and_drop_rules():
    """One cell each: k = -1 lands in bin nbins - 1, k = -nbins in bin 0;
    k = -nbins - 1, k = nbins and an invalid cell are dropped."""
    nbins = 4
    v = torch.tensor([[1., 2., 4., 8., 16., 32.]], dtype=torch.complex128)
    k = torch.tensor([[-1, -4, -5, 4, 2, 1]], dtype=torch.int32)
    valid = torch.tensor([[True, True, True, True, True, False]])
    out = shift_scatter(v, k, valid, nbins)
    expect = np.zeros((nbins, 6), complex)
    expect[3, 0], expect[0, 1], expect[2, 4] = 1., 2., 16.
    assert np.array_equal(out.numpy(), expect)
    assert np.array_equal(out.numpy(), _xla(v.numpy(), k.numpy(),
                                            valid.numpy(), nbins))
    # B2's contract differs: k = -1 marks a dropped cell there
    from ssqueezepy_tpu_torch.ops.ssq_cuda import scatter_kv
    assert scatter_kv(v, k, torch.ones(1, dtype=torch.float64),
                      nbins)[3, 0] == 0


def test_shift_scatter_checks_inputs():
    v = torch.zeros((3, 8), dtype=torch.complex64)
    k = torch.zeros((3, 8), dtype=torch.int32)
    n0 = shift_scatter.launches
    with pytest.raises(ValueError):
        shift_scatter(v, k[:2], None, 4)
    with pytest.raises(TypeError):
        shift_scatter(v, k.long(), None, 4)
    with pytest.raises(ValueError):
        shift_scatter(v, k, torch.ones((3, 8), dtype=torch.uint8), 4)
    with pytest.raises(TypeError):
        shift_scatter(v, k, None, 4, torch.ones(3, dtype=torch.float64))
    with pytest.raises(TypeError):
        shift_scatter(v.real.contiguous(), k, None, 4)
    assert shift_scatter(v, k, None, 4).shape == (4, 8)
    assert shift_scatter.launches == n0          # CPU: the plain version


@pytest.mark.parametrize('mode', ['lin', 'log', 'log-piecewise'])
@pytest.mark.parametrize('flipud', [True, False])
@pytest.mark.parametrize('const', ['scalar', 'rows'])
def test_indexed_sum_onfly_vs_jax(mode, flipud, const):
    """float64: w spanning the grid (and beyond it) with inf cells."""
    na, N = 40, 400
    freqs = _grid(mode, na)
    rng = np.random.default_rng(hash((mode, flipud, const)) % 2**32)
    Wx = _cplx(rng, (na, N), 'float64')
    w = np.exp(rng.uniform(np.log(freqs[0] / 2), np.log(freqs[-1] * 2),
                           (na, N)))
    w[rng.random((na, N)) < 0.1] = np.inf
    w[0, :3] = [0., freqs[0], freqs[-1]]
    c = 0.3 if const == 'scalar' else rng.random(na) + .5
    logscale = mode != 'lin'
    Tx_t = tstq.indexed_sum_onfly(torch.from_numpy(Wx), torch.from_numpy(w),
                                  freqs, c, logscale, flipud, device='cpu')
    Tx_j = jindexed_sum_onfly(Complex.from_numpy(Wx), jnp.asarray(w), freqs,
                              c, logscale, flipud)
    assert Tx_t.shape == (na, N)
    assert _rel(Tx_t, Tx_j) <= 1e-9


def test_indexed_sum_onfly_batched_float32():
    """A (3, na, N) float32 batch against JAX's vmapped route, and each
    row against the one-signal call."""
    na, N = 24, 300
    freqs = _grid('log', na)
    rng = np.random.default_rng(8)
    Wx = _cplx(rng, (3, na, N), 'float32')
    w = np.exp(rng.uniform(np.log(freqs[0]), np.log(freqs[-1]),
                           (3, na, N))).astype(np.float32)
    c = (rng.random(na) + .5).astype(np.float32)
    Tx_t = tstq.indexed_sum_onfly(Wx, w, freqs, c, True, True, device='cpu')
    Tx_j = jindexed_sum_onfly(Complex.from_numpy(Wx), jnp.asarray(w), freqs,
                              c, True, True)
    assert Tx_t.shape == (3, na, N)
    _bins_criterion(Tx_t, Tx_j)
    for b in range(3):
        assert torch.equal(Tx_t[b], tstq.indexed_sum_onfly(
            Wx[b], w[b], freqs, c, True, True, device='cpu'))


@pytest.mark.parametrize('real', [False, True])
def test_indexed_sum_vs_jax(real):
    rng = np.random.default_rng(4)
    na, N = 25, 120
    a = rng.standard_normal((na, N))
    if not real:
        a = a + 1j * rng.standard_normal((na, N))
    k = rng.integers(-na - 3, na + 3, (na, N))
    out_t = tstq.indexed_sum(a, k, device='cpu')
    out_j = jindexed_sum(a, k)
    assert isinstance(out_t, np.ndarray) and out_t.shape == (na, N)
    assert np.abs(out_t - out_j).max() <= 1e-12 * np.abs(out_j).max()


@pytest.mark.parametrize('logscale', [False, True])
def test_find_closest_vs_jax(logscale):
    rng = np.random.default_rng(6)
    v = _grid('log' if logscale else 'lin', 50)
    a = np.exp(rng.uniform(np.log(v[0]), np.log(v[-1]), (20, 30)))
    a[0, :2] = v[0], v[-1]
    k_t = tstq.find_closest(a, v, logscale)
    assert np.array_equal(k_t, jfind_closest(a, v, logscale))
    assert np.array_equal(tstq.find_closest(a, v, logscale, smart=False),
                          jfind_closest(a, v, logscale, smart=False))
    if not logscale:
        assert np.array_equal(k_t, find_closest_brute(a, v))
    assert np.array_equal(find_closest_brute(a, v),
                          jfind_closest_brute(a, v))
    assert np.array_equal(find_closest_lin(a, v), jfind_closest_lin(a, v))
    assert np.array_equal(find_closest_log(a, v), jfind_closest_log(a, v))


@pytest.mark.parametrize('difftype', ['trig', 'phase'])
@pytest.mark.parametrize('gamma', [None, 1e-3])
def test_phase_cwt_vs_jax(difftype, gamma):
    """float64 CWT planes of white noise with a gated run of cells; the
    default gamma is sqrt(eps) (not phase_stft's 10 eps)."""
    x = np.random.default_rng(2).standard_normal(700)
    Wx, _, dWx = tstq.cwt(x, ('gmw', {'dtype': 'float64'}), scales='log',
                          nv=8, derivative=True, device='cpu',
                          astensor=False)
    Wx[2, 100:140] *= 1e-9
    w_t = tstq.phase_cwt(torch.from_numpy(Wx), torch.from_numpy(dWx),
                         difftype, gamma).numpy()
    w_j = np.asarray(jphase_cwt(Complex.from_numpy(Wx),
                                Complex.from_numpy(dWx), difftype, gamma))
    assert w_t.shape == Wx.shape and w_t.dtype == np.float64
    inf_t = np.isinf(w_t)
    assert np.array_equal(inf_t, np.isinf(w_j)) and inf_t[2, 100:140].all()
    fin = ~inf_t
    assert np.abs(w_t[fin] - w_j[fin]).max() <= 1e-9 * np.abs(w_j[fin]).max()
