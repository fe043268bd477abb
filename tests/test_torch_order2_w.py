# -*- coding: utf-8 -*-
"""`get_w=True` of the port's second-order transforms (device='cpu': the
plain versions of the w2 modes of B8 and B7, `wsst2_rows` and
`fsst2_rows`, then the generic scatter B5 by the bins of w2) against the
JAX package's XLA path on the CPU:

  * `ssq_cwt2(get_w=True)` at a power-of-two N (reflect padding, n_up =
    2^13) and unpadded at N = 1000 = 2^3 5^3 (n_up = N, the mixed
    engine's lengths), `ssq_stft2(get_w=True)` at N = 1024 and 1000, one
    signal and a (2, N) batch, in float32 and float64, with squeezing
    'sum', 'lebesgue', 'abs' and a callable;
  * the returned tuple's length, order and types for `astensor` True and
    False.

Tolerances: float64 W/V within 1e-9 of max and w2 by `_w_close` (the same
inf cells, the rest within 1e-9 of max); float32 W/V within 1e-5 of max.
Tx by the order-2 bins criterion of `tests/test_torch_order2.py` in both
types (w2 near a bin edge moves by a rounding across it).
"""
import numpy as np
import pytest
import torch

import ssqueezepy_tpu as jstq

import ssqueezepy_tpu_torch as tstq
from torch_jax_reference import xla_reference  # noqa: F401

TOL = {'float32': 1e-5, 'float64': 1e-9}
SQUEEZINGS = ['sum', 'lebesgue', 'abs', 'callable']


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.numpy()
    if hasattr(a, 're'):
        return np.asarray(a.re) + 1j * np.asarray(a.im)
    return np.asarray(a)


def _rel(a, b):
    return np.abs(_np(a) - _np(b)).max() / np.abs(_np(b)).max()


def _signal(shape, dtype, seed):
    """A linear chirp plus white noise, one row per signal."""
    N = shape[-1]
    n = np.arange(N)
    rng = np.random.default_rng(seed)
    rows = [np.cos(2 * np.pi * ((.02 + .01 * b) * n + .3 / (2 * N) * n ** 2))
            + .1 * rng.standard_normal(N) for b in range(int(np.prod(
                shape[:-1])))]
    return np.stack(rows).reshape(shape).astype(dtype)


def _bins2_criterion(Tx_t, Tx_j):
    Tx_t, Tx_j = _np(Tx_t), _np(Tx_j)
    m = np.abs(Tx_j).max()
    assert np.abs(Tx_t.sum(-2) - Tx_j.sum(-2)).max() < 1e-4 * m
    assert (np.abs(Tx_t - Tx_j) > 1e-3 * m).mean() < 0.02
    e_t, e_j = np.abs(Tx_t).sum(), np.abs(Tx_j).sum()
    assert abs(e_t - e_j) / e_j < 0.02


def _w_close(w_t, w_j):
    """The same cells dropped (inf), the rest within 1e-9 of max."""
    w_t, w_j = _np(w_t), _np(w_j)
    assert w_t.shape == w_j.shape
    inf = np.isinf(w_j)
    assert np.array_equal(np.isinf(w_t), inf)
    assert np.abs(w_t[~inf] - w_j[~inf]).max() <= 1e-9 * np.abs(
        w_j[~inf]).max()


def _cube(W):
    """A callable squeezing both packages can run: W * |W|."""
    return W * W.abs()


def _squeezing(name):
    return _cube if name == 'callable' else name


def _check_w2(out_t, out_j, dtype):
    """(Tx, W, ssq_freqs, scales or Sfs, w2) of both packages, numpy."""
    assert len(out_t) == len(out_j) == 5
    Tx_t, W_t, fr_t, sc_t, w2_t = out_t
    Tx_j, W_j, fr_j, sc_j, w2_j = out_j
    assert Tx_t.shape == Tx_j.shape and Tx_t.dtype == Tx_j.dtype
    assert W_t.shape == W_j.shape and w2_t.shape == W_j.shape
    assert w2_t.dtype == np.dtype(dtype) and w2_j.dtype == w2_t.dtype
    assert np.array_equal(fr_t, fr_j) and np.array_equal(sc_t, sc_j)
    assert _rel(W_t, W_j) <= TOL[dtype]
    if dtype == 'float64':
        _w_close(w2_t, w2_j)
    _bins2_criterion(Tx_t, Tx_j)


@pytest.mark.parametrize('squeezing', SQUEEZINGS)
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
@pytest.mark.parametrize('N,padtype', [(2048, 'reflect'), (1000, None)],
                         ids=['N2048-reflect', 'N1000-unpadded'])
def test_ssq_cwt2_get_w_vs_jax(N, padtype, dtype, squeezing):
    x = _signal((N,), dtype, seed=11)
    spec = ('gmw', {'dtype': dtype})
    kw = dict(nv=16, astensor=False, get_w=True, padtype=padtype,
              squeezing=_squeezing(squeezing))
    out_j = jstq.ssq_cwt2(x, spec, **kw)
    out_t = tstq.ssq_cwt2(x, spec, device='cpu', **kw)
    _check_w2(out_t, out_j, dtype)


@pytest.mark.parametrize('squeezing', SQUEEZINGS)
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
@pytest.mark.parametrize('N', [1024, 1000])
def test_ssq_stft2_get_w_vs_jax(N, dtype, squeezing):
    x = _signal((N,), dtype, seed=12)
    kw = dict(n_fft=128, dtype=dtype, astensor=False, get_w=True,
              squeezing=_squeezing(squeezing))
    out_j = jstq.ssq_stft2(x, **kw)
    out_t = tstq.ssq_stft2(x, device='cpu', **kw)
    _check_w2(out_t, out_j, dtype)


@pytest.mark.parametrize('squeezing', ['sum', 'lebesgue'])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_ssq_stft2_get_w_batch_vs_jax(dtype, squeezing):
    """A (2, N) batch returns w2 (2, n_rows, N), as the JAX package does,
    and each row of the batch is the one-signal call's."""
    x = _signal((2, 1000), dtype, seed=13)
    kw = dict(n_fft=96, dtype=dtype, astensor=False, get_w=True,
              squeezing=squeezing)
    out_j = jstq.ssq_stft2(x, **kw)
    out_t = tstq.ssq_stft2(x, device='cpu', **kw)
    assert out_t[4].shape == (2, 49, 1000)
    _check_w2(out_t, out_j, dtype)
    for b in range(2):
        one = tstq.ssq_stft2(x[b], device='cpu', **kw)
        for a, a1 in zip((out_t[0], out_t[1], out_t[4]),
                         (one[0], one[1], one[4])):
            assert np.array_equal(a[b], a1)


@pytest.mark.parametrize('transform', ['ssq_cwt2', 'ssq_stft2'])
def test_get_w_tuple_types(transform):
    """(Tx, W, ssq_freqs, scales or Sfs, w2): tensors on the device asked
    for with `astensor=True` (w2 real of W's real type), numpy with
    False; the first four as the call without `get_w` returns them, Tx
    by the bins criterion (its own scatter, B5 on the bins of w2, against
    B2 on the kernel's bins)."""
    x = _signal((1200,), 'float32', seed=14)
    fn = getattr(tstq, transform)
    kw = dict(nv=16) if transform == 'ssq_cwt2' else dict(n_fft=128)
    out = fn(x, device='cpu', get_w=True, **kw)
    assert len(out) == 5
    Tx, W, fr, sc, w2 = out
    assert isinstance(Tx, torch.Tensor) and Tx.dtype == torch.complex64
    assert isinstance(W, torch.Tensor) and W.dtype == torch.complex64
    assert isinstance(w2, torch.Tensor) and w2.dtype == torch.float32
    assert w2.shape == W.shape and w2.device.type == 'cpu'
    assert isinstance(fr, np.ndarray) and isinstance(sc, np.ndarray)
    assert bool((w2 >= 0).all())
    ref = fn(x, device='cpu', **kw)
    assert len(ref) == 4
    assert torch.equal(W, ref[1])
    assert np.array_equal(fr, ref[2]) and np.array_equal(sc, ref[3])
    _bins2_criterion(Tx, ref[0])
    out_np = fn(x, device='cpu', get_w=True, astensor=False, **kw)
    assert all(isinstance(a, np.ndarray) for a in out_np)
    assert np.array_equal(out_np[4], w2.numpy())
    assert np.array_equal(out_np[0], Tx.numpy())


def test_ssq_cwt2_get_w_on_a_batch_raises_as_jax():
    """`get_w` on a (B, N) batch raises in both packages, with JAX's
    message; `ssq_stft2` takes it (above)."""
    x = _signal((2, 1000), 'float32', seed=15)
    for fn in (jstq.ssq_cwt2, lambda x, **kw: tstq.ssq_cwt2(
            x, device='cpu', **kw)):
        with pytest.raises(NotImplementedError,
                           match='unsupported with batched input'):
            fn(x, get_w=True)
