# -*- coding: utf-8 -*-
"""The port's low-level reassignment API takes the JAX package's
parameters at the JAX package's positions (`device` last, the port's
own), so a call written against `ssqueezepy_tpu` means the same in
`ssqueezepy_tpu_torch`:

  * `indexed_sum_onfly(Wx, w, ssq_freqs, const, logscale, flipud, out,
    parallel, params, natural_bins)`: a 7th positional argument is `out`;
  * `ssqueeze_fast(Wx, dWx, ssq_freqs, const, logscale, flipud, gamma,
    Sfs, params, out, natural_bins)`;
  * `indexed_sum(a, k, parallel)`;
  * `phase_cwt(Wx, dWx, difftype, gamma, parallel)` and
    `phase_stft(Sx, dSx, Sfs, gamma, parallel)`.

`out` and `parallel` are accepted and ignored, as the JAX package ignores
them; `natural_bins` picks the TPU scatter's layout there and has no
effect here. Each function is called with every argument positional, in
JAX's order, on the same seeded inputs in both packages (device='cpu':
the plain PyTorch versions), at the tolerances of
tests/test_torch_scatter.py and tests/test_torch_ssqueeze.py.
"""
import inspect

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ssqueezepy_tpu.ops import phase as jphase
from ssqueezepy_tpu.ops import ssq_kernels as jssq
from ssqueezepy_tpu.ops.complexlib import Complex

from ssqueezepy_tpu_torch.ops import phase as tphase
from ssqueezepy_tpu_torch.ops import ssq_kernels as tssq
from torch_jax_reference import xla_reference  # noqa: F401

FUNCS = [(jssq, tssq, 'indexed_sum_onfly'), (jssq, tssq, 'ssqueeze_fast'),
         (jssq, tssq, 'indexed_sum'), (jphase, tphase, 'phase_cwt'),
         (jphase, tphase, 'phase_stft')]


def _np(c):
    if isinstance(c, torch.Tensor):
        return c.numpy()
    if isinstance(c, Complex):
        return np.asarray(c.re) + 1j * np.asarray(c.im)
    return np.asarray(c)


def _cplx(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _rel(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize('jmod,tmod,name', FUNCS,
                         ids=[f[2] for f in FUNCS])
def test_signature_matches_jax(jmod, tmod, name):
    """Same parameter names, positions and defaults as the JAX function;
    the port's `device`, where it has one, comes last."""
    jsig = inspect.signature(getattr(jmod, name)).parameters
    tsig = inspect.signature(getattr(tmod, name)).parameters
    tnames = [n for n in tsig if n != 'device']
    assert tnames == list(jsig)
    assert list(tsig)[-1] == ('device' if 'device' in tsig else tnames[-1])
    for n in jsig:
        assert tsig[n].default == jsig[n].default, n
        assert tsig[n].kind == jsig[n].kind, n


def _onfly_case(seed):
    rng = np.random.default_rng(seed)
    na, N = 32, 300
    freqs = 2 ** np.linspace(np.log2(1 / 1024), np.log2(0.5), na)
    Wx = _cplx(rng, (na, N))
    w = np.exp(rng.uniform(np.log(freqs[0] / 2), np.log(freqs[-1] * 2),
                           (na, N)))
    w[rng.random((na, N)) < 0.1] = np.inf
    c = rng.random(na) + .5
    return freqs, Wx, w, c


def test_indexed_sum_onfly_positional():
    """All ten JAX parameters positional; `params` (9th) is used, `out`
    (7th) ignored: the bin map comes from `params`, so a `ssq_freqs` of
    None still bins."""
    freqs, Wx, w, c = _onfly_case(11)
    params = tssq.ssq_bin_params(freqs, True)
    Tx_t = tssq.indexed_sum_onfly(torch.from_numpy(Wx), torch.from_numpy(w),
                                  None, c, True, True, None, None, params,
                                  None, device='cpu')
    Tx_j = jssq.indexed_sum_onfly(Complex.from_numpy(Wx), jnp.asarray(w),
                                  None, c, True, True, None, None,
                                  jssq.ssq_bin_params(freqs, True), None)
    assert Tx_t.shape == Wx.shape
    assert _rel(Tx_t, Tx_j) <= 1e-9


def test_ssqueeze_fast_positional():
    """All eleven JAX parameters positional (`Sfs` and `params` used, `out`
    and `natural_bins` passed), float64, against JAX's XLA path."""
    rng = np.random.default_rng(12)
    na, N = 30, 160
    freqs = np.linspace(0.008, 0.5, na)
    Wx, dWx = _cplx(rng, (na, N)) * .1, _cplx(rng, (na, N)) * .1
    Sfs = np.linspace(0, .5, na)
    c, gamma = 0.2, 1e-3
    params = tssq.ssq_bin_params(freqs, False)
    Tx_t = tssq.ssqueeze_fast(torch.from_numpy(Wx), torch.from_numpy(dWx),
                              None, c, False, True, gamma, Sfs, params, None,
                              True, device='cpu')
    Tx_j = jax.jit(lambda a, b: jssq.ssqueeze_fast(
        a, b, None, c, False, True, gamma, jnp.asarray(Sfs),
        jssq.ssq_bin_params(freqs, False), None, True))(
            Complex.from_numpy(Wx), Complex.from_numpy(dWx))
    assert Tx_t.shape == (na, N)
    assert _rel(Tx_t, Tx_j) <= 1e-9


def test_indexed_sum_positional():
    """`parallel` as the third positional argument; negative k included."""
    rng = np.random.default_rng(13)
    na, N = 20, 90
    a = _cplx(rng, (na, N))
    k = rng.integers(-na - 2, na + 2, (na, N))
    out_t = tssq.indexed_sum(a, k, True, device='cpu')
    out_j = jssq.indexed_sum(a, k, True)
    assert isinstance(out_t, np.ndarray) and out_t.shape == (na, N)
    assert np.abs(out_t - out_j).max() <= 1e-12 * np.abs(out_j).max()


@pytest.mark.parametrize('difftype', ['trig', 'phase'])
def test_phase_cwt_positional(difftype):
    """`difftype`, `gamma` and `parallel` positional, float64 planes with
    a gated run of cells."""
    rng = np.random.default_rng(14)
    Wx, dWx = _cplx(rng, (12, 200)), _cplx(rng, (12, 200))
    Wx[3, 50:80] *= 1e-9
    w_t = tphase.phase_cwt(torch.from_numpy(Wx), torch.from_numpy(dWx),
                           difftype, 1e-4, True).numpy()
    w_j = np.asarray(jphase.phase_cwt(Complex.from_numpy(Wx),
                                      Complex.from_numpy(dWx), difftype,
                                      1e-4, True))
    inf_t = np.isinf(w_t)
    assert np.array_equal(inf_t, np.isinf(w_j)) and inf_t[3, 50:80].all()
    fin = ~inf_t
    assert np.abs(w_t[fin] - w_j[fin]).max() <= 1e-9 * np.abs(w_j[fin]).max()


def test_phase_stft_positional():
    """`gamma` and `parallel` positional, float64 planes, Sfs per row."""
    rng = np.random.default_rng(15)
    Sx, dSx = _cplx(rng, (17, 150)), _cplx(rng, (17, 150))
    Sx[5, :20] *= 1e-12
    Sfs = np.linspace(0, .5, 17)
    w_t = tphase.phase_stft(torch.from_numpy(Sx), torch.from_numpy(dSx), Sfs,
                            1e-6, True).numpy()
    w_j = np.asarray(jphase.phase_stft(Complex.from_numpy(Sx),
                                       Complex.from_numpy(dSx), Sfs, 1e-6,
                                       True))
    inf_t = np.isinf(w_t)
    assert np.array_equal(inf_t, np.isinf(w_j)) and inf_t[5, :20].all()
    fin = ~inf_t
    assert np.abs(w_t[fin] - w_j[fin]).max() <= 1e-9 * np.abs(w_j[fin]).max()
