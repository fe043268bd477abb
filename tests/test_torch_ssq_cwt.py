# -*- coding: utf-8 -*-
"""The port's public `ssq_cwt`/`issq_cwt` (device='cpu', i.e. the kernels'
plain PyTorch versions) against the JAX package's `ssq_cwt` on the CPU
backend, plus the package's boundaries: no JAX import, no silent CPU
fallback, and NotImplementedError outside the ported slice.

Tolerances: Wx 1e-5 of max in float32, 1e-9 relative in float64. Tx in
float32 by the bins criterion (column sums within 1e-4 of max, total
energy within 5e-3: isolated cells may land one bin over where float32
rounding meets a bin boundary); in float64 column sums within 1e-9.
"""
import subprocess
import sys

import numpy as np
import pytest
import torch

import ssqueezepy_tpu as jstq
import ssqueezepy_tpu_torch as tstq
from torch_jax_reference import xla_reference  # noqa: F401

N = 2048


def _noise(seed=0, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(N).astype(dtype)


def _chirp(n=N):
    t = np.linspace(0, 6, n, endpoint=False)
    return np.cos(2 * np.pi * 2 * np.exp(t / 2)).astype(np.float32)


def _bins_criterion(Tx_t, Tx_j):
    m = np.abs(Tx_j).max()
    assert np.abs(Tx_t.sum(-2) - Tx_j.sum(-2)).max() < 1e-4 * m
    e_t, e_j = np.abs(Tx_t).sum(), np.abs(Tx_j).sum()
    assert abs(e_t - e_j) / e_j < 5e-3


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_ssq_cwt_vs_jax(dtype):
    x = _noise(dtype=dtype)
    kw = dict(wavelet=('gmw', {'dtype': dtype}), scales='log-piecewise',
              nv=16, astensor=False)
    Tx_j, Wx_j, fr_j, sc_j = jstq.ssq_cwt(x, **kw)
    Tx_t, Wx_t, fr_t, sc_t = tstq.ssq_cwt(x, device='cpu', **kw)
    assert Tx_t.shape == Tx_j.shape and Wx_t.shape == Wx_j.shape
    assert Tx_t.dtype == Tx_j.dtype
    assert np.array_equal(fr_t, fr_j) and np.array_equal(sc_t, sc_j)
    if dtype == 'float32':
        assert np.abs(Wx_t - Wx_j).max() <= 1e-5 * np.abs(Wx_j).max()
        _bins_criterion(Tx_t, Tx_j)
    else:
        assert np.abs(Wx_t - Wx_j).max() <= 1e-9 * np.abs(Wx_j).max()
        m = np.abs(Tx_j).max()
        assert np.abs(Tx_t.sum(-2) - Tx_j.sum(-2)).max() <= 1e-9 * m
        assert np.abs(Tx_t - Tx_j).max() <= 1e-9 * m


def test_ssq_cwt_tx_only_and_tensor_out():
    x = _noise(1)
    kw = dict(scales='log', nv=16, device='cpu')
    Tx, Wx, fr, sc = tstq.ssq_cwt(x, **kw)
    assert isinstance(Tx, torch.Tensor) and Tx.dtype == torch.complex64
    Tx2, Wx2, _, _ = tstq.ssq_cwt(torch.from_numpy(x), get_Wx=False, **kw)
    assert Wx2 is None
    assert torch.equal(Tx2, Tx)
    assert Wx.shape == (len(sc), N) and Tx.shape == (len(fr), N)


def test_ssq_cwt_scalar_const_geomspace():
    """A geomspace scale array infers 'log': the squeeze constant is one
    scalar, broadcast to every row."""
    x = _noise(2)
    scales = np.geomspace(1., 24., 65).reshape(-1, 1)
    kw = dict(wavelet=('gmw', {'dtype': 'float32'}), scales=scales,
              astensor=False)
    Tx_j, Wx_j, _, _ = jstq.ssq_cwt(x, **kw)
    Tx_t, Wx_t, _, _ = tstq.ssq_cwt(x, device='cpu', **kw)
    assert np.abs(Wx_t - Wx_j).max() <= 1e-5 * np.abs(Wx_j).max()
    _bins_criterion(Tx_t, Tx_j)


def test_ssq_cwt_bench_plan_arrays():
    """The bench passes precomputed `scales` and `ssq_freqs` arrays; both
    packages take the same arrays (here from the JAX plan)."""
    from ssqueezepy_tpu.models.wavelets import Wavelet
    from ssqueezepy_tpu.utils.cwt_utils import process_scales
    from ssqueezepy_tpu.models.ssqueezing import \
        _compute_associated_frequencies
    from ssqueezepy_tpu_torch.convert import plan_from_numpy
    spec = ('gmw', {'dtype': 'float32'})
    wav = Wavelet(spec)
    scales = process_scales('log-piecewise', N, wav, nv=16)
    na = len(scales)
    freqs = _compute_associated_frequencies(scales, N, wav, 'log-piecewise',
                                            'peak', True, 1, 'cwt')
    plan = plan_from_numpy(scales, freqs, spec, N)
    assert np.array_equal(plan['scales'], scales)
    assert plan['params']['mode'] == 'log-piecewise'
    assert np.ravel(plan['const']).shape == (na,)
    x = _noise(3)
    kw = dict(wavelet=spec, scales=scales, ssq_freqs=freqs, astensor=False)
    Tx_j, Wx_j, fr_j, _ = jstq.ssq_cwt(x, **kw)
    Tx_t, Wx_t, fr_t, _ = tstq.ssq_cwt(x, device='cpu', **kw)
    assert np.array_equal(fr_t, fr_j)
    assert np.abs(Wx_t - Wx_j).max() <= 1e-5 * np.abs(Wx_j).max()
    _bins_criterion(Tx_t, Tx_j)


def test_issq_cwt_round_trip():
    x = _chirp()
    Tx, _, _, _ = tstq.ssq_cwt(x, device='cpu')
    xrec = tstq.issq_cwt(Tx)
    assert tstq.toolkit.mad_rms(x, xrec) < 0.1
    Tx_np = Tx.numpy()
    assert np.allclose(tstq.issq_cwt(Tx_np), jstq.issq_cwt(Tx_np),
                       rtol=1e-6, atol=1e-6)


def test_issq_cwt_components_vs_jax():
    x = _chirp()
    Tx, _, _, _ = tstq.ssq_cwt(x, device='cpu', astensor=False)
    na = Tx.shape[0]
    rng = np.random.default_rng(4)
    cc = rng.integers(0, na, (N, 2))
    cc[::7, 1] = -1
    cw = np.full((N, 2), 3)
    out_j = jstq.issq_cwt(Tx, cc=cc, cw=cw)
    out_np = tstq.issq_cwt(Tx, cc=cc, cw=cw)
    out_t = tstq.issq_cwt(torch.from_numpy(Tx), cc=cc, cw=cw)
    assert out_j.shape == out_np.shape == out_t.shape == (3, N)
    assert np.allclose(out_np, out_j, rtol=1e-5, atol=1e-6)
    assert np.allclose(out_t, out_j, rtol=1e-5, atol=1e-6)


def test_import_leaves_jax_out():
    code = ("import sys, ssqueezepy_tpu_torch; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'ssqueezepy_tpu' or "
            "m.startswith('ssqueezepy_tpu.')]; "
            "assert not bad, bad; print('ok')")
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'ok'


def test_default_device_cuda_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match='CUDA'):
        tstq.ssq_cwt(_noise())


# 2-D input, 'abs'/'lebesgue' squeezing and get_dWx are ported; with
# get_dWx a non-'sum' squeezing waits for the generic scatter (B5)
@pytest.mark.parametrize('kw', [
    dict(order=1), dict(get_w=True), dict(squeezing='abs', get_dWx=True),
    dict(squeezing='lebesgue', get_dWx=True),
    dict(get_dWx=True, squeezing='abs'), dict(padtype=None),
    dict(wavelet='morlet'), dict(wavelet=('gmw', {'order': 2})),
    dict(x2d=True, squeezing='lebesgue', get_dWx=True),
], ids=lambda kw: next(iter(kw)) + '=' + str(next(iter(kw.values()))))
def test_outside_slice_raises(kw):
    kw = dict(kw)
    x = _noise()
    if kw.pop('x2d', False):
        x = np.stack([x, x])
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        tstq.ssq_cwt(x, device='cpu', **kw)
