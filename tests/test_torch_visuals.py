# -*- coding: utf-8 -*-
"""The port's visuals (`ssqueezepy_tpu_torch/visuals.py`) on the CPU under
matplotlib's Agg backend, `plt.show` replaced by a counter and every
figure closed after each case:

  * every name of the JAX package's `visuals.__all__` exists, with the
    same signature;
  * each function renders from numpy arrays and from tensors;
  * `Wavelet.viz` (each visual it dispatches to), `toolkit.lin_band`
    (whose band equals the JAX package's) and the drawing methods of
    `TestSignals` (`demo`, `test_transforms`, `wavcomp`, `cwt_vs_stft`,
    `ridgecomp`, the last three running the port's transforms on
    `device='cpu'`) at N = 256.
"""
import inspect

import matplotlib
import numpy as np
import pytest
import torch

import ssqueezepy_tpu as jstq
from ssqueezepy_tpu import visuals as jvis

import ssqueezepy_tpu_torch as tstq
from ssqueezepy_tpu_torch import visuals as tvis
from torch_jax_reference import xla_reference  # noqa: F401

matplotlib.use('Agg')
import matplotlib.pyplot as plt  # noqa: E402

N = 256


@pytest.fixture
def shows(monkeypatch):
    """Counts `plt.show` calls (drawn, never displayed); closes every
    figure after the case."""
    calls = []
    monkeypatch.setattr(plt, 'show', lambda *a, **k: calls.append(1))
    yield calls
    plt.close('all')


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_names_and_signatures_match_jax():
    assert tvis.__all__ == jvis.__all__
    for name in jvis.__all__:
        assert (inspect.signature(getattr(tvis, name))
                == inspect.signature(getattr(jvis, name))), name


def _data():
    rng = np.random.default_rng(0)
    z = rng.standard_normal((8, 32)) + 1j * rng.standard_normal((8, 32))
    return z, torch.as_tensor(z)


@pytest.mark.parametrize('as_tensor', [False, True])
def test_generic_plotters_render(shows, as_tensor):
    z = _data()[as_tensor]
    x = z[0]
    tvis.imshow(z, abs=1, title='|z|', xticks=np.arange(32),
                yticks=np.linspace(0, 1, 8), xlabel='t', ylabel='f')
    tvis.imshow(z, show=0, ticks=0, w=.5, h=.5)
    tvis.plot(x, complex=1, vlines=[3, 5], hlines=([0.], {'color': 'k'}),
              xlims=(0, 31), ylims=(-3, 3), title='x', show=1)
    tvis.plot(np.arange(32), x, abs=1)
    tvis.plots([x, x.real], pkw=[{'title': 'a'}, {'title': 'b'}])
    tvis.scat(x, abs=1, vlines=[1], show=1)
    tvis.plotscat(x.real, show=1)
    tvis.hist(z, bins=10, stats=1, show=1)
    assert len(shows) == 6
    assert plt.get_fignums()


def test_wavelet_visuals_render(shows, tmp_path):
    wav = tstq.Wavelet('gmw', N=N)
    scales = np.array([2., 4., 8.])
    tvis.wavelet_tf(wav, N=N, scale=8.)
    tvis.wavelet_tf_anim(wav, N=N, scales=scales, fps=5,
                         savepath=str(tmp_path / 'tf.gif'))
    assert (tmp_path / 'tf.gif').stat().st_size > 0
    tvis.wavelet_heatmap(wav, scales='log', N=N)
    tvis.wavelet_filterbank(wav, N=N, scales='log', skips=2)
    tvis.wavelet_waveforms(wav, N, 8.)
    for sweep in (tvis.sweep_std_t, tvis.sweep_std_w, tvis.sweep_harea):
        vals = sweep(wav, N, scales)
        assert vals.shape == (3,) and np.isfinite(vals).all()
    tvis._viz_cwt_scalebounds(wav, N, min_scale=2., max_scale=30.)
    tvis.viz_cwt_higher_order(torch.as_tensor(_data()[0][None]))
    tvis.viz_gmw_orders(N=N, n_orders=2)
    assert len(shows) >= 12
    with pytest.raises(ValueError, match='not supported'):
        tvis.wavelet_viz(wav, 'nope')


@pytest.mark.parametrize('name', ['overview', 'heatmap', 'waveforms',
                                  'filterbank', 'std_t', 'time-frequency'])
def test_wavelet_viz_renders(shows, name):
    wav = tstq.Wavelet(('morlet', {'mu': 6.}), N=N)
    kw = {'waveforms': dict(N=N, scale=8.),
          'std_t': dict(N=N, scales=np.array([4., 16.]))}.get(name, {})
    wav.viz(name, **kw)
    assert shows


def test_lin_band_equals_jax(shows):
    Tx = np.abs(_data()[0])
    cc, cw = tstq.toolkit.lin_band(torch.as_tensor(Tx), .5, .1, bw=.1)
    cc_j, cw_j = jstq.toolkit.lin_band(Tx, .5, .1, bw=.1)
    np.testing.assert_array_equal(cc, cc_j)
    np.testing.assert_array_equal(cw, cw_j)
    assert len(shows) == 2                  # one figure each


def test_test_signals_draw(shows, one_thread):
    """The drawing methods at N = 256 on the CPU."""
    tsig = tstq.TestSignals(N=N)
    tsig.demo(['cosine', 'lchirp'])
    tsig.demo('lchirp', dft='rows')
    with pytest.raises(ValueError):
        tsig.demo('lchirp', dft='x')
    tsig.test_transforms(lambda x, t, p: (np.abs(np.fft.rfft(x))[None],
                                          {'title': p[0]}), ['cosine'])
    tsig.wavcomp(['gmw', 'morlet'], signals='lchirp', device='cpu')
    tsig.cwt_vs_stft('gmw', 'hann', signals='lchirp', n_fft=64,
                     device='cpu')
    for transform in ('cwt', 'stft'):
        tsig.ridgecomp(transform, signals='lchirp', n_ridges=1,
                       device='cpu')
    assert len(shows) == 3 + 1 + 2 + 2 + 2
