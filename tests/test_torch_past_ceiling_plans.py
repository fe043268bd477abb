# -*- coding: utf-8 -*-
"""The port's plans past the kernels' rules (ROADMAP.md queue C items 5
and 1c) and the ridge kernels past their resident plan, on the CPU,
against the JAX package's XLA path.

The three rules are made to refuse every shape, as in
`tests/test_torch_past_ceiling.py` (its `past_ceilings` fixture here;
inside the spawned ranks `tests/torch_dist_worker.py::_past_ceilings`
does the same), so each plan decides, when it is made, the general
routes the one-device calls take there, and every call is counted on
the general functions:

  * the sharded plans on gloo worlds of two ranks (`past_ceiling_world`:
    'scale' and 'time' of size 2, and a three-axis mesh with 'time' 2):
    `sharded_cwt`, `ShardedSSQCWT` (and 'lebesgue'), `ShardedSSQCWT2`,
    `TimeShardedSSQCWT` (both modes), `FullShardedSSQCWT`,
    `ShardedSSQSTFT` ('sum', 'abs') and `ShardedSSQSTFT2` against the
    JAX package's plans on meshes of the same shape; then with the
    scatters' rule alone refusing, the CWT kernel's routes with
    `scatter_general` in B2's place;
  * every streaming plan over four chunks and `finalize` against the JAX
    package's plan, and the two CWT plans with the scatters' rule alone;
  * `extract_ridges` with the resident plan's limit lowered, so that F =
    300 takes the row-tiled plan, against the JAX package's.

Float64 at N = 2048 (12 scales, n_fft 96): every output within 1e-9 of
its max.
"""
import jax
import numpy as np
import pytest

import ssqueezepy_tpu as jstq
from ssqueezepy_tpu import parallel as jpar

from ssqueezepy_tpu_torch import streaming as tstream
from ssqueezepy_tpu_torch import streaming_multirate as tmr
from ssqueezepy_tpu_torch.ops import ridge_cuda, ssq_cuda
from ssqueezepy_tpu_torch.parallel.distributed import spawn
from test_torch_analysis import _hold_ridges, _planted
from test_torch_past_ceiling import (_clear_plans, _close,
                                     _counted, one_thread,  # noqa: F401
                                     past_ceilings)  # noqa: F401
from torch_jax_reference import xla_reference  # noqa: F401
import torch_dist_worker as w

N = 2048
G64 = w.G64
SC12 = w.SC12
CHUNK = 512


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('SSQ_TPU_TORCH_CACHE',
                  str(tmp_path_factory.mktemp('plans')))
        return spawn(w.past_ceiling_world, 2, (1, 2), timeout=240.)[0]


def _devices(n):
    return jax.devices()[:n]


def _jax_legs():
    """The JAX package's plans on meshes of the worlds' shapes (made when
    called): {leg:
    (a function of x giving the global arrays, the general calls the
    port's leg must make)}."""
    mesh = jpar.make_mesh(batch=1, scale=2, devices=_devices(2))
    tmesh = jpar.make_mesh_time(batch=1, time=2, devices=_devices(2))
    m3 = jpar.make_mesh3(batch=1, scale=1, time=2, devices=_devices(2))
    kw = dict(wavelet=G64, scales=SC12, nv=None)
    cwt1 = {'cwt_general': 1}
    ssq1 = {'cwt_general': 1, 'scatter_general': 1}
    stft = dict(n_fft=96, mesh=mesh, dtype='float64')

    def call(cls, *a, **k):
        return lambda x: cls(*a, **k)(x)
    return {
        'cwt': (lambda x: jpar.sharded_cwt(x, mesh=mesh, **kw)[:1], cwt1),
        'ssq': (call(jpar.ShardedSSQCWT, N, mesh=mesh, **kw), ssq1),
        # the JAX plan takes no squeezing: its one-device call
        'ssq_lebesgue': (lambda x: jstq.ssq_cwt(
            x, squeezing='lebesgue', **kw)[:2], ssq1),
        'cwt2': (call(jpar.ShardedSSQCWT2, N, mesh=mesh, **kw),
                 {'wsst2_general': 1, 'scatter_general': 1}),
        # the interior rows on the extended chunk, the exact rows on the
        # global window: two `cwt_general` calls, one scatter
        'time': (call(jpar.TimeShardedSSQCWT, N, mesh=tmesh, **kw),
                 {'cwt_general': 2, 'scatter_general': 1}),
        'time_bins': (call(jpar.TimeShardedSSQCWT, N, mesh=tmesh,
                           derivative=False, **kw),
                      {'cwt_general': 2, 'scatter_general': 1}),
        'full': (call(jpar.FullShardedSSQCWT, N, mesh=m3, **kw),
                 {'cwt_general': 2, 'scatter_general': 2}),
        'stft_sum': (call(jpar.ShardedSSQSTFT, N, **stft),
                     {'stft_general': 1, 'scatter_general': 1}),
        'stft_abs': (call(jpar.ShardedSSQSTFT, N, squeezing='abs', **stft),
                     {'stft_general': 1, 'scatter_general': 1}),
        'stft2': (call(jpar.ShardedSSQSTFT2, N, **stft),
                  {'fsst2_general': 1, 'scatter_general': 1}),
        'ssq_scatter': (call(jpar.ShardedSSQCWT, N, mesh=mesh, **kw),
                        {'scatter_general': 1}),
        'time_bins_scatter': (call(jpar.TimeShardedSSQCWT, N, mesh=tmesh,
                                   derivative=False, **kw),
                              {'scatter_general': 1}),
    }


LEGS = ['cwt', 'ssq', 'ssq_lebesgue', 'cwt2', 'time', 'time_bins', 'full',
        'stft_sum', 'stft_abs', 'stft2', 'ssq_scatter', 'time_bins_scatter']


@pytest.mark.parametrize('leg', LEGS)
def test_sharded_plans_past_ceilings(world, past_ceilings, one_thread, leg):
    """Each sharded plan returns where it raised C1b, on exactly its
    general functions, every output within 1e-9 of the JAX package's
    plan on a mesh of the same shape."""
    assert not world['jax_imported']
    out, moved = world[leg]
    fn, need = _jax_legs()[leg]
    assert moved == need
    ref = fn(w.noise((2, N), np.float64))
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(out) == len(ref)
    for a, b in zip(out, ref):
        _close(a, b)


def _stream(plan, x):
    """(Tx or None, Wx) of `plan` over `x`'s chunks and `finalize`, the
    emitted columns concatenated, as numpy."""
    parts = [plan.process(x[i * CHUNK:(i + 1) * CHUNK])
             for i in range(len(x) // CHUNK)] + [plan.finalize()]
    parts = [p if isinstance(p, tuple) else (None, p) for p in parts]

    def cat(i):
        got = [p[i] for p in parts if p[i] is not None]
        if not got:
            return None
        return np.concatenate([np.asarray(g.re) + 1j * np.asarray(g.im)
                               if hasattr(g, 're') else np.asarray(g)
                               for g in got], axis=-1)
    return cat(0), cat(1)


CWT_KW = dict(wavelet=G64, scales=SC12, nv=None, N=N)
STFT_KW = dict(n_fft=96, dtype='float64')
# (class name, arguments, the port's module, the general functions each
# step calls: four chunks and the flush's steps)
STREAMS = {
    'ssq_cwt': ('StreamingSSQCWT', CWT_KW, tstream,
                ('cwt_general', 'scatter_general')),
    'cwt': ('StreamingCWT', CWT_KW, tstream, ('cwt_general',)),
    'ssq_cwt2': ('StreamingSSQCWT2', CWT_KW, tstream,
                 ('wsst2_general', 'scatter_general')),
    'multirate': ('StreamingMultirateSSQCWT', CWT_KW, tmr,
                  ('cwt_general', 'scatter_general')),
    'ssq_stft': ('StreamingSSQSTFT', STFT_KW, tstream,
                 ('stft_general', 'scatter_general')),
    'ssq_stft_abs': ('StreamingSSQSTFT', dict(squeezing='abs', **STFT_KW),
                     tstream, ('stft_general', 'scatter_general')),
    'stft': ('StreamingSTFT', STFT_KW, tstream, ('stft_general',)),
    'ssq_stft2': ('StreamingSSQSTFT2', STFT_KW, tstream,
                  ('fsst2_general', 'scatter_general')),
}


def _jax_plan(name, kw):
    from ssqueezepy_tpu import streaming, streaming_multirate
    mod = streaming_multirate if 'Multirate' in name else streaming
    return getattr(mod, name)(CHUNK, **kw)


@pytest.mark.parametrize('stream', list(STREAMS))
def test_streaming_plans_past_ceilings(past_ceilings, one_thread, stream):
    """Each streaming plan over four chunks and `finalize` returns where
    it raised C1b, every step on its general functions (the multirate
    plan's one per octave block), Tx and the planes within 1e-9 of the
    JAX package's plan."""
    name, kw, mod, fns = STREAMS[stream]
    x = w.noise(N, np.float64, seed=3)
    plan = getattr(mod, name)(CHUNK, device='cpu', **kw)
    (Tx, W), moved = _counted(lambda: _stream(plan, x))
    steps = moved[fns[-1]]
    assert steps >= N // CHUNK and set(moved) == set(fns)
    assert all(moved[f] % steps == 0 for f in fns)
    Tj, Wj = _stream(_jax_plan(name, kw), x)
    _close(W, Wj)
    if Tj is not None:
        _close(Tx, Tj)


@pytest.mark.parametrize('stream', ['ssq_cwt', 'ssq_cwt2'])
def test_streaming_cwt_scatter_past_rule(monkeypatch, one_thread, stream):
    """The scatters' rule alone refusing: the CWT kernel's bins modes (B1,
    B8; plain versions here) then `scatter_general` in B2's place, one
    per step, within 1e-9 of the JAX package's plan."""
    _clear_plans()
    monkeypatch.setattr(ssq_cuda, '_SMEM_BUDGET', 0)
    name, kw, mod, _ = STREAMS[stream]
    x = w.noise(N, np.float64, seed=4)
    plan = getattr(mod, name)(CHUNK, device='cpu', **kw)
    (Tx, W), moved = _counted(lambda: _stream(plan, x))
    assert list(moved) == ['scatter_general']
    assert moved['scatter_general'] >= N // CHUNK
    Tj, Wj = _stream(_jax_plan(name, kw), x)
    _close(W, Wj)
    _close(Tx, Tj)


@pytest.mark.parametrize('transform', ['cwt', 'stft'])
def test_extract_ridges_past_resident_plan(monkeypatch, transform):
    """The resident plan's limit lowered, so that F = 300 takes the
    row-tiled plan on every device: `extract_ridges` returns (it raised
    C1b past the resident plan before the tiled mode) and equals the JAX
    package's (float64, two ridges, `get_params`; a differing ridge held
    by the ulp rule of `tests/test_torch_analysis.py`)."""
    monkeypatch.setattr(ridge_cuda, '_SMEM_MAX', 1024)
    assert ridge_cuda.ridge_plan(300, 8).tiled
    scales = (np.geomspace(1, 64, 300) if transform == 'cwt' else
              np.linspace(0, .5, 300))
    assert _hold_ridges(_planted((300, 160), 5, 'float64'), scales,
                        transform, 'float64', 15) == 0
