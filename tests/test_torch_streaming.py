# -*- coding: utf-8 -*-
"""The port's streaming plans (`ssqueezepy_tpu_torch/streaming.py`,
device='cpu', i.e. the plain PyTorch versions of B1/B3b/B3/B8/B6/B7 and
B2/B5 on each chunk's window) against the JAX package's
(`ssqueezepy_tpu/streaming.py`) on the same seeded input:

  * plan attributes (scales, support, history, lookahead, n_up, nbins,
    n_reliable, the ssq frequency grid, Sfs), exact or to 1e-12;
  * the emission schedule (columns per call) and the carry state
    (`state_dict` after each chunk, hist/pend bit-equal), lookahead 100,
    0 and larger than the chunk;
  * Wx/Sx within 2e-5 of max (float32) or 1e-9 (float64), Tx by the bins
    criterion of `tests/test_sharded.py:76` (order 2: that of
    `tests/test_torch_order2.py`), for every class and `stream_*`
    function, the wavelet variants of the JAX package's
    `test_stream_cwt_wavelet_variants` (and cmhat, the CWT kernel's table
    route), the STFT variants of `test_stream_stft_variants`, every
    squeezing, and a (2, chunk) batch;
  * a JAX plan's `state_dict` loaded into a port plan mid-stream,
    continuing to the JAX plan's continuation;

and port-only checks: streaming STFT and FSST2 against the port's
offline calls (every column, the edges included), resume and reset bit
for bit, a plan on 'cuda' raising without a card, no plan constant
rebuilt per chunk, no module of the port importing `jax`, and the
signatures of the 7 classes and the 5 `stream_*` functions.
The multirate plan and the primitives are in
`tests/test_torch_multirate.py`.
"""
import inspect
import subprocess
import sys

import numpy as np
import pytest
import torch

import ssqueezepy_tpu as jstq
from ssqueezepy_tpu import streaming as js
from ssqueezepy_tpu.ops.complexlib import Complex

import ssqueezepy_tpu_torch as tstq
from ssqueezepy_tpu_torch import streaming as ts
from torch_jax_reference import xla_reference  # noqa: F401

TOL = {'float32': 2e-5, 'float64': 1e-9}


def _np(c):
    if c is None:
        return None
    if isinstance(c, torch.Tensor):
        return c.numpy()
    if hasattr(c, 're'):
        return np.asarray(c.re) + 1j * np.asarray(c.im)
    return np.asarray(c)


def _rel(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / np.abs(b).max()


def _bins_criterion(Tx_t, Tx_j, energy=5e-3):
    Tx_t, Tx_j = _np(Tx_t), _np(Tx_j)
    assert Tx_t.shape == Tx_j.shape
    m = np.abs(Tx_j).max()
    assert np.abs(Tx_t.sum(-2) - Tx_j.sum(-2)).max() < 1e-4 * m
    e_t, e_j = np.abs(Tx_t).sum(), np.abs(Tx_j).sum()
    assert abs(e_t - e_j) / e_j < energy


def _bins2_criterion(Tx_t, Tx_j):
    """The order-2 criterion: column sums, few cells apart, energy."""
    _bins_criterion(Tx_t, Tx_j, energy=0.02)
    Tx_t, Tx_j = _np(Tx_t), _np(Tx_j)
    m = np.abs(Tx_j).max()
    assert (np.abs(Tx_t - Tx_j) > 1e-3 * m).mean() < 0.02


def _chirp(N, f0=0.02, f1=0.18, dtype=np.float32):
    n = np.arange(N)
    return np.cos(2 * np.pi * (f0 * n + (f1 - f0) / (2 * N) * n ** 2)) \
        .astype(dtype)


def _scales(smax=32., n=41):
    return np.geomspace(1., smax, n).reshape(-1, 1)


def _feed(plan, x, chunk, finalize=True):
    """(per-call (Tx, Wx) of `plan` over `x`'s chunks, then finalize's)."""
    out = [plan.process(x[..., i * chunk:(i + 1) * chunk])
           for i in range(x.shape[-1] // chunk)]
    if finalize:
        out.append(plan.finalize())
    return out


def _cat(parts, i):
    ps = [_np(p[i]) for p in parts if p[i] is not None]
    return np.concatenate(ps, axis=-1)


# ---- plan attributes ---------------------------------------------------------
PLANS = {
    'ssq_cwt': ('StreamingSSQCWT', (1024,),
                dict(scales=_scales(64., 97), nv=None, N=4096, history=2048,
                     lookahead=2048)),
    'ssq_cwt_log': ('StreamingSSQCWT', (512,), dict(N=2048)),
    'ssq_cwt_morlet': ('StreamingSSQCWT', (512, 'morlet'),
                       dict(scales=_scales(), nv=None, N=2048,
                            lookahead=100)),
    'ssq_cwt2': ('StreamingSSQCWT2', (1024, 'gmw'),
                 dict(scales=_scales(64., 97), nv=None, N=4096)),
    'cwt_linear': ('StreamingCWT', (512, 'gmw', 'linear'),
                   dict(N=2048, fs=8.)),
    'ssq_stft': ('StreamingSSQSTFT', (1024,), dict(n_fft=256)),
    'ssq_stft_odd': ('StreamingSSQSTFT', (512,),
                     dict(n_fft=255, fs=100., flipud=True)),
    'ssq_stft_freqs': ('StreamingSSQSTFT', (512,),
                       dict(n_fft=128, ssq_freqs=np.linspace(0, .5, 200))),
    'ssq_stft2': ('StreamingSSQSTFT2', (512,), dict(n_fft=128)),
    'stft': ('StreamingSTFT', (512,), dict(n_fft=64, modulated=False)),
}


@pytest.mark.parametrize('name', list(PLANS))
def test_plan_attributes_match_jax(name):
    cls, args, kw = PLANS[name]
    pj = getattr(js, cls)(*args, **kw)
    pt = getattr(ts, cls)(*args, device='cpu', **kw)
    for a in ('chunk', 'history', 'lookahead', 'ssq', 'dtype'):
        assert getattr(pt, a) == getattr(pj, a), a
    np.testing.assert_allclose(pt.ssq_freqs_out, pj.ssq_freqs_out,
                               rtol=1e-12, atol=0)
    if 'STFT' in cls:
        assert pt.n_fft == pj.n_fft and pt.nbins == pj.nbins
        np.testing.assert_array_equal(pt.Sfs, pj.Sfs)
        assert pt.const == pj.const and pt.params == pj.params
        np.testing.assert_array_equal(pt._natural, pj._natural)
        return
    np.testing.assert_array_equal(pt.scales_np, pj.scales_np)
    np.testing.assert_allclose(pt.support_np, pj.support_np, rtol=1e-12)
    np.testing.assert_allclose(pt.const_np, pj.const_np, rtol=1e-12)
    for a in ('n_up', 'pad_extra', 'nbins', 'n_reliable', 'N_plan'):
        assert getattr(pt, a) == getattr(pj, a), a
    assert pt.params.keys() == pj.params.keys()
    for k in pt.params:
        assert pt.params[k] == pytest.approx(pj.params[k], rel=1e-12), k


# ---- emission schedule, carry state, planes ---------------------------------
@pytest.mark.parametrize('chunk,history,lookahead', [
    (512, None, 100), (256, 512, 600), (256, None, 0)],
    ids=['look100', 'look_gt_chunk', 'look0'])
def test_schedule_state_and_planes_match_jax(chunk, history, lookahead):
    """Per-call column counts, `state_dict` after every chunk (hist/pend
    bit-equal), and every emitted Wx/Tx column against the JAX plan's;
    with lookahead > chunk the first calls emit nothing and finalize
    flushes over several synthetic chunks; with 0 finalize emits none."""
    N = 1024 if chunk == 256 else 2048
    x = _chirp(N)
    kw = dict(scales=_scales(16., 25) if chunk == 256 else _scales(), nv=None,
              N=N, history=history, lookahead=lookahead)
    pj = js.StreamingSSQCWT(chunk, 'gmw', **kw)
    pt = ts.StreamingSSQCWT(chunk, 'gmw', device='cpu', **kw)
    out_j, out_t = [], []
    for i in range(N // chunk):
        xi = x[i * chunk:(i + 1) * chunk]
        out_j.append(pj.process(xi))
        out_t.append(pt.process(xi))
        sj, st = pj.state_dict(), pt.state_dict()
        assert st.keys() == sj.keys()
        for k in ('hist', 'pend'):
            assert st[k].dtype == sj[k].dtype
            np.testing.assert_array_equal(st[k], sj[k])
        assert (st['done'], st['ncalls'], st['squeeze']) == \
            (sj['done'], sj['ncalls'], sj['squeeze'])
    out_j.append(pj.finalize())
    out_t.append(pt.finalize())
    cols_j = [0 if o[1] is None else o[1].re.shape[-1] for o in out_j]
    cols_t = [0 if o[1] is None else o[1].shape[-1] for o in out_t]
    assert cols_t == cols_j and sum(cols_t) == N
    if lookahead == 600:
        assert cols_t == [0, 0, 168, 256, 600]
    if lookahead == 0:
        assert out_t[-1] == (None, None)
    assert _rel(_cat(out_t, 1), _cat(out_j, 1)) <= TOL['float32']
    _bins_criterion(_cat(out_t, 0), _cat(out_j, 0))
    with pytest.raises(RuntimeError):
        pt.process(x[:chunk])


@pytest.mark.parametrize('wav', ['morlet', ('gmw', {'dtype': 'float64'}),
                                 'cmhat'], ids=['morlet', 'gmw64', 'cmhat'])
def test_stream_cwt_wavelet_variants(wav):
    """A wavelet off the kernel's route (morlet: `cwt_general` and B5),
    float64, and a table wavelet (cmhat): `stream_cwt` and
    `StreamingCWT`, `stream_ssq_cwt` against the JAX package's."""
    N, chunk = 2048, 512
    x = _chirp(N)
    kw = dict(scales=_scales(16., 25), nv=None)
    dtype = 'float64' if isinstance(wav, tuple) else 'float32'
    Wx_j, sc_j = jstq.stream_cwt(x, chunk, wav, N=N, **kw)
    Wx_t, sc_t = tstq.stream_cwt(x, chunk, wav, N=N, device='cpu', **kw)
    np.testing.assert_array_equal(sc_t, sc_j)
    assert Wx_t.dtype == (torch.complex128 if dtype == 'float64'
                          else torch.complex64)
    assert _rel(Wx_t, Wx_j) <= TOL[dtype]
    plan = tstq.StreamingCWT(chunk, wav, N=N, device='cpu', **kw)
    parts = [plan.process(x[i * chunk:(i + 1) * chunk])
             for i in range(N // chunk)] + [plan.finalize()]
    assert torch.equal(torch.cat(parts, dim=-1), Wx_t)

    Tx_j, W_j, f_j, s_j = jstq.stream_ssq_cwt(x, chunk, wav, **kw)
    Tx_t, W_t, f_t, s_t = tstq.stream_ssq_cwt(x, chunk, wav, device='cpu',
                                              **kw)
    np.testing.assert_allclose(f_t, f_j, rtol=1e-12)
    np.testing.assert_array_equal(s_t, s_j)
    assert _rel(W_t, W_j) <= TOL[dtype]
    _bins_criterion(Tx_t, Tx_j)


def test_stream_ssq_cwt_reconstructs_and_matches_offline():
    """The port's stream round-trips (mad_rms < 0.1) and its column sums
    match the port's offline `ssq_cwt` one support margin from each edge
    (as `tests/test_streaming.py` holds the JAX package)."""
    N, chunk, ctx = 4096, 1024, 2048
    x = _chirp(N)
    wav = ('gmw', {'dtype': 'float32'})
    Tx, Wx, *_ = tstq.stream_ssq_cwt(x, chunk, wav, scales=_scales(64., 97),
                                     nv=None, history=ctx, lookahead=ctx,
                                     device='cpu')
    assert Tx.shape[-1] == N
    assert tstq.toolkit.mad_rms(x, tstq.issq_cwt(Tx)) < 0.1
    Tx_o, *_ = tstq.ssq_cwt(x, wav, scales=_scales(64., 97), nv=None,
                            device='cpu')
    cs, cs_o = Tx.real.sum(-2).numpy(), Tx_o.real.sum(-2).numpy()
    m = 1792
    assert (np.abs(cs[m:-m] - cs_o[m:-m]).max() / np.abs(Tx_o).max()
            < 5e-2)


def test_stream_ssq_cwt2_matches_jax():
    N, chunk = 2048, 512
    x = _chirp(N)
    kw = dict(scales=_scales(16., 25), nv=None, N=N)
    pj = js.StreamingSSQCWT2(chunk, ('gmw', {'dtype': 'float32'}), **kw)
    pt = ts.StreamingSSQCWT2(chunk, ('gmw', {'dtype': 'float32'}),
                             device='cpu', **kw)
    np.testing.assert_allclose(pt.support_np, pj.support_np, rtol=1e-12)
    Tx_j, W_j = js._drive(pj, x, chunk)
    Tx_t, W_t = ts._drive(pt, x, chunk)
    assert _rel(W_t, W_j) <= TOL['float32']
    _bins2_criterion(Tx_t, Tx_j)


def test_stream_ssq_cwt2_rejects_as_jax():
    """A non-analytic bump: both packages' plans raise the offline
    `ssq_cwt2`'s message."""
    spec = ('bump', {'mu': .5})
    with pytest.raises(NotImplementedError) as ej:
        js.StreamingSSQCWT2(512, spec, scales=_scales(), nv=None, N=2048)
    with pytest.raises(NotImplementedError) as et:
        ts.StreamingSSQCWT2(512, spec, scales=_scales(), nv=None, N=2048,
                            device='cpu')
    assert str(et.value) == str(ej.value)


# ---- STFT ------------------------------------------------------------------------
@pytest.mark.parametrize('kw', [dict(n_fft=256), dict(n_fft=256,
                                                      modulated=False),
                                dict(n_fft=255), dict(n_fft=256, fs=100.)],
                         ids=['base', 'unmodulated', 'odd', 'fs'])
def test_stream_stft_variants(kw):
    """`stream_stft`, `StreamingSTFT` and `stream_ssq_stft` against the
    JAX package's, and the port's stream against the port's offline
    `stft`/`ssq_stft` on every column (exact: chunk >= n_fft)."""
    N, chunk = 2048, 512
    x = _chirp(N)
    Sx_j = jstq.stream_stft(x, chunk, **kw)
    Sx_t = tstq.stream_stft(x, chunk, device='cpu', **kw)
    assert _rel(Sx_t, Sx_j) <= TOL['float32']
    assert _rel(Sx_t, tstq.stft(x, device='cpu', **kw)) <= 1e-5
    plan = tstq.StreamingSTFT(chunk, device='cpu', **kw)
    parts = [plan.process(x[i * chunk:(i + 1) * chunk])
             for i in range(N // chunk)] + [plan.finalize()]
    assert torch.equal(torch.cat(parts, dim=-1), Sx_t)

    Tx_j, S_j, f_j, Sfs_j = jstq.stream_ssq_stft(x, chunk, **kw)
    Tx_t, S_t, f_t, Sfs_t = tstq.stream_ssq_stft(x, chunk, device='cpu',
                                                 **kw)
    np.testing.assert_array_equal(f_t, f_j)
    np.testing.assert_array_equal(Sfs_t, Sfs_j)
    assert _rel(S_t, S_j) <= TOL['float32']
    _bins_criterion(Tx_t, Tx_j)
    Tx_o, S_o, *_ = tstq.ssq_stft(x, device='cpu', **kw)
    assert _rel(S_t, S_o) <= 1e-5
    _bins_criterion(Tx_t, Tx_o)
    if len(kw) == 1:                # issq_stft takes a modulated, fs = 1 Tx
        xr = tstq.issq_stft(Tx_t, n_fft=kw['n_fft'])
        assert tstq.toolkit.mad_rms(x, xr) < 0.05


def _double_j(W):
    return Complex(2 * W.re, 2 * W.im)


def _double_t(W):
    return 2 * W


@pytest.mark.parametrize('squeezing', ['lebesgue', 'abs', None, 'callable'])
def test_stream_ssq_stft_squeezing(squeezing):
    """Every squeezing (None is 'sum'; a function of Sx, a jnp twin for
    JAX) and flipud, in float64: Sx within 1e-9 of max, Tx by the bins
    criterion (the port runs B6's bins for each; the JAX package its
    phase transform and scatter for the non-'sum' ones). White noise, as
    `tests/test_torch_stft.py` takes for these routes: a pure chirp
    leaves cells at the rounding floor, near gamma (2e-15 in float64),
    whose gate differs between the two routes' FFTs, and 'lebesgue'
    weighs each such cell as much as a strong one."""
    N, chunk = 2048, 512
    x = np.random.default_rng(11).standard_normal(N)
    kw = dict(n_fft=128, flipud=True, dtype='float64')
    sq_j, sq_t = ((_double_j, _double_t) if squeezing == 'callable'
                  else (squeezing, squeezing))
    Tx_j, S_j, f_j, _ = jstq.stream_ssq_stft(x, chunk, squeezing=sq_j, **kw)
    Tx_t, S_t, f_t, _ = tstq.stream_ssq_stft(x, chunk, squeezing=sq_t,
                                             device='cpu', **kw)
    np.testing.assert_array_equal(f_t, f_j)
    assert S_t.dtype == torch.complex128
    assert _rel(S_t, S_j) <= TOL['float64']
    _bins_criterion(Tx_t, Tx_j)


def test_stream_ssq_stft2_matches_jax_and_offline():
    N, chunk, n_fft = 2048, 512, 256
    x = _chirp(N)
    Tx_j, S_j, f_j, Sfs_j = jstq.stream_ssq_stft2(x, chunk, n_fft=n_fft)
    Tx_t, S_t, f_t, Sfs_t = tstq.stream_ssq_stft2(x, chunk, n_fft=n_fft,
                                                  device='cpu')
    np.testing.assert_array_equal(f_t, f_j)
    np.testing.assert_array_equal(Sfs_t, Sfs_j)
    assert _rel(S_t, S_j) <= TOL['float32']
    _bins2_criterion(Tx_t, Tx_j)
    Tx_o, S_o, *_ = tstq.ssq_stft2(x, n_fft=n_fft, device='cpu')
    assert _rel(S_t, S_o) <= 1e-5
    _bins2_criterion(Tx_t, Tx_o)


# ---- a batch -------------------------------------------------------------------------
@pytest.mark.parametrize('kind', ['ssq_cwt', 'ssq_stft', 'ssq_cwt2',
                                  'ssq_stft2'])
def test_batched_stream(kind):
    """A (2, chunk) stream against the JAX plan's on the same batch, and
    each row against the port's one-signal stream of it (1e-6 of max:
    the batched plain versions run each row as a one-signal call). Both
    rows carry noise: on a pure float32 chirp at these scales the order-2
    criterion's 2% of cells fails for the JAX package against itself
    (its batch against its one-signal stream: 2.5%)."""
    N, chunk = 2048, 512
    rng = np.random.default_rng(3)
    xb = np.stack([_chirp(N) + .05 * rng.standard_normal(N),
                   rng.standard_normal(N)]).astype(np.float32)
    cls = {'ssq_cwt': 'StreamingSSQCWT', 'ssq_stft': 'StreamingSSQSTFT',
           'ssq_cwt2': 'StreamingSSQCWT2',
           'ssq_stft2': 'StreamingSSQSTFT2'}[kind]
    kw = (dict(n_fft=128) if 'stft' in kind
          else dict(scales=_scales(), nv=None, N=N))
    pj = getattr(js, cls)(chunk, **kw)
    Tx_j, W_j = js._drive(pj, xb, chunk)
    Tx_t, W_t = ts._drive(getattr(ts, cls)(chunk, device='cpu', **kw), xb,
                          chunk)
    assert W_t.shape == (2,) + W_t.shape[1:]
    assert _rel(W_t, W_j) <= TOL['float32']
    crit = _bins2_criterion if kind.endswith('2') else _bins_criterion
    for b in range(2):
        crit(Tx_t[b], _np(Tx_j)[b])
        Tx_1, W_1 = ts._drive(getattr(ts, cls)(chunk, device='cpu', **kw),
                              xb[b], chunk)
        assert _rel(W_t[b], W_1) <= 1e-6
        crit(Tx_t[b], Tx_1)


# ---- resume ------------------------------------------------------------------------------
@pytest.mark.parametrize('cls,kw', [
    ('StreamingSSQCWT', dict(scales=_scales(), nv=None, N=2048,
                             lookahead=700)),
    ('StreamingSSQSTFT', dict(n_fft=256)),
    ('StreamingSSQSTFT2', dict(n_fft=128))], ids=['cwt', 'stft', 'stft2'])
def test_jax_snapshot_resumes_in_port(cls, kw):
    """A JAX plan's `state_dict` after two chunks, loaded into a port
    plan, continues to the JAX plan's continuation (every later column
    and finalize)."""
    N, chunk = 2048, 512
    x = _chirp(N)
    pj = getattr(js, cls)(chunk, **kw)
    _feed(pj, x[:2 * chunk], chunk, finalize=False)
    pt = getattr(ts, cls)(chunk, device='cpu', **kw).load_state(
        pj.state_dict())
    rest_j = _feed(pj, x[2 * chunk:], chunk)
    rest_t = _feed(pt, x[2 * chunk:], chunk)
    assert [o[1].shape[-1] for o in rest_t] == \
        [o[1].re.shape[-1] for o in rest_j]
    assert _rel(_cat(rest_t, 1), _cat(rest_j, 1)) <= TOL['float32']
    crit = _bins2_criterion if cls.endswith('2') else _bins_criterion
    crit(_cat(rest_t, 0), _cat(rest_j, 0))


@pytest.mark.parametrize('cls,kw', [
    ('StreamingSSQCWT', dict(scales=_scales(), nv=None, N=2048)),
    ('StreamingCWT', dict(wavelet='morlet', scales=_scales(), nv=None,
                          N=2048)),
    ('StreamingSSQCWT2', dict(wavelet='cmhat', scales=_scales(), nv=None,
                              N=2048)),
    ('StreamingSSQSTFT', dict(n_fft=128, squeezing='abs')),
    ('StreamingSSQSTFT2', dict(n_fft=128))],
    ids=['ssq_cwt', 'cwt_morlet', 'ssq_cwt2_cmhat', 'ssq_stft', 'ssq_stft2'])
def test_resume_and_reset_bit_exact(cls, kw):
    """A port snapshot after chunk 2 (through numpy, as `state_dict`
    gives it), loaded into a fresh plan, continues bit for bit; `reset`
    replays the stream bit for bit; a (2, chunk) batch too."""
    N, chunk = 2048, 512
    rng = np.random.default_rng(5)
    xb = np.stack([_chirp(N), rng.standard_normal(N).astype(np.float32)])
    for x in (xb[0], xb):
        plan = getattr(ts, cls)(chunk, device='cpu', **kw)
        whole = _feed(plan, x, chunk)
        plan.reset()
        again = _feed(plan, x, chunk)
        plan.reset()
        _feed(plan, x[..., :2 * chunk], chunk, finalize=False)
        state = {k: (v.copy() if isinstance(v, np.ndarray) else v)
                 for k, v in plan.state_dict().items()}
        rest = _feed(getattr(ts, cls)(chunk, device='cpu',
                                      **kw).load_state(state),
                     x[..., 2 * chunk:], chunk)

        def same(a, b):
            if isinstance(a, tuple):
                return all(same(u, v) for u, v in zip(a, b))
            return (a is None and b is None) or torch.equal(a, b)
        assert all(same(a, b) for a, b in zip(whole, again))
        assert all(same(a, b) for a, b in zip(whole[2:], rest))


# ---- port-only checks -------------------------------------------------------------------
def test_plans_default_to_cuda_and_raise_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only "
                    "machine's refusal")
    for make in (lambda: tstq.StreamingSSQCWT(512, scales=_scales(),
                                              nv=None),
                 lambda: tstq.StreamingCWT(512, scales=_scales(), nv=None),
                 lambda: tstq.StreamingSSQCWT2(512, scales=_scales(),
                                               nv=None),
                 lambda: tstq.StreamingSSQSTFT(512),
                 lambda: tstq.StreamingSSQSTFT2(512),
                 lambda: tstq.StreamingSTFT(512),
                 lambda: tstq.StreamingMultirateSSQCWT(512, scales=_scales(),
                                                       nv=None),
                 lambda: tstq.stream_stft(_chirp(1024), 512)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


# the plan builders of the streaming modules (the route's predicates among
# them, and the table/window builders the kernels' wrappers reach): none
# may run once a plan streams
_BUILDERS = [
    ('ssqueezepy_tpu_torch.streaming', n) for n in (
        '_ssq_cwt_plan', 'stft_plan', '_natural_bins', 'stft_tables',
        'fsst2_tables', '_fsst2_bank', 'wavelet_table', 'reflect_index',
        '_pad_index', 'cwt_kernel_fits', 'stft_kernel_fits', 'scatter_fits',
        'time_resolution', 'resolve_wavelet', '_device_consts',
        '_supports_order2')] + [
    ('ssqueezepy_tpu_torch.streaming_multirate', n) for n in (
        'halfband_fir', 'wavelet_table', '_pad_index', 'cwt_kernel_fits')] + [
    ('ssqueezepy_tpu_torch.models.ssq_cwt', 'process_scales'),
    ('ssqueezepy_tpu_torch.models.cwt', 'wavelet_table'),
    ('ssqueezepy_tpu_torch.ops.cwt_cuda', 'wavelet_table'),
    ('ssqueezepy_tpu_torch.ops.stft_conv', '_build_table'),
    ('ssqueezepy_tpu_torch.ops.pad', '_pad_index')]


@pytest.mark.parametrize('make', [
    lambda: tstq.StreamingSSQCWT(256, 'cmhat', scales=_scales(), nv=None,
                                 N=2048, device='cpu'),
    lambda: tstq.StreamingCWT(256, 'hhhat', N=2048, device='cpu'),
    lambda: tstq.StreamingSSQCWT2(256, 'cmhat', scales=_scales(), nv=None,
                                  N=2048, device='cpu'),
    lambda: tstq.StreamingSSQSTFT(256, n_fft=64, device='cpu'),
    lambda: tstq.StreamingSSQSTFT2(256, n_fft=64, device='cpu'),
    lambda: tstq.StreamingMultirateSSQCWT(256, 'cmhat',
                                          scales=_scales(256., 41),
                                          nv=None, N=2048, device='cpu')],
    ids=['ssq_cwt_cmhat', 'cwt_hhhat', 'ssq_cwt2_cmhat', 'ssq_stft',
         'ssq_stft2', 'multirate_cmhat'])
def test_no_plan_constant_rebuilt_per_chunk(make, monkeypatch):
    """Count every plan builder's calls: none after the plan is made (the
    wavelet tables included: a plan passes its own to the kernels), and
    the FIR taps' device memo does not grow after the first chunk."""
    from importlib import import_module
    from ssqueezepy_tpu_torch.ops import multirate
    counts = {}
    for mod, name in _BUILDERS:
        m = import_module(mod)
        orig = getattr(m, name)

        def counted(*a, _orig=orig, _key=(mod, name), **k):
            counts[_key] = counts.get(_key, 0) + 1
            return _orig(*a, **k)
        monkeypatch.setattr(m, name, counted)
    plan = make()
    x = _chirp(8 * 256)
    assert plan.process(x[:256]) is not None
    made, taps = dict(counts), len(multirate._FIR)
    for i in range(1, 8):
        plan.process(x[i * 256:(i + 1) * 256])
    plan.finalize()
    assert counts == made
    assert len(multirate._FIR) == taps


def test_port_imports_no_jax():
    """Every module of the port (and `chip_smoke.py`) imports with `jax`
    and `ssqueezepy_tpu` blocked."""
    code = r"""
import importlib, pkgutil, sys
sys.modules['jax'] = None
sys.modules['ssqueezepy_tpu'] = None
import ssqueezepy_tpu_torch as p
names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]
for n in names:
    importlib.import_module(n)
import chip_smoke
assert 'jax' not in {m.split('.')[0] for m in sys.modules if sys.modules[m]}
print(len(names))
"""
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, '-c', code], cwd=root,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 30


SIGS = ['StreamingSSQCWT', 'StreamingSSQCWT2', 'StreamingCWT',
        'StreamingSSQSTFT', 'StreamingSSQSTFT2', 'StreamingSTFT',
        'stream_ssq_cwt', 'stream_cwt', 'stream_ssq_stft',
        'stream_ssq_stft2', 'stream_stft', 'StreamingMultirateSSQCWT']


@pytest.mark.parametrize('name', SIGS)
def test_signature_matches_jax(name):
    """The JAX package's parameter names, positions and defaults; the
    port's `device` last where the signature has a place for it (a
    signature ending in ``**kw`` takes it there), as
    `tests/test_torch_api.py` checks the low-level API."""
    jobj, tobj = getattr(jstq, name), getattr(tstq, name)
    if inspect.isclass(jobj):
        jobj, tobj = jobj.__init__, tobj.__init__
    jsig = inspect.signature(jobj).parameters
    tsig = inspect.signature(tobj).parameters
    tnames = [n for n in tsig if n != 'device']
    assert tnames == list(jsig)
    var_kw = list(jsig.values())[-1].kind == inspect.Parameter.VAR_KEYWORD
    assert list(tsig)[-1] == (tnames[-1] if var_kw else 'device')
    for n in jsig:
        assert tsig[n].default == jsig[n].default, n
        assert tsig[n].kind == jsig[n].kind, n
    if not var_kw:
        assert tsig['device'].default == 'cuda'


def test_cwt_wrappers_take_a_plans_table():
    """The CWT wrappers' `table` (a streaming plan's own wavelet table)
    gives their results without it bit for bit, on each mode the plans
    run; a table of another shape, dtype or layout raises."""
    from ssqueezepy_tpu_torch.models.cwt import resolve_wavelet
    from ssqueezepy_tpu_torch.ops.cwt_cuda import (cwt_bins, cwt_bins2,
                                                   cwt_fused, wavelet_table)
    from ssqueezepy_tpu_torch.ops.ssq_kernels import ssq_bin_params
    wv = resolve_wavelet('cmhat')
    n_up, n1, N = 256, 40, 150
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(n_up)
                        .astype(np.float32))
    xh = torch.fft.rfft(x).contiguous()
    sc = torch.as_tensor(np.geomspace(1., 16., 9), dtype=torch.float32)
    params = ssq_bin_params(np.geomspace(.01, .4, 9), True)
    t1 = wavelet_table(wv, sc, n_up)
    t3 = wavelet_table(wv, sc, n_up, order2=True)
    runs = [
        (lambda t: cwt_bins(xh, sc, wv, n_up, n1, N, 1., True, params, 1e-6,
                            True, t), t1),
        (lambda t: cwt_fused(xh, sc, wv, n_up, n1, N, 1., True, True, t), t1),
        (lambda t: cwt_bins2(xh, sc, wv, n_up, n1, N, 1., params, 1e-6,
                             True, t), t3)]
    for run, table in runs:
        for a, b in zip(run(None), run(table)):
            assert torch.equal(a, b)
    for bad in (t3, t1[:-1], t1.double(), t1.t().contiguous().t()):
        with pytest.raises(ValueError, match='wavelet table'):
            runs[0][0](bad)
