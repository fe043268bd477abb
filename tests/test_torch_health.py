# -*- coding: utf-8 -*-
"""The port's failure detection (`ssqueezepy_tpu_torch.parallel.health`)
and the streaming plans' checkpoint and resume, the port's counterparts
of `tests/test_health.py`.

The heartbeat runs for real on gloo ranks on the CPU
(`tests/torch_dist_worker.py::health_world`): two beats on a live world of
two; then rank 1 stalls through two of rank 0's beats, which trips rank
0's monitor (max_failures=2), and issues them late, after which a beat on
both ranks succeeds and re-arms the monitor. The monitor's thread beats
on a world of one. The consecutive-failure logic runs on an injected
heartbeat, as in the JAX package's test, and `HealthMonitor.EXIT` calls
`os._exit(42)`. The streaming plans resume bit for bit from a
`state_dict` in a fresh plan, and their columns agree with the JAX
package's plans (Wx/Sx within 1e-5 of max, Tx by the bins criterion).
"""
import os

import numpy as np
import pytest
import torch

from ssqueezepy_tpu import streaming as js

from ssqueezepy_tpu_torch import streaming as ts
from ssqueezepy_tpu_torch.parallel import HealthMonitor
from ssqueezepy_tpu_torch.parallel.distributed import spawn
from torch_jax_reference import xla_reference  # noqa: F401
import torch_dist_worker as w


def _np(c):
    if isinstance(c, torch.Tensor):
        return c.detach().cpu().numpy()
    if hasattr(c, 're'):
        return np.asarray(c.re) + 1j * np.asarray(c.im)
    return np.asarray(c)


def rel(a, b):
    a, b = _np(a), _np(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def bins_criterion(Tx, ref):
    Tx, ref = _np(Tx), _np(ref)
    m = max(np.abs(ref).max(), 1e-9)
    assert np.abs(Tx.sum(-2) - ref.sum(-2)).max() < 1e-4 * m
    e, e_ref = np.abs(Tx).sum(), np.abs(ref).sum()
    assert abs(e - e_ref) / e_ref < 5e-3


@pytest.fixture(scope='module')
def health():
    return spawn(w.health_world, 2, timeout=120.)[0]


def test_heartbeat_completes_on_live_mesh(health):
    for ok, dt in health['live']:
        assert ok and dt is not None and dt >= 0


def test_injected_stall_trips_monitor(health):
    """A rank that misses two beats trips its peer's monitor once; the
    beats it issues late complete, and the next beat re-arms it."""
    assert health['stalled'] == [False, False]
    assert health['tripped'] == [2]
    assert health['recovered']
    assert health['after'] == (0, False, True)


def test_monitor_thread_start_stop():
    beats, failures = spawn(w.monitor_world, 1, timeout=120.)[0]
    assert beats >= 1 and failures == 0


def test_monitor_trips_after_consecutive_failures():
    calls = {'beats': [], 'failed': []}
    # two timeouts, then healthy: with max_failures=3 no trip (the count
    # resets on a success)
    seq = [(False, None), (False, None), (True, 0.01), (False, None),
           (False, None), (False, None)]

    def hb():
        out = seq[len(calls['beats'])]
        calls['beats'].append(out)
        return out

    mon = HealthMonitor(None, interval=999, timeout=0.1, max_failures=3,
                        on_failure=lambda m: calls['failed'].append(
                            m.failures), heartbeat=hb)
    for _ in range(3):
        mon.poll_once()
    assert not calls['failed'] and mon.failures == 0
    assert mon.last_latency == 0.01
    for _ in range(3):
        mon.poll_once()
    assert calls['failed'] == [3] and mon.tripped
    # the trip fires once, not per further failure
    seq.append((False, None))
    mon.poll_once()
    assert calls['failed'] == [3]
    # a healthy beat re-arms it: a second outage fires again
    seq.extend([(True, 0.02), (False, None), (False, None), (False, None)])
    for _ in range(4):
        mon.poll_once()
    assert calls['failed'] == [3, 3] and mon.tripped


def test_exit_ends_the_process_with_status_42(monkeypatch):
    codes = []
    monkeypatch.setattr(os, '_exit', codes.append)
    mon = HealthMonitor(None, max_failures=1, on_failure=HealthMonitor.EXIT,
                        heartbeat=lambda: (False, None))
    mon.poll_once()
    assert codes == [42]


def _stream(plan, x, chunk, i0, i1):
    return [plan.process(x[i * chunk:(i + 1) * chunk]) for i in range(i0, i1)]


def test_streaming_checkpoint_resume():
    """Kill and restore: a snapshot taken mid-stream, loaded into a fresh
    plan of the same arguments, continues bit for bit; the columns agree
    with the JAX package's plan."""
    chunk, Nn = 512, 2048
    x = np.random.default_rng(11).standard_normal(Nn).astype(np.float32)
    sc = np.geomspace(1., 16., 33).reshape(-1, 1)
    kw = dict(scales=sc, nv=None, N=Nn, history=512, lookahead=512)

    a = ts.StreamingSSQCWT(chunk, w.G32, device='cpu', **kw)
    _stream(a, x, chunk, 0, 2)
    snap = a.state_dict()
    b = ts.StreamingSSQCWT(chunk, w.G32, device='cpu', **kw)
    b.load_state(snap)
    outs = []
    for (ta, wa), (tb, wb) in zip(_stream(a, x, chunk, 2, 4),
                                  _stream(b, x, chunk, 2, 4)):
        assert torch.equal(ta, tb) and torch.equal(wa, wb)
        outs.append((ta, wa))
    fa, fb = a.finalize(), b.finalize()
    assert torch.equal(fa[0], fb[0]) and torch.equal(fa[1], fb[1])

    j = js.StreamingSSQCWT(chunk, w.G32, **kw)
    jouts = _stream(j, x, chunk, 0, 4)[2:]
    for (tp, wp), (tj, wj) in zip(outs + [fa], jouts + [j.finalize()]):
        assert rel(wp, wj) < 1e-5
        bins_criterion(tp, tj)


def test_streaming_stft_checkpoint_resume():
    chunk = 512
    x = np.random.default_rng(3).standard_normal(2048).astype(np.float32)
    a = ts.StreamingSSQSTFT(chunk, n_fft=128, dtype='float32', device='cpu')
    _stream(a, x, chunk, 0, 2)
    snap = a.state_dict()
    b = ts.StreamingSSQSTFT(chunk, n_fft=128, dtype='float32', device='cpu')
    b.load_state(snap)
    j = js.StreamingSSQSTFT(chunk, n_fft=128, dtype='float32')
    jouts = _stream(j, x, chunk, 0, 4)[2:]
    for (ta, sa), (tb, sb), (tj, sj) in zip(_stream(a, x, chunk, 2, 4),
                                             _stream(b, x, chunk, 2, 4),
                                             jouts):
        assert torch.equal(ta, tb) and torch.equal(sa, sb)
        assert rel(sa, sj) < 1e-5
        bins_criterion(ta, tj)
