# -*- coding: utf-8 -*-
"""Fixture shared by the port's tests that call the JAX package: each case
holds the port against the JAX package's XLA path, deterministically, and
leaves the JAX package as it found it.

Before each case it resets the JAX package's config (a test that left
`pallas_interpret` or `backend='tpu'` set would switch the reference to
its interpret-mode Pallas kernels, whose bf16x3 products differ from the
XLA path by ~2e-5), checks that no Pallas kernel is enabled, and drops
JAX's compiled-program caches, so that no program compiled for a call of
another test in the same worker can answer for the reference here.

Before and after each case it also drops the tracers that the JAX
package's device-scalar memo (`ssqueezepy_tpu/models/cwt.py::
_device_scalar`) keeps when its first call for a value comes from inside
a jit trace, as the framed path of `ssq_stft` makes it: a later program
that closes over such a tracer fails on its second call ("Execution
supplied 1 buffers but compiled program expected 3 buffers"), so
whichever test first reaches it, in this file or another, fails. It also
points the port's plan cache on disk at the case's `tmp_path`. Import
the fixture into a test module with ``from torch_jax_reference import
xla_reference``.
"""
import jax
import pytest

from ssqueezepy_tpu.configs import backend, reset_config
from ssqueezepy_tpu.models import cwt as jax_cwt
from ssqueezepy_tpu.ops.ssq_kernels import _pallas_enabled

__all__ = ['xla_reference']


def _drop_leaked_tracers():
    memo = jax_cwt._SCALAR_DEV_CACHE
    for key in [k for k, v in memo.items() if isinstance(v, jax.core.Tracer)]:
        del memo[key]


@pytest.fixture(autouse=True)
def xla_reference(monkeypatch, tmp_path):
    # the port's plan memo on disk (ssqueezepy_tpu_torch/utils/
    # plan_cache.py) writes under the case's own directory, never to ~
    monkeypatch.setenv('SSQ_TPU_TORCH_CACHE', str(tmp_path / 'plans'))
    reset_config()
    assert backend() == 'cpu' and _pallas_enabled() == (False, False)
    jax.clear_caches()
    _drop_leaked_tracers()
    yield
    _drop_leaked_tracers()
    reset_config()
