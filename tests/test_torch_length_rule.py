# -*- coding: utf-8 -*-
"""The kernels' rules on lengths and bins, on the CPU (no JAX, no card):

  * `ops/cwt_cuda.py::cwt_length_rule`, `ops/stft_cuda.py::
    stft_length_rule` and `ops/ssq_cuda.py::scatter_rule` at their
    boundaries, in float32 and float64 and for 1, 2 and 5 planes: the
    largest length (bins) that passes and the next one, which raises
    naming ROADMAP.md queue C, C1b;
  * the public calls past a ceiling raise that error on `device='cpu'`
    before any FFT runs (the FFTs are replaced by a function that fails),
    with a tiny scales array so that nothing large is allocated;
  * the main path's plans are the ones before the radix-4 engine's
    column limit was raised to `_SMEM_MAX`: `bins_plan` at n_up = 262144
    and 160000 and `launch_plan` at Np2 = 163840, for every plane count.

The CWT kernel's shared memory per stage is L/2 twiddles and planes * P
sequences of L + 1 elements (radix 4), L twiddles and two such buffers
(mixed); the STFT kernel's L twiddles and two buffers. One column may
take up to 220 KB.
"""
import numpy as np
import pytest
import torch

import ssqueezepy_tpu_torch as tstq
from ssqueezepy_tpu_torch.ops import cwt_cuda, ssq_cuda, stft_cuda
from ssqueezepy_tpu_torch.ops.cwt_cuda import bins_plan, cwt_length_rule
from ssqueezepy_tpu_torch.ops.ssq_cuda import scatter_rule
from ssqueezepy_tpu_torch.ops.stft_cuda import launch_plan, stft_length_rule

C1B = 'ROADMAP.md queue C, C1b'
ITEMSIZE = {'float32': 8, 'float64': 16}

# the largest power-of-two n_up the radix-4 engine takes, by (dtype,
# planes): the one column of stage 1, f1 = 2^ceil(lg / 2), within 220 KB
CWT_MAX_LG = {('float32', 1): 28, ('float32', 2): 26, ('float32', 5): 24,
              ('float64', 1): 26, ('float64', 2): 24, ('float64', 5): 22}


def test_smem_limits():
    assert cwt_cuda._SMEM_MAX == stft_cuda._SMEM_MAX == 220 * 1024
    assert cwt_cuda._SMEM_BUDGET == 96 * 1024
    assert ssq_cuda._SMEM_BUDGET == 200 * 1024


@pytest.mark.parametrize('planes', [1, 2, 5])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_cwt_rule_boundary(dtype, planes):
    itemsize = ITEMSIZE[dtype]
    lg = CWT_MAX_LG[(dtype, planes)]
    f1 = 1 << ((lg + 1) // 2)
    assert (f1 // 2 + planes * (f1 + 1)) * itemsize <= 220 * 1024
    plan = cwt_length_rule(1 << lg, itemsize, planes)
    assert (plan.f1, plan.P1, plan.S1) == (f1, 1, f1 + 1)
    assert plan.engine == cwt_cuda._ENGINE_RADIX4
    with pytest.raises(NotImplementedError, match=C1B):
        cwt_length_rule(1 << (lg + 1), itemsize, planes)
    # a length whose prime factors pass 7 raises first, naming the
    # general path that the public calls take for it
    with pytest.raises(NotImplementedError, match='general path'):
        cwt_length_rule(11 << 10, itemsize, planes)


def test_cwt_rule_mixed_engine():
    """The mixed engine keeps its own column limit: order 2 in float64
    fails at n_up = 2,000,000 (factor 1600) and two planes at 10^7;
    float32 order 2 takes 2,000,000."""
    with pytest.raises(NotImplementedError, match=C1B):
        cwt_length_rule(2000000, 16, 5)
    with pytest.raises(NotImplementedError, match=C1B):
        cwt_length_rule(10 ** 7, 16, 2)
    plan = cwt_length_rule(2000000, 8, 5)
    assert plan.engine == cwt_cuda._ENGINE_MIXED and plan.f1 == 1600


def _stft_lengths():
    return sorted(odd << lg for lg in range(24) for odd in (1, 3, 5, 9, 15)
                  if 4 <= odd << lg)


def _stft_fits(n, itemsize, planes):
    """One column of either stage within 220 KB, n within [4, 2^22]."""
    f1, f2 = stft_cuda.split_fft_len(n)
    return all((L + 2 * planes * (L | 1)) * itemsize <= 220 * 1024
               for L in (f1, f2))


@pytest.mark.parametrize('planes', [1, 2, 5])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_stft_rule_boundary(dtype, planes):
    """2^22 for every plane count but order 2 in float64, whose largest
    length is 1179648 = 9 x 2^17 (1310720 = 5 x 2^18 raises)."""
    itemsize = ITEMSIZE[dtype]
    top = 1179648 if (dtype, planes) == ('float64', 5) else 1 << 22
    lens = _stft_lengths()
    nxt = lens[lens.index(top) + 1]
    assert nxt == (1310720 if top < 1 << 22 else 9 << 19)
    assert top <= 1 << 22 and _stft_fits(top, itemsize, planes)
    plan = stft_length_rule(top, itemsize, planes)
    assert plan.f1 * plan.f2 == top
    with pytest.raises(NotImplementedError, match=C1B):
        stft_length_rule(nxt, itemsize, planes)
    # every length below the largest passes
    for n in lens[:lens.index(top)]:
        stft_length_rule(n, itemsize, planes)


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_scatter_rule_boundary(dtype):
    itemsize = ITEMSIZE[dtype]
    top = 200 * 1024 // itemsize
    assert top == {'float32': 25600, 'float64': 12800}[dtype]
    scatter_rule(top, itemsize)
    with pytest.raises(NotImplementedError, match=C1B):
        scatter_rule(top + 1, itemsize)


@pytest.fixture
def no_fft(monkeypatch):
    """Every FFT a public call could run fails the test."""
    def boom(*args, **kwargs):
        raise AssertionError("an FFT ran before the length rule")
    for name in ('fft', 'rfft', 'ifft', 'irfft'):
        monkeypatch.setattr(torch.fft, name, boom)


def _x(N, dtype):
    return np.ones(N, dtype=dtype)


@pytest.mark.parametrize('case', [
    # order 2 in float64, padded: n_up = 2^23 > 2^22
    ('ssq_cwt2', 3000000, 'float64', dict(padtype='reflect')),
    # order 2 in float64 unpadded, the mixed engine: n_up = 2,000,000
    ('ssq_cwt2', 2000000, 'float64', dict(padtype=None)),
    # two planes in float64, unpadded: n_up = 10^7
    ('ssq_cwt', 10 ** 7, 'float64', dict(padtype=None)),
    # hop-1 STFT past 2^22: Np2 = next_fft_len(N + n_fft - 1)
    ('ssq_stft', 1 << 22, 'float32', dict(n_fft=64)),
    ('stft', 1 << 22, 'float32', dict(n_fft=64)),
    # order 2 STFT in float64 past 1179648
    ('ssq_stft2', 1200000, 'float64', dict(n_fft=64)),
    # the scatters' bins: n_fft // 2 + 1 = 25601 > 25600 in float32
    ('ssq_stft', 4096, 'float32', dict(n_fft=51200, window='hann')),
], ids=lambda c: '%s-%d-%s-%s' % (c[0], c[1], c[2], '-'.join(
    '%s=%s' % kv for kv in c[3].items() if kv[0] != 'window')))
def test_public_calls_raise_before_any_fft(no_fft, case):
    name, N, dtype, kw = case
    kw = dict(kw)
    if name in ('ssq_cwt2', 'ssq_cwt'):
        kw.update(wavelet=('gmw', {'dtype': dtype}),
                  scales=2. ** (2 + np.arange(8) / 4))
    else:
        kw.update(dtype=dtype)
    with pytest.raises(NotImplementedError, match=C1B):
        getattr(tstq, name)(_x(N, dtype), device='cpu', **kw)


@pytest.mark.parametrize('itemsize', [8, 16])
def test_main_path_plans_unchanged(itemsize):
    """(f1, f2, P1, P2, S1, S2, sw1, sw2, smem1, smem2, engine) of the CWT
    kernel at n_up = 262144 (radix 4) and 160000 (mixed), and the STFT
    kernel's (f1, f2, direct, P1, P2, S1, S2, sw1, sw2, smem1, smem2) at
    Np2 = 163840, for 1, 2 and 5 planes: as before the column limit of
    the radix-4 engine was raised."""
    cwt = {
        (262144, 8): [(512, 512, 8, 8, 513, 513, 4, 4, 34880, 34880, 0),
                      (512, 512, 8, 8, 513, 513, 4, 4, 67712, 67712, 0),
                      (512, 512, 4, 4, 513, 513, 4, 4, 84128, 84128, 0)],
        (262144, 16): [(512, 512, 8, 8, 513, 513, 3, 3, 69760, 69760, 0),
                       (512, 512, 4, 4, 513, 513, 3, 3, 69760, 69760, 0),
                       (512, 512, 2, 2, 513, 513, 3, 3, 86176, 86176, 0)],
        (160000, 8): [(400, 400, 8, 8, 401, 401, 4, 4, 54528, 54528, 1),
                      (400, 400, 4, 4, 401, 401, 4, 4, 54528, 54528, 1),
                      (400, 400, 2, 2, 401, 401, 4, 4, 67360, 67360, 1)],
        (160000, 16): [(400, 400, 4, 4, 401, 401, 3, 3, 57728, 57728, 1),
                       (400, 400, 2, 2, 401, 401, 3, 3, 57728, 57728, 1),
                       (400, 400, 1, 1, 401, 401, 3, 3, 70560, 70560, 1)]}
    stft = {
        8: [(320, 512, True, 8, 8, 321, 513, 4, 4, 43648, 69760),
            (320, 512, True, 4, 4, 321, 513, 4, 4, 43648, 69760),
            (320, 512, False, 4, 2, 321, 513, 4, 4, 105280, 86176)],
        16: [(320, 512, True, 8, 4, 321, 513, 3, 3, 87296, 73856),
             (320, 512, True, 4, 2, 321, 513, 3, 3, 87296, 73856),
             (320, 512, False, 2, 1, 321, 513, 3, 3, 107840, 90272)]}
    for q, planes in enumerate((1, 2, 5)):
        for n_up in (262144, 160000):
            assert tuple(bins_plan(n_up, itemsize, planes)) == \
                cwt[(n_up, itemsize)][q]
            assert cwt_length_rule(n_up, itemsize, planes) == \
                bins_plan(n_up, itemsize, planes)
        assert tuple(launch_plan(163840, itemsize, planes)) == \
            stft[itemsize][q]


def test_not_ported_names_the_queue_of_its_item():
    from ssqueezepy_tpu_torch.utils.common import not_ported
    for item, queue in (('A8b', 'A'), ('B4', 'B'), ('C1b', 'C')):
        with pytest.raises(NotImplementedError,
                           match='ROADMAP.md queue %s, %s' % (queue, item)):
            not_ported("x", item)
