# -*- coding: utf-8 -*-
"""The headline plan of `bench.py` — `process_scales('log-piecewise',
160000, gmw)[:300]` and its ssq frequency grid — is identical in the
PyTorch port and the JAX package, and has the geometry the port's
kernels are sized for (chip_smoke.py checks the same numbers on the
card)."""
import numpy as np

from ssqueezepy_tpu.models.wavelets import Wavelet as JWavelet
from ssqueezepy_tpu.utils.cwt_utils import process_scales as jprocess
from ssqueezepy_tpu.models.ssqueezing import \
    _compute_associated_frequencies as jfreqs

from ssqueezepy_tpu_torch.convert import plan_from_numpy
from ssqueezepy_tpu_torch.models.wavelets import Wavelet
from ssqueezepy_tpu_torch.utils.cwt_utils import process_scales
from ssqueezepy_tpu_torch.models.ssqueezing import \
    _compute_associated_frequencies
from ssqueezepy_tpu_torch.ops.pad import pad_params


def test_bench_plan_160k_identical():
    N = 160000
    spec = ('gmw', {'dtype': 'float32'})
    wj, wt = JWavelet(spec), Wavelet(spec)
    sj = jprocess('log-piecewise', N, wj)[:300]
    st = process_scales('log-piecewise', N, wt)[:300]
    assert np.array_equal(st, sj)
    fj = jfreqs(sj, N, wj, 'log-piecewise', maprange='peak',
                was_padded=True, dt=1, transform='cwt')
    ft = _compute_associated_frequencies(st, N, wt, 'log-piecewise',
                                         maprange='peak', was_padded=True,
                                         dt=1, transform='cwt')
    assert np.array_equal(ft, fj)
    plan = plan_from_numpy(st, ft, spec, N)
    assert len(st) == 293 and plan['params']['omax'] + 1 == 293
    assert plan['params']['mode'] == 'log-piecewise'
    assert pad_params(N, 'reflect') == (262144, 51072, 51072)
