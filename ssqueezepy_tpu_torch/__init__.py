# -*- coding: utf-8 -*-
"""ssqueezepy_tpu_torch — the PyTorch/CUDA port of ssqueezepy_tpu.

Synchrosqueezed CWT and STFT (`ssq_cwt`, `ssq_stft`) with their inverses,
their second-order forms (`ssq_cwt2`, `ssq_stft2`), the CWT (`cwt`,
`icwt`) and the STFT (`stft`, `istft`) on an NVIDIA Hopper card: the
fused CWT kernels, the STFT table kernel and the reassignment scatter are
hand-written CUDA (`csrc/`), built with nvcc at first use on a CUDA
tensor. Entry points run on ``device='cuda'`` unless
the caller passes ``device='cpu'``, which runs the kernels' plain PyTorch
versions. The package imports torch, numpy and scipy — never JAX, and
nothing of `ssqueezepy_tpu`.
"""
from . import toolkit
from .models.cwt import cwt, icwt
from .models.ssq_cwt import ssq_cwt, issq_cwt
from .models.ssq_cwt2 import ssq_cwt2
from .models.ssq_stft import ssq_stft, issq_stft, ssq_stft2
from .models.stft import stft, istft
from .models.wavelets import Wavelet
from .models.windows import get_window
from .utils.cwt_utils import process_scales, make_scales, adm_cwt, adm_ssq

__all__ = ['ssq_cwt', 'issq_cwt', 'ssq_stft', 'issq_stft', 'ssq_cwt2',
           'ssq_stft2', 'cwt', 'icwt', 'stft', 'istft', 'get_window',
           'Wavelet', 'process_scales', 'make_scales', 'adm_cwt', 'adm_ssq',
           'toolkit']
