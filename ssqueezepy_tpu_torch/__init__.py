# -*- coding: utf-8 -*-
"""ssqueezepy_tpu_torch — the PyTorch/CUDA port of ssqueezepy_tpu.

Synchrosqueezed CWT and STFT (`ssq_cwt`, `ssq_stft`) with their inverses,
their second-order forms (`ssq_cwt2`, `ssq_stft2`), the CWT (`cwt`,
`icwt`), the STFT (`stft`, `istft`) and the reassignment from a transform
and its derivative (`ssqueeze`, `ssqueeze_fast`) on an NVIDIA Hopper
card: the fused CWT kernels, the STFT table kernel, the reassignment
scatter and the fused phase + bins + scatter kernel are hand-written CUDA
(`csrc/`), built with nvcc at first use on a CUDA tensor. Entry points run on ``device='cuda'`` unless
the caller passes ``device='cpu'``, which runs the kernels' plain PyTorch
versions. The package imports torch, numpy and scipy — never JAX, and
nothing of `ssqueezepy_tpu`.
"""
from . import toolkit
from .models.cwt import cwt, icwt
from .models.ssq_cwt import ssq_cwt, issq_cwt
from .models.ssq_cwt2 import ssq_cwt2
from .models.ssq_stft import ssq_stft, issq_stft, ssq_stft2
from .models.ssqueezing import ssqueeze
from .models.stft import stft, istft
from .models.wavelets import Wavelet
from .models.windows import get_window
from .ops.ssq_kernels import ssqueeze_fast
from .utils.cwt_utils import process_scales, make_scales, adm_cwt, adm_ssq

__all__ = ['ssq_cwt', 'issq_cwt', 'ssq_stft', 'issq_stft', 'ssq_cwt2',
           'ssq_stft2', 'cwt', 'icwt', 'stft', 'istft', 'ssqueeze',
           'ssqueeze_fast', 'get_window',
           'Wavelet', 'process_scales', 'make_scales', 'adm_cwt', 'adm_ssq',
           'toolkit']
