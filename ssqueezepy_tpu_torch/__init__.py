# -*- coding: utf-8 -*-
"""ssqueezepy_tpu_torch — the PyTorch/CUDA port of ssqueezepy_tpu.

Synchrosqueezed CWT (`ssq_cwt`) and its inverse (`issq_cwt`) on an NVIDIA
Hopper card: the fused CWT + bin-map kernel and the reassignment scatter
are hand-written CUDA (`csrc/`), built with nvcc at first use on a CUDA
tensor. Entry points run on ``device='cuda'`` unless the caller passes
``device='cpu'``, which runs the kernels' plain PyTorch versions. The
package imports torch, numpy and scipy — never JAX, and nothing of
`ssqueezepy_tpu`.
"""
from . import toolkit
from .models.ssq_cwt import ssq_cwt, issq_cwt
from .models.wavelets import Wavelet
from .utils.cwt_utils import process_scales

__all__ = ['ssq_cwt', 'issq_cwt', 'Wavelet', 'process_scales', 'toolkit']
