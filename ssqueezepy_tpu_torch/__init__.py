# -*- coding: utf-8 -*-
"""ssqueezepy_tpu_torch — the PyTorch/CUDA port of ssqueezepy_tpu.

Synchrosqueezed CWT and STFT (`ssq_cwt`, `ssq_stft`) with their inverses,
their second-order forms (`ssq_cwt2`, `ssq_stft2`), the CWT (`cwt`,
`icwt`), the STFT (`stft`, `istft`) and the reassignment from a transform
and its derivative or from a phase transform (`ssqueeze`,
`ssqueeze_fast`, `indexed_sum_onfly`, with `phase_cwt`, `phase_stft`),
with every wavelet (GMW of any order, morlet, bump, cmhat, hhhat, a
function of a torch tensor) and the higher-order CWT, and their
streaming forms (`StreamingSSQCWT`, `StreamingCWT`, `StreamingSSQCWT2`,
`StreamingSSQSTFT`, `StreamingSTFT`, `StreamingSSQSTFT2`,
`StreamingMultirateSSQCWT` and `stream_*`: chunk by chunk in
overlap-save form on the same kernels, with a carry state that can be
saved and resumed) and their sharded forms over several ranks
(`parallel`: scale-, batch-, time- and three-axis-sharded plans on
`torch.distributed`), and the analysis layer (`extract_ridges`,
`TestSignals`, `experimental`'s scale <-> frequency maps and
`phase_ssqueeze`, `toolkit`), on an NVIDIA Hopper card: the fused CWT
kernels, the STFT table kernel, the reassignment scatters (from bins, and
the generic one), the fused phase + bins + scatter kernel and the ridge
dynamic program are hand-written CUDA (`csrc/`), built with nvcc at first use on a CUDA tensor. Entry points
and plans run on ``device='cuda'`` unless the caller passes
``device='cpu'``, which runs the kernels' plain PyTorch versions. The package imports torch, numpy and scipy — never JAX, and
nothing of `ssqueezepy_tpu`.
"""
from . import toolkit
from .models.cwt import cwt, icwt, cwt_higher_order
from .models.gmw import gmw, compute_gmw, morsewave, morsefreq
from .models.ssq_cwt import ssq_cwt, issq_cwt
from .models.ssq_cwt2 import ssq_cwt2
from .models.ssq_stft import ssq_stft, issq_stft, ssq_stft2
from .models.ssqueezing import ssqueeze
from .models.ridge_extraction import extract_ridges
from .models.test_signals import TestSignals
from .models.stft import stft, istft
from .models.wavelets import (Wavelet, morlet, bump, cmhat, hhhat,
                              center_frequency, freq_resolution,
                              time_resolution)
from .ops.diff import trigdiff
from .models.windows import get_window
from .ops.phase import phase_cwt, phase_stft
from .ops.ssq_kernels import (ssqueeze_fast, indexed_sum_onfly, indexed_sum,
                              find_closest)
from .utils.cwt_utils import process_scales, make_scales, adm_cwt, adm_ssq
from .streaming import (StreamingSSQCWT, StreamingSSQCWT2, StreamingCWT,
                        StreamingSSQSTFT, StreamingSSQSTFT2,
                        StreamingSTFT, stream_ssq_cwt, stream_cwt,
                        stream_ssq_stft, stream_ssq_stft2, stream_stft)
from .streaming_multirate import StreamingMultirateSSQCWT
from . import parallel
from . import experimental
from .models import ridge_extraction

__all__ = ['ssq_cwt', 'issq_cwt', 'ssq_stft', 'issq_stft', 'ssq_cwt2',
           'ssq_stft2', 'cwt', 'icwt', 'cwt_higher_order', 'stft', 'istft',
           'ssqueeze', 'ssqueeze_fast', 'indexed_sum_onfly', 'indexed_sum',
           'find_closest', 'phase_cwt', 'phase_stft', 'trigdiff',
           'get_window', 'Wavelet', 'morlet', 'bump', 'cmhat', 'hhhat',
           'gmw', 'center_frequency', 'freq_resolution', 'time_resolution',
           'compute_gmw', 'morsewave', 'morsefreq', 'process_scales',
           'make_scales', 'adm_cwt', 'adm_ssq', 'toolkit',
           'StreamingSSQCWT', 'StreamingSSQCWT2', 'StreamingCWT',
           'StreamingSSQSTFT', 'StreamingSSQSTFT2', 'StreamingSTFT',
           'stream_ssq_cwt', 'stream_cwt', 'stream_ssq_stft',
           'stream_ssq_stft2', 'stream_stft', 'StreamingMultirateSSQCWT',
           'parallel', 'extract_ridges', 'TestSignals', 'experimental',
           'ridge_extraction']
