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
`phase_ssqueeze`, `toolkit`, `visuals`), with the helpers and names of
the JAX package's top level (elementwise scrubbing, the numpy/torch
backend `S`/`Q`, framing, the `FFT` handle, the `algos` shim), on an
NVIDIA Hopper card: the fused CWT
kernels, the STFT table kernel, the reassignment scatters (from bins, and
the generic one), the fused phase + bins + scatter kernel and the ridge
dynamic program are hand-written CUDA (`csrc/`), built with nvcc at first use on a CUDA tensor. Entry points
and plans run on ``device='cuda'`` unless the caller passes
``device='cpu'``, which runs the kernels' plain PyTorch versions. The package imports torch, numpy and scipy — never JAX, and
nothing of `ssqueezepy_tpu`.
"""
from .configs import (configure, get_config, backend, gdefaults,
                      IS_PARALLEL, USE_GPU)
from .ops.fft import (fft, ifft, rfft, irfft, fftshift, ifftshift, FFT,
                      FFT_GLOBAL)
from .ops.phase import phase_cwt, phase_stft, phase_cwt_num
from .ops.ssq_kernels import (ssqueeze_fast, indexed_sum_onfly,
                              indexed_sum, find_closest)
from .ops.framing import (buffer, unbuffer, window_norm, window_resolution,
                          window_area)
from .ops.pad import padsignal
from .ops.diff import trigdiff
from .ops.elementwise import (replace_at_inf_or_nan, replace_at_inf,
                              replace_at_nan, replace_at_value,
                              replace_under_abs, zero_denormals, nCk)
from .ops.search import find_maximum, find_first_occurrence

from .models.wavelets import (Wavelet, morlet, bump, cmhat, hhhat,
                              center_frequency, freq_resolution,
                              time_resolution, afftshift, aifftshift,
                              isinstance_by_name)
from .models.gmw import (gmw, compute_gmw, morsewave, morsefreq,
                         gmw_l1, gmw_l2, gmw_l1_k, gmw_l2_k, laguerre,
                         morseafun)
from .models.cwt import cwt, icwt, cwt_higher_order
from .models.stft import stft, istft
from .models.windows import get_window
from .models.ssqueezing import ssqueeze
from .models.ssq_cwt import ssq_cwt, issq_cwt
from .models.ssq_cwt2 import ssq_cwt2
from .models.ssq_stft import ssq_stft, ssq_stft2, issq_stft
from .models.ridge_extraction import extract_ridges
from .models.test_signals import (TestSignals, DEFAULT_N, DEFAULT_ARGS,
                                  DEFAULT_TKW, DEFAULT_SNR, DEFAULT_SEED)

from .utils.common import (WARN, NOTE, EPS32, EPS64, pi, p2up, mad,
                           est_riskshrink_thresh, assert_is_one_of)
from .utils.backend import S, Q, asnumpy, is_tensor
from .utils.cwt_utils import (process_scales, cwt_scalebounds, make_scales,
                              adm_ssq, adm_cwt, infer_scaletype,
                              logscale_transition_idx)

from .streaming import (StreamingSSQCWT, StreamingSSQCWT2, StreamingCWT,
                        StreamingSSQSTFT, StreamingSSQSTFT2,
                        StreamingSTFT, stream_ssq_cwt, stream_cwt,
                        stream_ssq_stft, stream_ssq_stft2, stream_stft)
from .streaming_multirate import StreamingMultirateSSQCWT

from . import configs
from . import toolkit
from . import experimental
from . import visuals
from . import parallel
from . import algos
from .models import wavelets, ssqueezing, ridge_extraction
from .visuals import imshow, plot, plots, scat, plotscat, hist
from .algos import (phase_cwt_cpu, phase_cwt_gpu, phase_stft_cpu,
                    phase_stft_gpu)


def wavs():
    """Names of the supported wavelets."""
    return Wavelet.SUPPORTED


# every public name of the JAX package's top level but its TPU mechanics
# (`Complex`, `as_complex`, `fft_matmul`, `ifft_matmul`): the functions,
# classes and constants imported above and the module aliases below (not
# the subpackages that importing puts in this namespace)
_MODULE_ALIASES = ('configs', 'toolkit', 'experimental', 'visuals',
                   'parallel', 'algos', 'wavelets', 'ssqueezing',
                   'ridge_extraction')
__all__ = sorted(n for n, v in list(globals().items())
                 if not n.startswith('_') and (
                     n in _MODULE_ALIASES
                     or not isinstance(v, type(configs))))
