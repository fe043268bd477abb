# -*- coding: utf-8 -*-
"""Migration shim of the reference library's `ssqueezepy.algos` namespace,
name for name as `ssqueezepy_tpu/algos.py` keeps it: code written
against it keeps working, each name resolving to this package's
function. The reference's per-device pairs (`*_cpu`/`*_gpu`) are one
function here: a call runs where its tensors are (its `device`).
"""
from .ops.ssq_kernels import (ssqueeze_fast, indexed_sum_onfly,
                              indexed_sum, find_closest,
                              find_closest_smart, find_closest_brute,
                              find_closest_log, find_closest_lin)
from .ops.phase import phase_cwt, phase_stft, phase_cwt_num
from .ops.elementwise import (replace_at_inf_or_nan, replace_at_inf,
                              replace_at_nan, replace_at_value,
                              replace_under_abs, zero_denormals, nCk)
from .ops.search import find_maximum, find_first_occurrence

phase_cwt_cpu = phase_cwt
phase_cwt_gpu = phase_cwt
phase_stft_cpu = phase_stft
phase_stft_gpu = phase_stft

__all__ = [
    'ssqueeze_fast', 'indexed_sum_onfly', 'indexed_sum',
    'find_closest', 'find_closest_smart', 'find_closest_brute',
    'find_closest_log', 'find_closest_lin',
    'phase_cwt', 'phase_stft', 'phase_cwt_num',
    'phase_cwt_cpu', 'phase_cwt_gpu', 'phase_stft_cpu', 'phase_stft_gpu',
    'replace_at_inf_or_nan', 'replace_at_inf', 'replace_at_nan',
    'replace_at_value', 'replace_under_abs', 'zero_denormals', 'nCk',
    'find_maximum', 'find_first_occurrence',
]
