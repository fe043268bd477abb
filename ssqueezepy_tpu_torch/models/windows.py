# -*- coding: utf-8 -*-
"""STFT window construction (host numpy: windows are plan constants).

Counterpart of `ssqueezepy_tpu/models/windows.py`: `get_window` with the
DPSS default and the frequency-domain derivative window, and the NOLA
invertibility check, both memoized.
"""
import numpy as np
import scipy.signal as sig

from ..utils.common import WARN
from .wavelets import _xifn

__all__ = ['get_window', '_check_NOLA']

_WINDOW_MEMO = {}
_NOLA_MEMO = set()


def _win_spec_key(window):
    if window is None or isinstance(window, str):
        return window
    return ('arr', hash(np.asarray(window).tobytes()), np.shape(window))


def _zero_denormals_np(x):
    tiny = 1000 * np.finfo(x.dtype).tiny
    x[(x < tiny) & (x > -tiny)] = 0
    return x


def get_window(window, win_len, n_fft=None, derivative=False, dtype=None):
    """Window of length `n_fft` (centred from `win_len` if shorter);
    default DPSS(win_len, max(4, win_len//8), periodic). A string is a
    scipy window name (periodic), an array is taken as is.
    `derivative=True` also returns the frequency-domain derivative of the
    window. Memoized."""
    key = (_win_spec_key(window), win_len, n_fft, derivative,
           dtype or 'float32')
    hit = _WINDOW_MEMO.get(key)
    if hit is None:
        hit = _WINDOW_MEMO[key] = _build_window(window, win_len, n_fft,
                                                derivative, dtype)
    return hit


def _resolve_window(window, win_len):
    if window is None:
        return sig.windows.dpss(win_len, max(4, win_len // 8), sym=False)
    if isinstance(window, str):
        return sig.get_window(window, win_len, fftbins=True)
    if isinstance(window, np.ndarray):
        if len(window) != win_len:
            WARN("window length %d does not match win_len=%d"
                 % (len(window), win_len))
        return window
    raise ValueError("unsupported `window` spec %r: pass a scipy window "
                     "name or a numpy array" % (window,))


def _spectral_derivative(w):
    """d(window)/dt through the frequency domain; the Nyquist bin of an
    even length is zeroed (its derivative is ambiguous in sign)."""
    xi = _xifn(1, len(w))
    if len(w) % 2 == 0:
        xi[len(w) // 2] = 0
    return np.fft.ifft(np.fft.fft(w) * 1j * xi).real


def _build_window(window, win_len, n_fft=None, derivative=False,
                  dtype=None):
    if n_fft is not None and win_len > n_fft:
        raise ValueError("win_len=%d exceeds n_fft=%d" % (win_len, n_fft))
    window = _resolve_window(window, win_len)
    if n_fft is not None and len(window) < n_fft:
        lpad = (n_fft - win_len) // 2
        window = np.pad(window, [lpad, n_fft - win_len - lpad])

    dtype = dtype or 'float32'
    out = _zero_denormals_np(np.asarray(window).astype(dtype))
    if derivative:
        dw = _zero_denormals_np(_spectral_derivative(window).astype(dtype))
        return out, dw
    return out


def _check_NOLA(window, hop_len, dtype=None, imprecision_strict=False):
    """Warn where the window and hop cannot be inverted (or only
    imprecisely in float32). Memoized per (window, hop, dtype)."""
    key = (hash(window.tobytes()), window.shape, hop_len, dtype,
           imprecision_strict)
    if key in _NOLA_MEMO:
        return
    _NOLA_MEMO.add(key)
    noverlap = len(window) - hop_len
    if hop_len > len(window):
        WARN("hop_len %d exceeds the window length %d: frames skip "
             "samples and the STFT cannot be inverted"
             % (hop_len, len(window)))
    elif not sig.check_NOLA(window, len(window), noverlap):
        WARN("window violates the nonzero-overlap-add (NOLA) condition "
             "at this hop_len: the STFT cannot be inverted")
    if dtype is None:
        dtype = str(window.dtype)
    tol = 0.15 if imprecision_strict else 1e-3
    if dtype == 'float32' and not sig.check_NOLA(window, len(window),
                                                 noverlap, tol=tol):
        WARN("float32 inversion will be imprecise near the signal's "
             "final hop: reduce hop_len, widen the window, or use "
             "dtype='float64'")
