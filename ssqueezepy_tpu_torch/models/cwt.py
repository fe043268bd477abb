# -*- coding: utf-8 -*-
"""Continuous Wavelet Transform core: wavelet resolution and the analytic
half-spectrum FFT convolution.

Counterpart of `ssqueezepy_tpu/models/cwt.py` (`_is_analytic`,
`_wavelet_key`, `resolve_wavelet`, `_process_gmw_wavelet` and the
analytic branch of `cwt_core`). `cwt_core` is the plain PyTorch version
of the CWT part of the fused kernel in `ops/cwt_cuda.py`. The public
`cwt`/`icwt` wait for ROADMAP item A4b.
"""
import torch

from ..ops.fft import ifft
from .wavelets import Wavelet, _xifn

__all__ = ['cwt_core', 'resolve_wavelet']


def _is_analytic(wavelet):
    """True if the freq-domain wavelet is exactly zero for w < 0."""
    return getattr(wavelet.fn, 'qualname', '').startswith('gmw')


def _wavelet_key(wavelet):
    cfg = tuple(sorted((k, str(v)) for k, v in wavelet.config.items()))
    return (getattr(wavelet.fn, 'qualname', str(id(wavelet.fn))), cfg,
            wavelet.dtype)


_WAVELET_CANON = {}
_SPEC_WAVELET_CACHE = {}


def _canonical_wavelet(wavelet):
    """One Wavelet per configuration, so plan caches keyed on it stay
    hot across calls."""
    return _WAVELET_CANON.setdefault(_wavelet_key(wavelet), wavelet)


def resolve_wavelet(wavelet, l1_norm=True, N=None):
    """Spec -> canonical Wavelet, memoized per (spec, l1_norm, N)."""
    if isinstance(wavelet, Wavelet):
        return _canonical_wavelet(wavelet)
    try:
        key = (repr(wavelet), bool(l1_norm), N)
    except Exception:
        key = None
    if key is not None:
        hit = _SPEC_WAVELET_CACHE.get(key)
        if hit is not None:
            return hit
    w = _process_gmw_wavelet(wavelet, l1_norm)
    kw = {} if N is None else {'N': N}
    w = _canonical_wavelet(Wavelet._init_if_not_isinstance(w, **kw))
    if key is not None:
        _SPEC_WAVELET_CACHE[key] = w
    return w


def _process_gmw_wavelet(wavelet, l1_norm):
    """Keep the GMW norm consistent with `l1_norm`."""
    norm = 'bandpass' if l1_norm else 'energy'
    if isinstance(wavelet, str) and wavelet.lower()[:3] == 'gmw':
        wavelet = ('gmw', {'norm': norm})
    elif isinstance(wavelet, tuple) and wavelet[0].lower()[:3] == 'gmw':
        name, wavopts = wavelet
        wavopts = dict(wavopts)
        wavopts['norm'] = wavopts.get('norm', norm)
        wavelet = (name, wavopts)
    elif isinstance(wavelet, Wavelet):
        if wavelet.name == 'GMW L2' and l1_norm:
            raise ValueError("using GMW L2 wavelet with `l1_norm=True`")
        elif wavelet.name == 'GMW L1' and not l1_norm:
            raise ValueError("using GMW L1 wavelet with `l1_norm=False`")
    return wavelet


def cwt_core(xh, wavelet, scales, n_up, n1, N, dt, derivative, l1_norm):
    """CWT rows from the half spectrum `xh` (complex, n_up//2 + 1) of the
    padded signal — the analytic branch of the JAX package's `cwt_core`:
    the wavelet is synthesized on the half grid (it is zero on the
    negative half), the Nyquist bin halved, and the inverse FFT kept to
    [n1, n1+N). `scales` is a real (na,) tensor on xh's device. Returns
    (Wx, dWx or None), complex (na, N)."""
    if not _is_analytic(wavelet):
        raise NotImplementedError("non-analytic wavelets wait for "
                                  "ROADMAP.md queue A, A4b")
    half = n_up // 2 + 1
    xi = torch.as_tensor(_xifn(1., n_up)[:half], dtype=scales.dtype,
                         device=scales.device)
    psih = wavelet.fn(scales.reshape(-1, 1) * xi, xp=torch)
    if n_up % 2 == 0:
        psih[:, half - 1] /= 2                      # Nyquist halving
    Psih_xh = psih * xh

    out_range = (n1, n1 + N)
    Wx = ifft(Psih_xh, n=n_up, out_range=out_range)
    dWx = None
    if derivative:
        # spectrum times 1j * xi / dt
        xi_dt = xi / dt
        dWx = ifft(torch.complex(-Psih_xh.imag * xi_dt,
                                 Psih_xh.real * xi_dt),
                   n=n_up, out_range=out_range)
    if not l1_norm:
        s_sqrt = torch.sqrt(scales).reshape(-1, 1)
        Wx = Wx * s_sqrt
        if derivative:
            dWx = dWx * s_sqrt
    return Wx, dWx
