# -*- coding: utf-8 -*-
"""Wavelet engine: frequency-domain wavelet objects and their center
frequency.

Counterpart of `ssqueezepy_tpu/models/wavelets.py`, cut to what the
synchrosqueezed CWT needs: GMW (L1 and L2, order 0). Wavelet functions
take ``xp=torch`` (device synthesis) or ``xp=np`` (host plan). Other
wavelets wait for ROADMAP item A2b.
"""
import numpy as np
from scipy import integrate

from ..utils.common import pi, NOTE, assert_is_one_of
from ..configs import default_dtype
from ..ops.search import find_maximum
from .gmw import gmw as _gmw_factory

__all__ = ['Wavelet', '_xifn', 'center_frequency', 'aifftshift']


def _xifn(scale, N, dtype=np.float64):
    """Radian FFT frequency grid scaled by `scale`:
        N=128: [0, 1, ..., 64, -63, ..., -1] * (2*pi/N) * scale
        N=129: [0, 1, ..., 64, -64, ..., -1] * (2*pi/N) * scale
    """
    h = scale * (2 * pi) / N
    xi = np.empty(N, dtype=dtype)
    m = N // 2
    xi[:m + 1] = np.arange(m + 1) * h
    xi[m + 1:] = np.arange(m + 1 - N, 0) * h
    return xi


class Wavelet:
    """Frequency-domain wavelet: `fn(w, xp=torch)` evaluates `psih` as a
    tensor, `evaluate_np` on the host in float64."""
    SUPPORTED = {'gmw'}
    DTYPES = {'float32', 'float64'}

    def __init__(self, wavelet='gmw', N=1024, dtype=None):
        self._dtype = dtype
        self._validate_and_set_wavelet(wavelet)
        self.N = int(N)

    def _validate_and_set_wavelet(self, wavelet):
        if isinstance(wavelet, tuple):
            if not (len(wavelet) == 2 and isinstance(wavelet[1], dict)):
                raise TypeError(
                    "`wavelet` tuple must be (name, params_dict); got %s"
                    % str(wavelet))
            name, wavopts = wavelet
            wavopts = dict(wavopts)
        elif isinstance(wavelet, str):
            name, wavopts = wavelet, {}
        elif callable(wavelet):
            raise NotImplementedError(
                "custom wavelet functions are not ported yet "
                "(ROADMAP.md queue A, A2b)")
        else:
            raise TypeError("`wavelet` must be name str, (name, dict) "
                            "tuple, or function (got %s)" % type(wavelet))

        name = name.lower()
        if name in ('morlet', 'bump', 'cmhat', 'hhhat'):
            raise NotImplementedError(
                "wavelet %r is not ported yet (ROADMAP.md queue A, A2b)"
                % name)
        assert_is_one_of(name, 'wavelet', Wavelet.SUPPORTED)

        # dtype policy: global default float32; GMW 'energy' norm
        # defaults to float64
        wav_dtype = wavopts.pop('dtype', None) or self._dtype
        if wav_dtype is None:
            wav_dtype = default_dtype()
        if wavopts.get('norm') == 'energy' and self._dtype is None \
                and wav_dtype == 'float32':
            wav_dtype = 'float64'
        assert_is_one_of(str(wav_dtype), 'dtype', Wavelet.DTYPES)
        self._dtype = str(wav_dtype)

        self.fn = _gmw_factory(**wavopts)
        self.config = dict(self.fn.config)

    @classmethod
    def _init_if_not_isinstance(cls, wavelet, **kw):
        if isinstance(wavelet, cls):
            return wavelet
        return cls(wavelet, **kw)

    def evaluate_np(self, w):
        """Host (numpy float64) evaluation for plan-time searches and
        integrals."""
        return np.asarray(self.fn(np.asarray(w, dtype=np.float64), xp=np))

    @staticmethod
    def _halve_nyquist(psih):
        N = psih.shape[-1]
        if N % 2 == 0:
            psih = psih.copy()
            psih[..., N // 2] /= 2
        return psih

    def xifn_np(self, scale=1., N=None):
        N = N or self.N
        scale = np.asarray(scale, dtype=np.float64)
        if scale.ndim == 1:
            scale = scale.reshape(-1, 1)
        return scale * _xifn(1., N)

    def filterbank_np(self, scales, N=None, nohalf=False):
        """Host filterbank (na, N) float64 numpy."""
        N = N or self.N
        scales = np.asarray(scales, dtype=np.float64).reshape(-1, 1)
        psih = self.evaluate_np(scales * _xifn(1., N))
        if not nohalf:
            psih = self._halve_nyquist(psih)
        return psih

    @property
    def dtype(self):
        return self._dtype

    @property
    def N(self):
        return self._N

    @N.setter
    def N(self, value):
        self._N = int(value)

    @property
    def name(self):
        specials = {'gmw_l1': 'GMW L1', 'gmw_l2': 'GMW L2'}
        return specials[self.fn.qualname]


def aifftshift(xh):
    """Inverse of the analytic fftshift: even N rolls by N//2 - 1 (the
    Nyquist bin is filed under the positive half), odd N is
    `ifftshift`."""
    xh = np.asarray(xh)
    N = xh.shape[-1]
    if N % 2 == 0:
        return np.roll(xh, N // 2 - 1, axis=-1)
    return np.fft.ifftshift(xh, axes=-1)


def center_frequency(wavelet, scale=None, N=1024, kind='energy',
                     force_int=None):
    """Center frequency (radian): 'energy' (energy-weighted mean), 'peak'
    (discrete argmax), 'peak-ct' (continuous-time peak location)."""
    assert_is_one_of(kind, 'kind', ('energy', 'peak', 'peak-ct'))
    wavelet = Wavelet._init_if_not_isinstance(wavelet)

    if force_int and 'peak' in kind:
        NOTE("`force_int` ignored with 'peak' in `kind`")
    if kind == 'peak-ct' and scale is not None:
        NOTE("`scale` ignored with `kind = 'peak-ct'`")

    def _params(scale):
        w = aifftshift(_xifn(1, N))
        psih = wavelet.evaluate_np(scale * w)
        apsih2 = np.abs(psih) ** 2
        return w, psih, apsih2

    if scale is None and kind != 'peak-ct':
        wc_ct, _ = find_maximum(lambda v: wavelet.evaluate_np(v))
        scale = (4 / pi) * wc_ct

    if kind == 'energy':
        force_int = force_int if force_int is not None else True
        use_formula = not force_int
        if use_formula:
            scale_orig = scale
            wc_ct, _ = find_maximum(lambda v: wavelet.evaluate_np(v))
            scale = (4 / pi) * wc_ct
        w, psih, apsih2 = _params(scale)
        wc = (integrate.trapezoid(apsih2 * w) /
              integrate.trapezoid(apsih2))
        if use_formula:
            wc *= (scale / scale_orig)
        return float(wc)
    elif kind == 'peak':
        w, psih, apsih2 = _params(scale)
        return float(w[np.argmax(apsih2)])
    else:  # 'peak-ct'
        wc, _ = find_maximum(lambda v: wavelet.evaluate_np(v))
        return float(wc)
