# -*- coding: utf-8 -*-
"""Wavelet engine: frequency-domain wavelet objects and their
time-frequency properties.

Counterpart of `ssqueezepy_tpu/models/wavelets.py`. Wavelet functions are
pure, array-module-generic callables ``fn(w, xp)`` of radian frequency:
``xp=torch`` evaluates a tensor in its own dtype and on its own device
(the filterbank synthesis, the CUDA kernel's wavelet table), ``xp=np``
evaluates on the host in float64 (scale searches, admissibility
integrals: the same arithmetic as the JAX package, so the plans agree).
The wavelets are GMW (`gmw.py`, any order), morlet, bump, cmhat, hhhat
and a user's callable, which takes a torch tensor (`_wrap_custom`). The
time-frequency properties (`wc`, `std_t`, `std_w`, ...) are host numpy,
cached per instance.
"""
import numpy as np
import torch
from scipy import integrate

from ..utils.common import pi, NOTE, assert_is_one_of, not_ported
from ..configs import default_dtype, gdefaults
from ..ops.search import find_maximum
from .gmw import gmw as _gmw_factory

__all__ = ['Wavelet', 'morlet', 'bump', 'cmhat', 'hhhat', '_xifn',
           'center_frequency', 'freq_resolution', 'time_resolution',
           'afftshift', 'aifftshift', 'isinstance_by_name']


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


def _asarray(w, xp):
    """`w` as an array of `xp`; a tensor stays itself (its autograd graph
    included)."""
    return w if isinstance(w, torch.Tensor) and xp is not np \
        else xp.asarray(w)


def _as_dtype_of(out, w, xp):
    """`out` in `w`'s dtype (numpy promotes python scalars to float64;
    torch keeps a tensor's dtype already)."""
    return out.astype(w.dtype) if xp is np else out.to(w.dtype)


# --------------------------------------------------------------------------
# simple wavelets: pure functions of radian frequency, xp-generic
# --------------------------------------------------------------------------
def morlet(mu=None, dtype=None):
    """Morlet wavelet, exactly zero-mean corrected. `mu=13.4` resembles
    GMW (gamma, beta) = (3, 60)."""
    (mu,) = gdefaults('morlet', mu=mu).values()
    mu = float(mu)
    cs = (1 + np.exp(-mu ** 2) - 2 * np.exp(-3 / 4 * mu ** 2)) ** (-.5)
    ks = float(np.exp(-.5 * mu ** 2))
    amp = float(np.sqrt(2) * cs * pi ** .25)

    def fn(w, xp=torch):
        w = _asarray(w, xp)
        return _as_dtype_of(amp * (xp.exp(-.5 * (w - mu) ** 2)
                                   - ks * xp.exp(-.5 * w ** 2)), w, xp)
    fn.config = dict(mu=mu)
    fn.qualname = 'morlet'
    return fn


def bump(mu=None, s=None, om=None, dtype=None):
    """Bump wavelet. `om != 0` makes it complex-valued in frequency: `fn`
    then returns the pair (re, im)."""
    kw = gdefaults('bump', mu=mu, s=s, om=om)
    mu, s, om = float(kw['mu']), float(kw['s']), float(kw['om'])
    inv_norm = 1 / .443993816053287

    def fn(w, xp=torch):
        w = _asarray(w, xp)
        _w = (w - mu) / s
        supported = xp.abs(_w) < .999
        _ws = _w * supported
        env = xp.exp(-1 / (1 - _ws ** 2)) * supported / s * inv_norm
        if om == 0:
            return _as_dtype_of(env, w, xp)
        ph = 2 * pi * om * w
        return (env * xp.cos(ph), env * xp.sin(ph))
    fn.config = dict(mu=mu, s=s, om=om)
    fn.qualname = 'bump'
    return fn


def cmhat(mu=None, s=None, dtype=None):
    """Complex Mexican Hat."""
    kw = gdefaults('cmhat', mu=mu, s=s)
    mu, s = float(kw['mu']), float(kw['s'])
    amp = float(2 * np.sqrt(2 / 3) * pi ** (-1 / 4))

    def fn(w, xp=torch):
        w = _asarray(w, xp)
        _w = w - mu
        return _as_dtype_of(
            amp * (s ** 2.5 * _w ** 2 * xp.exp(-s ** 2 * _w ** 2 / 2)
                   * (_w >= 0)), w, xp)
    fn.config = dict(mu=mu, s=s)
    fn.qualname = 'cmhat'
    return fn


def hhhat(mu=None, dtype=None):
    """Hilbert analytic Hermitian Hat."""
    (mu,) = gdefaults('hhhat', mu=mu).values()
    mu = float(mu)
    amp = float(2 / np.sqrt(5) * pi ** (-1 / 4))

    def fn(w, xp=torch):
        w = _asarray(w, xp)
        _w = w - mu
        return _as_dtype_of((amp * (_w * (1 + _w) * xp.exp(-.5 * _w ** 2)))
                            * (1 + xp.sign(_w)), w, xp)
    fn.config = dict(mu=mu)
    fn.qualname = 'hhhat'
    return fn


_FACTORIES = {
    'gmw': _gmw_factory,
    'morlet': morlet,
    'bump': bump,
    'cmhat': cmhat,
    'hhhat': hhhat,
}


def _wrap_custom(fn):
    """A user's fn(w) -> psih of a torch tensor, in the xp-generic form:
    ``xp=np`` hands it a float64 CPU tensor and returns numpy. The
    wrapper keeps the user's function (`user_fn`): a custom wavelet is
    identified by that object, never by its name."""
    def wrapped(w, xp=torch):
        if xp is not np:
            return fn(w)
        out = fn(torch.as_tensor(np.asarray(w, dtype=np.float64)))
        if isinstance(out, tuple):
            return tuple(np.asarray(o) for o in out)
        return out.numpy() if isinstance(out, torch.Tensor) \
            else np.asarray(out)
    wrapped.config = {}
    wrapped.qualname = getattr(fn, '__name__', 'custom')
    wrapped.user_fn = fn
    return wrapped


# --------------------------------------------------------------------------
# Wavelet class
# --------------------------------------------------------------------------
class Wavelet:
    """Frequency-domain wavelet: `__call__` evaluates psih as a tensor,
    `evaluate_np` on the host in float64, `psifn` the time-domain wavelet.
    """
    SUPPORTED = {'gmw', 'morlet', 'bump', 'cmhat', 'hhhat'}
    DTYPES = {'float32', 'float64'}

    def __init__(self, wavelet='gmw', N=1024, dtype=None):
        self._dtype = dtype
        self._validate_and_set_wavelet(wavelet)
        self.N = int(N)
        self._prop_cache = {}

    # ---- init helpers -----------------------------------------------------
    def _validate_and_set_wavelet(self, wavelet):
        if callable(wavelet) and not isinstance(wavelet, Wavelet):
            self.fn = wavelet if hasattr(wavelet, 'config') else \
                _wrap_custom(wavelet)
            self.config = getattr(self.fn, 'config', {})
            if self._dtype is None:
                self._dtype = default_dtype()
            return

        if isinstance(wavelet, tuple):
            if not (len(wavelet) == 2 and isinstance(wavelet[1], dict)):
                raise TypeError(
                    "`wavelet` tuple must be (name, params_dict); got %s"
                    % str(wavelet))
            name, wavopts = wavelet
            wavopts = dict(wavopts)
        elif isinstance(wavelet, str):
            name, wavopts = wavelet, {}
        else:
            raise TypeError("`wavelet` must be name str, (name, dict) "
                            "tuple, or function (got %s)" % type(wavelet))

        name = name.lower()
        assert_is_one_of(name, 'wavelet', Wavelet.SUPPORTED)

        # dtype policy: global default float32; GMW 'energy' norm
        # defaults to float64
        wav_dtype = wavopts.pop('dtype', None) or self._dtype
        if wav_dtype is None:
            wav_dtype = default_dtype()
        if name == 'gmw' and wavopts.get('norm') == 'energy' and \
                self._dtype is None and wav_dtype == 'float32':
            wav_dtype = 'float64'
        assert_is_one_of(str(wav_dtype), 'dtype', Wavelet.DTYPES)
        self._dtype = str(wav_dtype)

        self.fn = _FACTORIES[name](**wavopts)
        self.config = dict(self.fn.config)

    @classmethod
    def _init_if_not_isinstance(cls, wavelet, **kw):
        if isinstance(wavelet, cls):
            return wavelet
        return cls(wavelet, **kw)

    # ---- core evaluation --------------------------------------------------
    def __call__(self, w=None, *, scale=None, N=None, nohalf=True):
        """psih as a tensor in the wavelet's dtype: at radian frequencies
        `w` (on w's device), or on the grid `scale * xi(N)`.
        `nohalf=False` halves the Nyquist bin of an even-length grid."""
        if w is not None:
            w = torch.as_tensor(w, dtype=getattr(torch, self.dtype))
        else:
            w = self.xifn(scale, N)
        psih = self.fn(w, xp=torch)
        if not nohalf:
            psih = self._halve_nyquist(psih)
        return psih

    def evaluate_np(self, w):
        """Host (numpy float64) evaluation for plan-time searches and
        integrals."""
        return np.asarray(self.fn(np.asarray(w, dtype=np.float64), xp=np))

    @staticmethod
    def _halve_nyquist(psih):
        if isinstance(psih, tuple):
            return tuple(Wavelet._halve_nyquist(p) for p in psih)
        N = psih.shape[-1]
        if N % 2 == 0:
            psih = psih.clone() if isinstance(psih, torch.Tensor) \
                else psih.copy()
            psih[..., N // 2] /= 2
        return psih

    def xifn(self, scale=None, N=None):
        """`scale * xi` grid as a tensor in the wavelet's dtype; `scale`
        a scalar or (na,) / (na, 1)."""
        N = N or self.N
        xi = torch.as_tensor(_xifn(1., N, np.dtype(self.dtype)))
        if scale is None:
            return xi
        scale = torch.as_tensor(scale, dtype=xi.dtype)
        if scale.ndim == 1:
            scale = scale.reshape(-1, 1)
        return scale * xi

    def xifn_np(self, scale=1., N=None):
        N = N or self.N
        scale = np.asarray(scale, dtype=np.float64)
        if scale.ndim == 1:
            scale = scale.reshape(-1, 1)
        return scale * _xifn(1., N)

    def psifn(self, w=None, *, scale=None, N=None):
        """Time-domain wavelet via ifft(psih * (-1)^n) (the sign flips
        center it); host numpy."""
        N_ = N or self.N
        if w is not None:
            psih = self.evaluate_np(np.asarray(w))
        else:
            psih = self.evaluate_np(self.xifn_np(scale if scale is not None
                                                 else 1., N_))
        psih = self._halve_nyquist(psih)
        pn = (-1) ** np.arange(psih.shape[-1])
        return np.fft.ifft(psih * pn, axis=-1)

    def filterbank_np(self, scales, N=None, nohalf=False):
        """Host filterbank (na, N) float64 numpy."""
        N = N or self.N
        scales = np.asarray(scales, dtype=np.float64).reshape(-1, 1)
        psih = self.evaluate_np(scales * _xifn(1., N))
        if not nohalf:
            psih = self._halve_nyquist(psih)
        return psih

    # ---- metadata ---------------------------------------------------------
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
        q = getattr(self.fn, 'qualname', getattr(self.fn, '__name__', '?'))
        specials = {'gmw_l1': 'GMW L1', 'gmw_l2': 'GMW L2'}
        return specials.get(q, q.replace('_', ' ').title())

    @property
    def config_str(self):
        if not self.config:
            return "Default configs"
        cfg = ""
        for k, v in self.config.items():
            if k in ('norm', 'centered_scale', 'dtype'):
                continue
            if k == 'order' and v == 0:
                continue
            if isinstance(v, float) and v.is_integer():
                v = int(v)
            cfg += "{}={}, ".format(k, v)
        return cfg.rstrip(', ') or "Default configs"

    # ---- time-frequency properties (host numpy, cached) -------------------
    def _cached(self, key, builder):
        if key not in self._prop_cache:
            self._prop_cache[key] = builder()
        return self._prop_cache[key]

    @property
    def wc_ct(self):
        """Continuous-time radian peak center frequency."""
        return self._cached('wc_ct', lambda: center_frequency(
            self, kind='peak-ct', N=self.N))

    @property
    def scalec_ct(self):
        """Scale putting the peak at pi/4."""
        return self._cached('scalec_ct', lambda: (4 / pi) * self.wc_ct)

    @property
    def wc(self):
        return self._cached('wc', lambda: center_frequency(
            self, scale=self.scalec_ct, N=self.N, kind='energy'))

    @property
    def std_t(self):
        return self._cached('std_t', lambda: time_resolution(
            self, scale=self.scalec_ct, N=self.N, nondim=True))

    @property
    def std_w(self):
        return self._cached('std_w', lambda: freq_resolution(
            self, scale=self.scalec_ct, N=self.N, nondim=True))

    @property
    def std_f(self):
        return self.std_w / (2 * pi)

    @property
    def harea(self):
        """Heisenberg area std_t * std_w >= 0.5."""
        return self.std_t * self.std_w

    @property
    def std_t_d(self):
        return self._cached('std_t_d', lambda: time_resolution(
            self, scale=self.scalec_ct, N=self.N, nondim=False))

    @property
    def std_w_d(self):
        return self._cached('std_w_d', lambda: freq_resolution(
            self, scale=self.scalec_ct, N=self.N, nondim=False))

    @property
    def std_f_d(self):
        return self.std_w_d / (2 * pi)

    def reset_properties(self):
        self._prop_cache.clear()

    def info(self, nondim=True):
        """Print the time and frequency resolution summary."""
        if nondim:
            cfg = self.config_str
            dim_t = dim_w = "non-dimensional"
            std_t, std_w, wc = self.std_t, self.std_w, self.wc_ct
            wc_txt = "wc_ct, (cycles*radians)"
        else:
            cfg = self.config_str + " -- scale=%.2f" % self.scalec_ct
            dim_t = "samples/(cycles*radians)"
            dim_w = "(cycles*radians)/samples"
            std_t, std_w, wc = self.std_t_d, self.std_w_d, self.wc
            wc_txt = "wc,    (cycles*radians)/samples; %.2f" % self.scalec_ct
        print(("{} wavelet\n\t{}\n"
               "\tCenter frequency: {:<10.6f} [{}]\n"
               "\tTime resolution:  {:<10.6f} [std_t, {}]\n"
               "\tFreq resolution:  {:<10.6f} [std_w, {}]\n"
               "\tHeisenberg area:  {:.12f}").format(
                   self.name, cfg, wc, wc_txt, std_t, dim_t, std_w, dim_w,
                   std_t * std_w))

    def viz(self, name='overview', **kw):
        not_ported("Wavelet.viz (the visuals module)", 'A12')

    def _desc(self, N=None, scale=None, show_N=True):
        ptxt = ("" if self.config_str == "Default configs" else
                self.config_str.rstrip(', ') + ', ')
        N = N or self.N
        if scale is None:
            title = "{} wavelet | {}N={}".format(self.name, ptxt, N)
        else:
            title = "{} wavelet | {}scale={:.2f}, N={}".format(
                self.name, ptxt, scale, N)
        if not show_N:
            title = title[:title.find(f"N={N}")].rstrip(', ')
        return title


# --------------------------------------------------------------------------
# analytic fftshifts: analytic wavelets file the Nyquist bin under the
# POSITIVE half, unlike the FFT convention
# --------------------------------------------------------------------------
def isinstance_by_name(obj, ref):
    """isinstance by qualified class name (robust to module reloads)."""
    def _class_name(o):
        name = getattr(o, '__qualname__', getattr(o, '__name__', ''))
        return (getattr(o, '__module__', '') + '.' + name).lstrip('.')
    return _class_name(type(obj)) == _class_name(ref)


def afftshift(xh):
    """Even N: moves the right N//2+1 bins to the left, i.e. roll by
    -(N//2 - 1); odd N: plain fftshift."""
    xh = np.asarray(xh)
    N = xh.shape[-1]
    if N % 2 == 0:
        return np.roll(xh, -(N // 2 - 1), axis=-1)
    return np.fft.fftshift(xh, axes=-1)


def aifftshift(xh):
    """Inverse of `afftshift`."""
    xh = np.asarray(xh)
    N = xh.shape[-1]
    if N % 2 == 0:
        return np.roll(xh, N // 2 - 1, axis=-1)
    return np.fft.ifftshift(xh, axes=-1)


# --------------------------------------------------------------------------
# wavelet properties (host numpy)
# --------------------------------------------------------------------------
def center_frequency(wavelet, scale=None, N=1024, kind='energy',
                     force_int=None, viz=False):
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


def freq_resolution(wavelet, scale=10, N=1024, nondim=True, force_int=True,
                    viz=False):
    """Frequency std of |psih|^2 about the energy center frequency."""
    wavelet = Wavelet._init_if_not_isinstance(wavelet)

    use_formula = ((scale < 4 or scale > N / 5) and not force_int)
    if use_formula:
        scale_orig = scale
        scale = (4 / pi) * wavelet.wc_ct

    w = aifftshift(_xifn(1, N))
    psih = wavelet.evaluate_np(scale * w)
    wce = center_frequency(wavelet, scale, force_int=force_int,
                           kind='energy')

    apsih2 = np.abs(psih) ** 2
    var_w = (integrate.trapezoid((w - wce) ** 2 * apsih2, w) /
             integrate.trapezoid(apsih2, w))
    std_w = np.sqrt(var_w)

    if use_formula:
        std_w *= (scale / scale_orig)
        scale = scale_orig
    if nondim:
        wcp = center_frequency(wavelet, scale, kind='peak')
        std_w /= wcp
    return float(std_w)


def time_resolution(wavelet, scale=10, N=1024, min_decay=1e3, max_mult=2,
                    min_mult=2, force_int=True, nondim=True, viz=False):
    """Time std of |psi(t)|^2, the integration span extended until the
    wavelet decays enough at its ends."""
    wavelet = Wavelet._init_if_not_isinstance(wavelet)

    use_formula = ((scale < 4 or scale > N / 5) and not force_int)
    if use_formula:
        scale_orig = scale
        scale = (4 / pi) * wavelet.wc_ct

    t = None
    for mult in np.arange(min_mult, max_mult + 1):
        Nt = int(mult * N)
        apsi2 = np.abs(wavelet.psifn(scale=scale, N=Nt)) ** 2
        if apsi2.max() / apsi2[:max(10, Nt // 100)].mean() > min_decay:
            T = N
            t = np.arange(-mult * T / 2, mult * T / 2, step=T / N)
            break
    if t is None:
        raise Exception(
            "Couldn't find decay timespan satisfying `(min_decay, max_mult)"
            " = ({}, {})` for `scale={}`; decrease former or increase "
            "latter or check `wavelet`".format(min_decay, max_mult, scale))

    Nt = len(t)
    xi = _xifn(1, Nt)
    psih = wavelet.evaluate_np(scale * xi)
    psih = Wavelet._halve_nyquist(psih)
    psi = np.fft.ifft(psih * (-1) ** np.arange(Nt))

    apsi2 = np.abs(psi) ** 2
    var_t = (integrate.trapezoid(t ** 2 * apsi2, t) /
             integrate.trapezoid(apsi2, t))
    std_t = np.sqrt(var_t)

    if use_formula:
        std_t *= (scale_orig / scale)
        scale = scale_orig
    if nondim:
        wc = center_frequency(wavelet, scale, N=N, kind='peak')
        std_t *= wc
    return float(std_t)
