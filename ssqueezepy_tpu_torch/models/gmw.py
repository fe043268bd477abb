# -*- coding: utf-8 -*-
"""Generalized Morse Wavelets (GMW), of any order.

Counterpart of `ssqueezepy_tpu/models/gmw.py`. Each factory returns a
pure function ``fn(w, xp)`` of radian frequency: ``xp=np`` evaluates on
the host in float64 (scale searches, admissibility integrals — the same
arithmetic as the JAX package, so the plans agree), ``xp=torch``
evaluates a tensor in its own dtype and on its own device (the plain
filterbank synthesis). Both branches work in log space, which keeps the
L2 ('energy') normalization finite in float32.

An order-0 fn also carries ``fn.derivatives(w)``, psih' and psih'' in
closed form (the second-order transforms' t- and t^2-weighted banks). The
CUDA kernel `csrc/cwt_bins.cu` synthesizes the same closed forms
in-kernel from `fn.kernel_params`. Order k >= 1 (Laguerre-modulated,
`gmw_l1_k` / `gmw_l2_k`) has neither: the kernel reads it from a table
(`ops/cwt_cuda.py::wavelet_table`). The host utilities after them
(`compute_gmw`, `morsewave`, `morseafun`, `laguerre`, `morsefreq` with
its energy, instantaneous and curvature frequencies) are numpy, as in the
JAX package.
"""
import numpy as np
import torch
from scipy.special import gamma as gamma_fn, gammaln as gammaln_fn

from ..utils.common import pi
from ..configs import gdefaults

__all__ = ['gmw', 'compute_gmw', 'morsewave', 'morseafun', 'morsefreq',
           'laguerre', 'gmw_l1', 'gmw_l2', 'gmw_l1_k', 'gmw_l2_k']


def _check_args(gamma=None, beta=None, norm=None, order=None, scale=None,
                allow_zerobeta=True):
    """GMW parameter validation (ssqueezepy's rejection set)."""
    if gamma is not None and gamma <= 0:
        raise ValueError("GMW `gamma` must exceed 0; got %r" % gamma)
    if beta is not None and beta < 0:
        raise ValueError("GMW `beta` cannot be negative; got %r" % beta)
    if beta == 0 and not allow_zerobeta:
        raise ValueError("`beta` of zero is only supported by "
                         "`morsewave` (the analytic lowpass case); "
                         "got %r here" % beta)
    if norm is not None and norm not in ('bandpass', 'energy'):
        raise ValueError("GMW `norm` is 'bandpass' or 'energy'; got %r"
                         % norm)
    if order is not None:
        if not isinstance(order, (int, float)) or \
                float(order) != int(order):
            raise TypeError("GMW `order` must be an integer; got %r"
                            % (order,))
        if order < 0:
            raise ValueError("GMW `order` cannot be negative; got %r"
                             % order)
    if scale is not None and scale <= 0:
        raise ValueError("`scale` must exceed 0; got %r" % scale)


def gmw(gamma=None, beta=None, norm=None, order=None, centered_scale=None,
        dtype=None):
    """Generalized Morse Wavelet factory; returns ``fn(w, xp=torch)``.
    L1 ('bandpass', frequency-domain peak value 2) and L2 ('energy')
    normalizations, order 0 or order k through the Laguerre constants."""
    kw = gdefaults('gmw', gamma=gamma, beta=beta, norm=norm, order=order,
                   centered_scale=centered_scale)
    gamma, beta = float(kw['gamma']), float(kw['beta'])
    norm, k = kw['norm'], int(kw['order'])
    centered_scale = bool(kw['centered_scale'])
    _check_args(gamma=gamma, beta=beta, norm=norm, order=k,
                allow_zerobeta=False)
    if k == 0:
        fn = (gmw_l1(gamma, beta, centered_scale) if norm == 'bandpass'
              else gmw_l2(gamma, beta, centered_scale))
    else:
        fn = (gmw_l1_k(gamma, beta, k, centered_scale) if norm == 'bandpass'
              else gmw_l2_k(gamma, beta, k, centered_scale))
    fn.config = dict(gamma=gamma, beta=beta, norm=norm, order=k,
                     centered_scale=centered_scale)
    fn.qualname = 'gmw_l1' if norm == 'bandpass' else 'gmw_l2'
    return fn


def _make_fn(logconst, amp, gamma, beta, wc, centered_scale):
    """``amp * exp(logconst + beta ln w - w^gamma)`` for w > 0, else 0."""
    def fn(w, xp=torch):
        if xp is np:
            w = np.asarray(w)
            if centered_scale:
                w = w * np.asarray(np.asarray(wc, w.dtype))
            w_nonneg = (w >= 0)
            w = w * w_nonneg
            logw = np.log(np.where(w > 0, w, 1))
            out = amp * np.exp(np.asarray(np.asarray(logconst, w.dtype))
                               + beta * logw - w ** gamma)
            return np.where(w > 0, out, 0).astype(w.dtype)
        if centered_scale:
            w = w * wc
        w = w * (w >= 0)
        pos = w > 0
        logw = torch.log(torch.where(pos, w, torch.ones_like(w)))
        out = amp * torch.exp(logconst + beta * logw - w ** gamma)
        return torch.where(pos, out, torch.zeros_like(out))

    def derivatives(w):
        """(psih', psih'') at `w` (a tensor) in closed form. With u = wc w
        (wc = 1 unless centered): psih' = psih (beta - gamma u^gamma) / w,
        psih'' = psih ((beta - gamma u^gamma)^2 - beta - gamma (gamma - 1)
        u^gamma) / w^2; both 0 where psih is 0 (w <= 0 among them)."""
        psih = fn(w)
        ws = torch.where(w > 0, w, torch.ones_like(w))
        ug = (ws * wc if centered_scale else ws) ** gamma
        r = beta - gamma * ug
        d1 = psih * r / ws
        d2 = psih * (r * r - beta - gamma * (gamma - 1) * ug) / (ws * ws)
        live = psih != 0
        return (torch.where(live, d1, torch.zeros_like(d1)),
                torch.where(live, d2, torch.zeros_like(d2)))

    fn.derivatives = derivatives
    # the CUDA kernels synthesize psih, psih' and psih'' from these
    fn.kernel_params = dict(logconst=float(logconst), amp=float(amp),
                            gamma=float(gamma), beta=float(beta),
                            wc=float(wc) if centered_scale else 1.0)
    return fn


def gmw_l1(gamma=3., beta=60., centered_scale=False):
    """L1(bandpass)-normalized GMW:
    ``psih(w) = 2 exp(-beta ln wc + wc^gamma + beta ln w - w^gamma)``."""
    _check_args(gamma=gamma, beta=beta, allow_zerobeta=False)
    wc = morsefreq(gamma, beta)
    wcl = float(np.log(wc))
    const = float(-beta * wcl + wc ** gamma)
    return _make_fn(const, 2., gamma, beta, wc, centered_scale)


def gmw_l2(gamma=3., beta=60., centered_scale=False):
    """L2(energy)-normalized GMW:
    ``psih(w) = sqrt(2 pi gamma 2^r / Gamma(r)) w^beta exp(-w^gamma)``,
    r = (2 beta + 1)/gamma."""
    _check_args(gamma=gamma, beta=beta, allow_zerobeta=False)
    wc = morsefreq(gamma, beta)
    r = (2 * beta + 1) / gamma
    logconst = float(0.5 * (np.log(2 * pi * gamma) + r * np.log(2)
                            - gammaln_fn(r)))
    return _make_fn(logconst, 1., gamma, beta, wc, centered_scale)


def _gmw_k_constants(gamma, beta, k, norm='bandpass'):
    """Laguerre constants of the order-k GMW times its normalization
    (gammaln-stabilized); `coeffs[m]` multiplies (2 w^gamma)^m."""
    r = (2 * beta + 1) / gamma
    c = r - 1
    if norm == 'bandpass':
        coeff = np.sqrt(np.exp(gammaln_fn(r) + gammaln_fn(k + 1) -
                               gammaln_fn(k + r)))
    else:
        coeff = np.sqrt(2 * pi * gamma * (2 ** r) *
                        np.exp(gammaln_fn(k + 1) - gammaln_fn(k + r)))
    k_consts = _laguerre_coeffs(k, c) * coeff
    if norm == 'bandpass':
        k_consts = k_consts * 2
    return k_consts


def _make_fn_k(k_consts, logconst, gamma, beta, wc, centered_scale):
    """``L(2 w^gamma) exp(logconst + beta ln w - w^gamma)`` for w > 0,
    else 0, with L the polynomial of `k_consts`; xp-generic."""
    def fn(w, xp=torch):
        if xp is np:
            w = np.asarray(w)
            dt = w.dtype
            if centered_scale:
                w = w * np.asarray(np.asarray(wc, dt))
            w = w * (w >= 0)
            logw = np.log(np.where(w > 0, w, 1))
            wg = w ** gamma
            C = np.zeros_like(w)
            for m in range(len(k_consts)):
                C = C + np.asarray(np.asarray(k_consts[m], dt)) \
                    * (2 * wg) ** m
            out = C * np.exp(np.asarray(np.asarray(logconst, dt))
                             + beta * logw - wg)
            return np.where(w > 0, out, 0).astype(dt)
        if centered_scale:
            w = w * wc
        w = w * (w >= 0)
        pos = w > 0
        logw = torch.log(torch.where(pos, w, torch.ones_like(w)))
        wg = w ** gamma
        C = torch.zeros_like(w)
        for m in range(len(k_consts)):
            C = C + float(k_consts[m]) * (2 * wg) ** m
        out = C * torch.exp(logconst + beta * logw - wg)
        return torch.where(pos, out, torch.zeros_like(out))
    return fn


def gmw_l1_k(gamma=3., beta=60., k=1, centered_scale=False):
    """Order-k L1 (bandpass) GMW:
    ``psih(w) = L(2 w^gamma) exp(-beta ln wc + wc^gamma + beta ln w -
    w^gamma)``."""
    _check_args(gamma=gamma, beta=beta, allow_zerobeta=False)
    wc = morsefreq(gamma, beta)
    k_consts = _gmw_k_constants(gamma, beta, k, norm='bandpass')
    const = float(-beta * np.log(wc) + wc ** gamma)
    return _make_fn_k(k_consts, const, gamma, beta, wc, centered_scale)


def gmw_l2_k(gamma=3., beta=60., k=1, centered_scale=False):
    """Order-k L2 (energy) GMW: ``psih(w) = L(2 w^gamma) w^beta
    exp(-w^gamma)``."""
    _check_args(gamma=gamma, beta=beta, allow_zerobeta=False)
    wc = morsefreq(gamma, beta)
    k_consts = _gmw_k_constants(gamma, beta, k, norm='energy')
    return _make_fn_k(k_consts, 0., gamma, beta, wc, centered_scale)


# --------------------------------------------------------------------------
# host utilities (numpy)
# --------------------------------------------------------------------------
def compute_gmw(N, scale, gamma=3, beta=60, time=False, norm='bandpass',
                order=0, centered_scale=False, norm_scale=True, dtype=None):
    """A GMW as arrays: the frequency-domain psih (N,) on the analytic
    half (zero elsewhere), and with `time=True` the centered time-domain
    psi too. `norm_scale` multiplies the 'energy' norm by sqrt(scale)."""
    from .wavelets import _xifn
    _check_args(gamma=gamma, beta=beta, norm=norm, scale=scale)
    gmw_fn = gmw(gamma, beta, norm, order, centered_scale)

    w = _xifn(scale, N)
    X = np.zeros(N)
    X[:N // 2 + 1] = np.asarray(gmw_fn(w[:N // 2 + 1], xp=np))

    if norm == 'energy' and norm_scale:
        wc = morsefreq(gamma, beta)
        X *= (np.sqrt(wc * scale) if centered_scale else np.sqrt(scale))
    X[np.isinf(X) | np.isnan(X)] = 0.

    if time:
        return X, _spectrum_to_time(X)
    return X


def _spectrum_to_time(X, axis=0):
    """Frequency-domain wavelet -> centered time-domain wavelet: the
    alternating-sign multiply circularly centers the IFFT, and for even
    N the Nyquist bin is halved first (keeps the time-domain tail
    decaying)."""
    Xc = np.array(X, copy=True)
    n = Xc.shape[axis]
    if n % 2 == 0:
        nyq = [slice(None)] * Xc.ndim
        nyq[axis] = n // 2
        Xc[tuple(nyq)] = Xc[tuple(nyq)] / 2
    shape = [1] * Xc.ndim
    shape[axis] = n
    signs = ((-1.) ** np.arange(n)).reshape(shape)
    return np.fft.ifft(Xc * signs, axis=axis)


def _gmw_spectrum0(w, gamma, beta, norm, wp):
    """Zeroth-order GMW spectrum at radian frequencies `w`, log form
    (`wp` the peak frequency, anchoring the bandpass peak at 2). beta = 0
    is the pure lowpass exp(-w^gamma), its DC bin halved. Non-finite
    entries (log 0 at DC for beta > 0) are zeroed."""
    with np.errstate(divide='ignore', invalid='ignore'):
        if beta == 0:
            spec = np.exp(-w ** gamma)
            if norm == 'bandpass':
                spec = 2 * spec
            spec[0] = spec[0] / 2
        elif norm == 'energy':
            spec = np.exp(beta * np.log(w) - w ** gamma)
        else:
            peak_log = -beta * np.log(wp) + wp ** gamma
            spec = 2 * np.exp(peak_log + beta * np.log(w) - w ** gamma)
    spec[~np.isfinite(spec)] = 0.
    return spec


def _family_amplitude(gamma, beta, k, norm, stretch):
    """Normalization of the k-th member of the orthogonal family."""
    if norm == 'energy':
        return np.sqrt(1. / stretch) * morseafun(gamma, beta, k + 1,
                                                 norm='energy')
    if beta == 0:
        return 1.
    r = (2 * beta + 1) / gamma
    return np.sqrt(np.exp(gammaln_fn(r) + gammaln_fn(k + 1)
                          - gammaln_fn(k + r)))


def morsewave(N, freqs, gamma=3, beta=60, K=1, norm='bandpass'):
    """The first K orthogonal GMWs at (peak) radian frequencies `freqs`,
    the beta = 0 lowpass case included (after Olhede & Walden 2002).
    Returns (psih, psi), each (N, len(freqs), K) with length-1 axes
    dropped."""
    _check_args(gamma=gamma, beta=beta, norm=norm)
    freqs = np.atleast_1d(np.asarray(freqs, dtype=np.float64).squeeze())

    specs, waves = [], []
    for f in freqs:
        X, x = _morsewave_family(N, abs(f), gamma, beta, K, norm)
        if f < 0:
            x = x.conj()
            X = np.concatenate([X[:1], X[:0:-1]], axis=0)
        specs.append(X)
        waves.append(x)
    psif = np.stack(specs, axis=1)               # (N, n_freqs, K)
    psi = np.stack(waves, axis=1)
    return psif.squeeze(), psi.squeeze()


def _morsewave_family(N, f, gamma, beta, K, norm):
    """(psih, psi) of the K-member family at one center frequency: column
    k is `amplitude_k * spectrum0 * L_k^c(2 w^gamma)` on the non-negative
    half, taken to time by `_spectrum_to_time`."""
    wp = morsefreq(gamma, beta)
    stretch = f / wp
    w = (2 * pi / stretch) * np.linspace(0, 1, N, endpoint=False)
    base = _gmw_spectrum0(w, gamma, beta, norm, wp)

    half = slice(0, N // 2 + 1)
    c = (2 * beta + 1) / gamma - 1
    X = np.zeros((N, K))
    for k in range(K):
        Lk = np.zeros(N)
        Lk[half] = laguerre(2 * w[half] ** gamma, k, c)
        X[:, k] = _family_amplitude(gamma, beta, k, norm, stretch) \
            * base * Lk
    X[np.isinf(X)] = 0.
    return X, _spectrum_to_time(X, axis=0)


def morseafun(gamma, beta, k=1, norm='bandpass'):
    """GMW amplitude (the frequency-domain peak value)."""
    if norm == 'bandpass':
        if beta == 0:
            return 2.
        wp = morsefreq(gamma, beta)
        return 2. / np.exp(beta * np.log(wp) - wp ** gamma)
    if norm != 'energy':
        raise ValueError("unsupported `norm`: %s; must be one of: "
                         "'bandpass', 'energy'." % norm)
    r = (2 * beta + 1) / gamma
    return np.sqrt(2 * pi * gamma * (2 ** r)
                   * np.exp(gammaln_fn(k) - gammaln_fn(k + r - 1)))


def _laguerre_coeffs(k, c):
    """Coefficients of the generalized Laguerre polynomial L_k^c
    (coeffs[m] multiplies x^m), gammaln-stabilized."""
    m = np.arange(k + 1)
    logmag = (gammaln_fn(k + c + 1) - gammaln_fn(c + m + 1)
              - gammaln_fn(k - m + 1))
    return (-1.) ** m * np.exp(logmag) / gamma_fn(m + 1)


def laguerre(x, k, c):
    """Generalized Laguerre polynomial L_k^c(x), ascending powers."""
    x = np.atleast_1d(np.asarray(x).squeeze())
    assert x.ndim == 1
    y = np.zeros(x.shape)
    for m, cm in enumerate(_laguerre_coeffs(k, c)):
        y += cm * x ** m
    return y


def morsefreq(gamma, beta, n_out=1):
    """GMW frequency measures (radian), most used first: peak `wm`,
    energy `we`, instantaneous `wi`, curvature `cwi`; the first `n_out`
    of them (a float for n_out = 1, else a tuple)."""
    out = [(beta / gamma) ** (1 / gamma)]
    if n_out >= 2:
        out.append((1 / 2 ** (1 / gamma))
                   * (gamma_fn((2 * beta + 2) / gamma)
                      / gamma_fn((2 * beta + 1) / gamma)))
    if n_out >= 3:
        out.append(gamma_fn((beta + 2) / gamma)
                   / gamma_fn((beta + 1) / gamma))
    if n_out >= 4:
        k2 = _morsemom(2, gamma, beta, n_out=3)[-1]
        k3 = _morsemom(3, gamma, beta, n_out=3)[-1]
        out.append(-(k3 / k2 ** 1.5))
    return out[0] if n_out == 1 else tuple(out[:n_out])


def _energy_moment1(p, gamma, beta):
    """p-th frequency moment of the first-order GMW:
    amplitude x (1/(2 pi gamma)) Gamma((beta + p + 1)/gamma)."""
    mf = (1 / (2 * pi * gamma)) * gamma_fn((beta + p + 1) / gamma)
    return morseafun(gamma, beta, k=1) * mf


def _morsemom(p, gamma, beta, n_out=4):
    """p-th order frequency-domain moments (Mp of the wavelet, Np of its
    energy) and cumulants (Kp, Lp) of the first-order GMW."""
    Mp = _energy_moment1(p, gamma, beta)
    if n_out == 1:
        return Mp
    Np = (2 / 2 ** ((1 + p) / gamma)) * _energy_moment1(p, gamma, 2 * beta)
    if n_out == 2:
        return Mp, Np
    orders = np.arange(p + 1)
    Kp = _moments_to_cumulants(_energy_moment1(orders, gamma, beta))[p]
    if n_out == 3:
        return Mp, Np, Kp
    e_moments = (2 / 2 ** ((1 + orders) / gamma)) \
        * _energy_moment1(orders, gamma, 2 * beta)
    Lp = _moments_to_cumulants(e_moments)[p]
    return Mp, Np, Kp, Lp


def _moments_to_cumulants(moments):
    """Raw moments -> cumulants by the recurrence
    kappa_n = m_n/m_0 - sum_k C(n-1, k-1) kappa_k m_{n-k}/m_0."""
    from math import comb
    moments = np.atleast_1d(np.asarray(moments).squeeze())
    assert moments.ndim == 1
    scaled = moments / moments[0]
    cumulants = np.zeros(len(moments))
    cumulants[0] = np.log(moments[0])
    for n in range(1, len(moments)):
        acc = scaled[n]
        for k in range(1, n):
            acc = acc - comb(n - 1, k - 1) * cumulants[k] * scaled[n - k]
        cumulants[n] = acc
    return cumulants
