# -*- coding: utf-8 -*-
"""Continuous Wavelet Transform (forward & inverse).

Counterpart of `ssqueezepy_tpu/models/cwt.py`: wavelet resolution, the
analytic half-spectrum FFT convolution `cwt_core` (the plain PyTorch
version of the kernels in `ops/cwt_cuda.py`), the general FFT
convolution `cwt_general`, the public `cwt` for 1-D and batched 2-D
input, `cwt_higher_order` (GMW of orders 0..k, averaged) and `icwt` (one-
and two-integral). `cwt` routes as the JAX package's gates do:

  * an analytic wavelet with a real-valued spectrum (GMW of any order,
    cmhat, hhhat with mu >= 0, bump with mu - .999 s >= 0 and om = 0):
    at a padded length n_up (n_up = N with `padtype=None`) whose prime
    factors are at most 7 (`ops/cwt_cuda.py::kernel_length`): pad ->
    `torch.fft.rfft` -> the fused CWT kernel (`cwt_fused`; the order-0
    GMW synthesized in the kernel, every other wavelet read from its
    table); with ``device='cpu'`` its plain version. Its DFT factors must
    fit one block's shared memory (`ops/cwt_cuda.py::cwt_length_rule`: a
    padded N up to n_up = 2^28, one plane, float32); past that a call
    raises on every device, before the signal's FFT;
  * any other wavelet (morlet, hhhat with mu < 0, another bump, a user's
    callable), and any wavelet at an n_up with a prime factor above 7
    (an unpadded N such as 1031 or 2002): `cwt_general`, the JAX
    package's XLA branch, by `torch.fft` on the signal's device, at any
    length. The route is decided by the wavelet and n_up before anything
    runs (`_kernel_route`).
"""
import numpy as np
import torch

from ..configs import device_dtype
from ..ops.cwt_cuda import (cwt_fused, cwt_length_rule, kernel_length,
                             wavelet_table, _halve_nyquist)
from ..ops.fft import fft, ifft, rfft
from ..ops.pad import padsignal, pad_params, _MODE_MAP
from ..utils.common import WARN, numpy_unless_grad, resolve_device
from ..utils.cwt_utils import (process_scales, logscale_transition_idx,
                               adm_ssq, adm_cwt, _process_fs_and_t)
from .wavelets import Wavelet, _xifn

__all__ = ['cwt', 'icwt', 'cwt_core', 'cwt_general', 'cwt_higher_order',
           'resolve_wavelet', 'cwt_spectrum', 'padded_length']


def _is_analytic(wavelet):
    """True if the freq-domain wavelet is exactly zero for w < 0 (the
    half-spectrum routes): GMW, cmhat, hhhat with mu >= 0, bump with
    mu - .999 s >= 0. Morlet and a user's callable are only approximately
    analytic."""
    name = getattr(wavelet.fn, 'qualname', '')
    if name.startswith('gmw') or name in ('cmhat',):
        return True
    if name == 'hhhat':
        return wavelet.config.get('mu', 5) >= 0
    if name == 'bump':
        mu, s = wavelet.config.get('mu', 5), wavelet.config.get('s', 1)
        return mu - s * .999 >= 0
    return False


def _is_custom(wavelet):
    """True for a user's callable (not one of this package's wavelets)."""
    fn = wavelet.fn
    return hasattr(fn, 'user_fn') or not hasattr(fn, 'qualname')


def _is_real(wavelet):
    """True if the wavelet's spectrum is real-valued (a pair (re, im) or
    a complex tensor is not), probed at one frequency once per Wavelet
    (the probe's torch ops cost tens of microseconds a call)."""
    def probe():
        psih = wavelet.fn(torch.zeros(1, dtype=getattr(torch,
                                                       wavelet.dtype)),
                          xp=torch)
        return not (isinstance(psih, tuple) or psih.is_complex())
    return wavelet._cached('is_real', probe)


def _kernel_route(wavelet, n_up):
    """True where the CWT kernel computes the transform: an analytic
    wavelet with a real-valued spectrum at a padded length n_up whose
    prime factors are at most 7 (`ops/cwt_cuda.py::kernel_length`; the
    JAX package's gate of its Pallas kernel takes both); else the general
    path (`cwt_general`)."""
    return (kernel_length(n_up) and _is_analytic(wavelet)
            and _is_real(wavelet))


def _wavelet_key(wavelet):
    """Plan and table key of one of this package's wavelets: its name,
    configuration and dtype. A user's callable has none: it is kept out of
    every process-wide cache (its name does not tell two functions apart,
    and keying by the function would keep each fresh lambda alive for
    good), so its plan, scales and table are made anew per call."""
    cfg = tuple(sorted((k, str(v)) for k, v in wavelet.config.items()))
    return (wavelet.fn.qualname, cfg, wavelet.dtype)


_WAVELET_CANON = {}
_SPEC_WAVELET_CACHE = {}


def _canonical_wavelet(wavelet):
    """One Wavelet per configuration of this package's wavelets, so plan
    caches keyed on it stay hot across calls; a user's callable is its own
    Wavelet, cached nowhere."""
    if _is_custom(wavelet):
        return wavelet
    return _WAVELET_CANON.setdefault(_wavelet_key(wavelet), wavelet)


def resolve_wavelet(wavelet, l1_norm=True, N=None):
    """Spec -> canonical Wavelet, memoized per (spec, l1_norm, N) for a
    name or (name, dict) spec."""
    if isinstance(wavelet, Wavelet):
        return _canonical_wavelet(wavelet)
    key = None
    if isinstance(wavelet, (str, tuple)):
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
    if key is not None and not _is_custom(w):
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


def _convolve(Psih_xh, xi, scales, n_up, n1, N, dt, derivative, l1_norm):
    """(Wx, dWx or None) from the product of the wavelet and the signal's
    spectrum on the grid `xi` (the half or the full one): the inverse FFT
    kept to [n1, n1+N), dWx from the spectrum times i xi / dt, and the
    sqrt(scale) norm for L2."""
    out_range = (n1, n1 + N)
    Wx = ifft(Psih_xh, n=n_up, out_range=out_range)
    dWx = None
    if derivative:
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


def cwt_core(xh, wavelet, scales, n_up, n1, N, dt, derivative, l1_norm,
             table=None):
    """CWT rows from the half spectrum `xh` (complex, n_up//2 + 1) of the
    padded signal — the analytic branch of the JAX package's `cwt_core`:
    the wavelet (its table, `ops/cwt_cuda.py::wavelet_table`) on the half
    grid (it is zero on the negative half), the Nyquist bin halved, and
    the inverse FFT kept to [n1, n1+N). `scales` is a real (na,) tensor on
    xh's device; `xh` may be a (B, n_up//2 + 1) batch; `table`, where
    given, is that wavelet table already made. Returns (Wx, dWx or None),
    complex (na, N) or (B, na, N)."""
    half = n_up // 2 + 1
    xi = torch.as_tensor(_xifn(1., n_up)[:half], dtype=scales.dtype,
                         device=scales.device)
    psih = wavelet_table(wavelet, scales, n_up) if table is None else table
    Psih_xh = psih * _halve_nyquist(xh, n_up).unsqueeze(-2)
    return _convolve(Psih_xh, xi, scales, n_up, n1, N, dt, derivative,
                     l1_norm)


def cwt_general(xp, wavelet, scales, n1, N, dt, derivative, l1_norm):
    """CWT rows of the padded real signal `xp` ((n_up,) or a (B, n_up)
    batch) for any wavelet — the JAX package's XLA branch of `cwt_core`,
    by `torch.fft` on xp's device: the full spectrum and the wavelet on
    the full grid, or for an analytic wavelet with a complex spectrum the
    half of both; the Nyquist bin halved; the inverse FFT kept to
    [n1, n1+N). `scales` a real (na,) tensor on xp's device. Returns (Wx,
    dWx or None), complex (na, N) or (B, na, N). Counts its calls on
    `cwt_general.calls`."""
    cwt_general.calls += 1
    n_up = xp.shape[-1]
    analytic = _is_analytic(wavelet)
    half = n_up // 2 + 1
    xh = rfft(xp) if analytic else fft(xp)
    xi = torch.as_tensor(_xifn(1., n_up)[:half] if analytic else
                         _xifn(1., n_up), dtype=scales.dtype,
                         device=scales.device)
    psih = wavelet.fn(scales.reshape(-1, 1) * xi, xp=torch)
    if isinstance(psih, tuple):                     # complex wavelet
        psih = torch.complex(*psih)
    if n_up % 2 == 0:                               # Nyquist halving
        psih = psih.clone()
        psih[..., n_up // 2] /= 2
    Psih_xh = psih * xh.unsqueeze(-2)
    Wx, dWx = _convolve(Psih_xh, xi, scales, n_up, n1, N, dt, derivative,
                        l1_norm)
    return Wx.contiguous(), (None if dWx is None else dWx.contiguous())


cwt_general.calls = 0


def padded_length(N, padtype):
    """n_up, the length the CWT transforms: `pad_params`' padded length,
    or N itself with `padtype=None`."""
    return N if padtype is None else pad_params(N, padtype)[0]


def padded_signal(xt, padtype):
    """(xp, n_up, n1): the real signal or batch `xt` padded by `padtype`
    to n_up (`pad_params`, left pad n1), or with `padtype=None` `xt`
    itself (n_up = N, n1 = 0)."""
    N = xt.shape[-1]
    if padtype is None:
        return xt, N, 0
    n_up, n1, _ = pad_params(N, padtype)
    return padsignal(xt, padtype), n_up, n1


def cwt_spectrum(xt, padtype, planes):
    """(xh, n_up, n1): the half spectrum (B?, n_up//2 + 1) of the real
    signal or batch `xt` padded by `padtype` to n_up (`pad_params`, left
    pad n1), or with `padtype=None` of `xt` itself (n_up = N, n1 = 0), as
    the JAX package's CWT entry points take it. n_up is checked against
    the CWT kernel's length rule for the route's `planes` (1: Wx; 2: bins
    or derivative; 5: order 2) before anything runs on the device."""
    n_up = padded_length(xt.shape[-1], padtype)
    cwt_length_rule(n_up, 2 * xt.element_size(), planes)
    xp, n_up, n1 = padded_signal(xt, padtype)
    return rfft(xp).contiguous(), n_up, n1


_SCALES_CACHE = {}


def _cached_scales(scales, N, wavelet, nv, dtype, device):
    """(scales numpy (na, 1), scales (na,) tensor on `device`), memoized
    for string specs and arrays: the log-piecewise redundancy scan costs
    milliseconds, and a per-call upload is a pageable copy that blocks
    the host until the stream drains. Not for a user's callable."""
    if _is_custom(wavelet):
        key = None
    elif isinstance(scales, str):
        key = (scales, N, _wavelet_key(wavelet), nv, dtype, str(device))
    elif isinstance(scales, np.ndarray):
        key = (hash(scales.tobytes()), scales.shape, str(scales.dtype), N,
               _wavelet_key(wavelet), nv, dtype, str(device))
    else:
        key = None
    hit = _SCALES_CACHE.get(key) if key is not None else None
    if hit is None:
        s_np = process_scales(scales, N, wavelet, nv=nv)
        hit = (s_np, torch.as_tensor(np.asarray(s_np, np.float64).reshape(-1),
                                     dtype=dtype, device=device))
        if key is not None:
            _SCALES_CACHE[key] = hit
    return hit


_CWT_CHUNK = 64


def cwt(x, wavelet='gmw', scales='log-piecewise', fs=None, t=None, nv=32,
        l1_norm=True, derivative=False, padtype='reflect', rpadded=False,
        vectorized=True, astensor=True, cache_wavelet=None, order=0,
        average=None, nan_checks=None, patience=0, device='cuda'):
    """Continuous Wavelet Transform of a 1-D signal or a 2-D batch (B, N)
    by frequency-domain convolution.

    Returns (Wx, scales[, dWx]): Wx (na, N) or (B, na, N) complex
    tensors on `device` (numpy with `astensor=False`), scales (na,).
    `wavelet` is a name ('gmw', 'morlet', 'bump', 'cmhat', 'hhhat'), a
    (name, dict) pair, a `Wavelet` or a function of a torch tensor of
    radian frequencies. `padtype=None` transforms the signal unpadded
    (n_up = N; an N with a prime factor above 7 takes `cwt_general`);
    `rpadded=True` returns the whole padded transform, (na, n_up) or
    (B, na, n_up). `l1_norm=False` uses the L2 ('energy') GMW and
    multiplies rows by sqrt(scale); `vectorized=False` runs the scales in
    chunks of 64 rows. `order` > 0 or a tuple of orders runs
    `cwt_higher_order`. `cache_wavelet`, `nan_checks` and `patience` are
    accepted for compatibility; non-finite input samples are zeroed."""
    device = resolve_device(device)
    if isinstance(order, (tuple, list, range)) or order > 0:
        kw = dict(wavelet=wavelet, scales=scales, fs=fs, t=t, nv=nv,
                  l1_norm=l1_norm, derivative=derivative, padtype=padtype,
                  rpadded=rpadded, device=device)
        return cwt_higher_order(x, order=order, average=average,
                                astensor=astensor, **kw)
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    if x.ndim not in (1, 2):
        raise ValueError("`x` must be 1D or 2D (got x.ndim == %s)" % x.ndim)
    N = x.shape[-1]
    dt, _, _ = _process_fs_and_t(fs, t, N)

    wavelet = resolve_wavelet(wavelet, l1_norm)
    dtype = getattr(torch, device_dtype(wavelet.dtype))
    scales_np, sc = _cached_scales(scales, N, wavelet, nv, dtype, device)

    xt = torch.as_tensor(x, dtype=dtype, device=device)
    xt = torch.where(torch.isfinite(xt), xt, torch.zeros_like(xt))
    if _kernel_route(wavelet, padded_length(N, padtype)):
        xh, n_up, n1 = cwt_spectrum(xt, padtype, 2 if derivative else 1)

        def rows(s):
            return cwt_fused(xh, s, wavelet, n_up, n1, N, dt, derivative,
                             l1_norm)
    else:
        xp, n_up, n1 = padded_signal(xt, padtype)

        def rows(s):
            return cwt_general(xp, wavelet, s, n1, N, dt, derivative,
                               l1_norm)
    if rpadded:                        # the whole padded transform
        n1, N = 0, n_up
    if vectorized:
        Wx, dWx = rows(sc)
    else:
        parts = [rows(sc[c0:c0 + _CWT_CHUNK])
                 for c0 in range(0, len(sc), _CWT_CHUNK)]
        Wx = torch.cat([p[0] for p in parts], dim=-2)
        dWx = (torch.cat([p[1] for p in parts], dim=-2) if derivative
               else None)

    scales_out = scales_np.squeeze()
    if not astensor:
        Wx = Wx.cpu().numpy()
        dWx = dWx.cpu().numpy() if dWx is not None else None
    return (Wx, scales_out, dWx) if derivative else (Wx, scales_out)


def cwt_higher_order(x, wavelet='gmw', order=1, average=None, astensor=True,
                     **kw):
    """CWT with the higher-order GMWs (the orthogonal family of orders
    0..k), one `cwt` per order at the order-0 GMW's scales, averaged when
    `average` (by default with more than one order; a tuple of orders
    without it returns a list). `wavelet` must be a GMW; the orders'
    wavelets take its configuration (not its dtype), as the JAX package
    builds them."""
    if isinstance(order, (list, range)):
        order = tuple(order)
    if not isinstance(order, tuple):
        order = (order,)
        if average:
            WARN("`average` ignored with single `order`")
            average = False
    wavelet_ = Wavelet._init_if_not_isinstance(wavelet)
    if not wavelet_.name.lower().startswith('gmw'):
        raise ValueError("`wavelet` must be GMW for higher-order "
                         "transforms (got %s)" % wavelet_.name)
    wavopts = dict(wavelet_.config)
    wavopts.pop('order', None)
    wavelets = [Wavelet(('gmw', dict(order=k, **wavopts))) for k in order]

    scales = kw.pop('scales', 'log-piecewise')
    if isinstance(scales, str):
        wav0 = Wavelet(('gmw', dict(order=0, **wavopts)))
        scales = process_scales(scales, x.shape[-1], wavelet=wav0,
                                nv=kw.get('nv', 32))
    kw['scales'] = scales

    derivative = kw.get('derivative', False)
    Wx_all, dWx_all = [], []
    for wav in wavelets:
        out = cwt(x, wav, order=0, astensor=True, **kw)
        Wx_all.append(out[0])
        if derivative:
            dWx_all.append(out[-1])

    if average or (average is None and len(order) > 1):
        Wx_all = torch.stack(Wx_all).mean(dim=0)
        if derivative:
            dWx_all = torch.stack(dWx_all).mean(dim=0)
    elif len(Wx_all) == 1:
        Wx_all = Wx_all[0]
        if derivative:
            dWx_all = dWx_all[0]

    scales_out = np.asarray(scales).squeeze()
    if not astensor:
        conv = (lambda W: W.cpu().numpy() if isinstance(W, torch.Tensor)
                else [g.cpu().numpy() for g in W])
        Wx_all = conv(Wx_all)
        if derivative:
            dWx_all = conv(dWx_all)
    return ((Wx_all, scales_out, dWx_all) if derivative else
            (Wx_all, scales_out))


def icwt(Wx, wavelet='gmw', scales='log-piecewise', nv=None, one_int=True,
         x_len=None, x_mean=0, padtype='reflect', rpadded=False,
         l1_norm=True):
    """Inverse CWT by the one-integral (default) or the double-integral
    formula; log-piecewise scales are inverted piece by piece. `Wx` a
    complex tensor (the one-integral sum runs on its device) or numpy
    array; returns numpy, or for the one-integral inverse of a tensor that
    requires grad a tensor on its device carrying the graph."""
    *_, na, n = Wx.shape
    x_len = x_len or n
    if not isinstance(scales, np.ndarray) and nv is None:
        nv = 32

    wavelet = _process_gmw_wavelet(wavelet, l1_norm)
    wavelet = Wavelet._init_if_not_isinstance(wavelet)
    scales, scaletype, _, nv = process_scales(scales, x_len, wavelet, nv=nv,
                                              get_params=True)
    assert (len(scales) == na), "%s != %s" % (len(scales), na)

    if scaletype == 'log-piecewise':
        kw = dict(wavelet=wavelet, one_int=one_int, x_len=x_len,
                  x_mean=x_mean, padtype=padtype, rpadded=rpadded,
                  l1_norm=l1_norm)
        idx = logscale_transition_idx(scales)
        return (icwt(Wx[..., :idx, :], scales=scales[:idx], **kw)
                + icwt(Wx[..., idx:, :], scales=scales[idx:], **kw))

    if one_int:
        x = _icwt_1int(Wx, scales, scaletype, l1_norm)
    else:
        if Wx.ndim == 3:
            raise NotImplementedError("batched `Wx` requires "
                                      "`one_int=True`.")
        if isinstance(Wx, torch.Tensor):
            Wx = Wx.cpu().numpy()
        x = _icwt_2int(Wx, scales, scaletype, l1_norm, wavelet, x_len,
                       padtype, rpadded)

    Cpsi = (adm_ssq(wavelet) if one_int else adm_cwt(wavelet))
    if scaletype == 'log':
        # ln(2**(1/nv)) == ln(2)/nv == diff(ln(scales))[0]
        x = x * ((2 / Cpsi) * np.log(2 ** (1 / nv)))
    else:
        x = x * ((2 / Cpsi) * np.pi / 4)
    return x + x_mean


def _icwt_norm(scaletype, l1_norm):
    if l1_norm:
        return ((lambda scale: 1) if scaletype == 'log' else
                (lambda scale: scale))
    if scaletype == 'log':
        return lambda scale: scale ** .5
    return lambda scale: scale ** 1.5


def _icwt_1int(Wx, scales, scaletype, l1_norm):
    """One-integral inverse: sum over scales of Re(Wx) / norm(scale); a
    tensor is reduced on its device."""
    norm = _icwt_norm(scaletype, l1_norm)
    if isinstance(Wx, torch.Tensor):
        Wr = Wx.real
        nrm = np.broadcast_to(np.asarray(norm(scales), np.float64),
                              (len(np.atleast_1d(scales)), 1))
        nrm = torch.as_tensor(np.array(nrm), dtype=Wr.dtype,
                              device=Wr.device)
        return numpy_unless_grad((Wr / nrm).sum(dim=-2))
    return (Wx.real / norm(scales)).sum(axis=-2)


def _icwt_2int(Wx, scales, scaletype, l1_norm, wavelet, x_len,
               padtype='zero', rpadded=False):
    """Double-integral inverse: per-scale FFT deconvolution (host
    numpy)."""
    if not rpadded:
        n_up, n1, n2 = pad_params(Wx.shape[-1], padtype or 'zero')
        Wx = np.pad(Wx, ((0, 0), (n1, n2)),
                    mode=_MODE_MAP[padtype or 'zero'])
    else:
        n_up, n1 = Wx.shape[-1], 0

    norm = _icwt_norm(scaletype, l1_norm)
    pn = (-1) ** np.arange(n_up)
    x = np.zeros(n_up)
    for scale, Wx_scale in zip(np.asarray(scales).reshape(-1), Wx):
        psih = wavelet.filterbank_np(np.atleast_1d(np.float64(scale)),
                                     N=n_up, nohalf=True)[0] * pn
        xa = np.fft.ifftshift(np.fft.ifft(np.fft.fft(Wx_scale) * psih))
        x += xa.real / norm(float(scale))
    return x[n1:n1 + x_len]
