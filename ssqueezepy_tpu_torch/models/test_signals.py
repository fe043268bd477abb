# -*- coding: utf-8 -*-
"""Test-signal catalog: tones, chirps (linear / exponential /
hyperbolic), composites (jumps, packed bands, polynomial FM) and
amplitude modulators, with the anti-alias N estimate and noise injection.

Counterpart of `ssqueezepy_tpu/models/test_signals.py` (own copy: this
package imports nothing of the JAX package): the same formulas, catalog
names, `DEFAULT_*` settings, `make_signals` grammar (``#``-reflection,
``carrier:am``) and `get_params` output, so the same N, snr and seed
give bit-identical signals. Pure numpy and scipy: signals are made on
the host. The drawing methods (`demo`, `test_transforms`, `wavcomp`,
`cwt_vs_stft`, `ridgecomp`) draw through `visuals`; those that run a
transform run the port's on `device` ('cuda' unless the caller passes
'cpu').
"""
import numpy as np
import scipy.signal as sig

from ..utils.common import WARN, pi

__all__ = ['TestSignals']

TAU = 2 * pi

DEFAULT_N = 512
DEFAULT_ARGS = {
    'cosine': dict(f=64, phi0=0),
    'sine':   dict(f=64, phi0=0),
    'lchirp': dict(tmin=0, tmax=1, fmin=0, fmax=None),
    'echirp': dict(tmin=0, tmax=1, fmin=1, fmax=None),
    'hchirp': dict(tmin=0, tmax=1, fmin=1, fmax=None),
    'jumps':  dict(),
    'low':    dict(),
    'am-cosine': dict(amin=.1),
    'am-sine':   dict(amin=.1),
    'am-exp':    dict(amin=.1),
    'am-gauss':  dict(amin=.01),
    'sine:am-cosine': (dict(f=16), dict(amin=.5)),
}
DEFAULT_TKW = dict(tmin=0, tmax=1, endpoint=True)
# module-level noise knobs (as in ssqueezepy's `_test_signals.py`): set e.g.
# `test_signals.DEFAULT_SNR = 10` to make every TestSignals noisy
DEFAULT_SNR = None
DEFAULT_SEED = None


# ---------------------------------------------------------------------------
# phase laws: closed-form sweeps fmin -> fmax over [tmin, tmax].
# Each law returns (phase(t), angular_frequency(t)) — phase referenced to
# phi(tmin) = 0 so every chirp starts at zero phase.
# ---------------------------------------------------------------------------
def _law_linear(t, tmin, tmax, fmin, fmax):
    """f(t) = a t + b."""
    slope = (fmax - fmin) / (tmax - tmin)
    f0 = (fmin * tmax - fmax * tmin) / (tmax - tmin)
    phi = TAU * (slope / 2 * (t**2 - tmin**2) + f0 * (t - tmin))
    return phi, TAU * (slope * t + f0)


def _law_exp(t, tmin, tmax, fmin, fmax):
    """f(t) = a b^t (geometric sweep)."""
    a = (fmin**tmax / fmax**tmin) ** (1. / (tmax - tmin))
    b = (fmax / a) ** (1. / tmax)
    phi = TAU * (a / np.log(b)) * (b**t - b**tmin)
    return phi, TAU * a * b**t


def _law_exp_pc(t, tmin, tmax, fmin, fmax):
    """f(t) = A e^t + B ('exponential plus constant')."""
    span = np.exp(tmax) - np.exp(tmin)
    A = (fmax - fmin) / span
    B = (fmin * np.exp(tmax) - fmax * np.exp(tmin)) / span
    phi = TAU * (A * (np.exp(t) - np.exp(tmin)) + B * (t - tmin))
    return phi, TAU * (A * np.exp(t) + B)


def _law_hyperbolic(t, tmin, tmax, fmin, fmax):
    """f(t) = A / (B - t)^2, the unique such curve through
    (tmin, fmin) and (tmax, fmax)."""
    u, v = fmin, fmax
    dt2 = (tmin - tmax) ** 2
    root = np.sqrt(u**3 * v**3 * dt2**2)
    A = (2 * root + u**2 * v * dt2 + u * v**2 * dt2) / (u - v)**2
    B = ((root + u**2 * v * tmin * (tmin - tmax)
          + u * v**2 * tmax * (tmax - tmin))
         / (u * v * (u - v) * (tmin - tmax)))
    phi = TAU * A * (1. / (B - t) + 1. / (tmin - B))
    return phi, TAU * A / (B - t)**2


_PHASE_LAWS = {'lchirp': _law_linear, 'echirp': _law_exp,
               'echirp_pc': _law_exp_pc, 'hchirp': _law_hyperbolic}

# parallel-pair geometry per chirp family: how the second sweep derives
# from the first (up) and the first from the Nyquist cap (down)
_PAR_RULES = {
    'lchirp': dict(up=lambda f, N: f + N / 10, down=lambda f, N: f - N / 10,
                   fmin_key='lchirp'),
    'echirp': dict(up=lambda f, N: f * 1.5, down=lambda f, N: f / 1.5,
                   fmin_key='echirp'),
    'hchirp': dict(up=lambda f, N: f * 3, down=lambda f, N: f / 3,
                   fmin_key='hchirp'),
}


def _timegrid(tmin, tmax, N, endpoint=False):
    return np.linspace(tmin, tmax, N, endpoint=endpoint)


class TestSignals():
    """Named test-signal generator (the API of ssqueezepy's
    `TestSignals`). `make_signals` is the batch generator; every
    catalog entry is also an individual method returning ``(x, t)``."""
    __test__ = False          # not a pytest class despite the name
    SUPPORTED = ['cosine', 'sine', 'lchirp', 'echirp', 'echirp_pc',
                 'hchirp', 'par-lchirp', 'par-echirp', 'par-hchirp',
                 'jumps', 'packed', 'packed-poly', 'poly-cubic',
                 'am-sine', 'am-cosine', 'am-exp', 'am-gauss']
    DEMO = ['cosine', 'sine',
            'lchirp', 'echirp', 'hchirp',
            '#lchirp', '#echirp', '#hchirp',
            'par-lchirp', 'par-echirp', 'par-hchirp', '#par-lchirp',
            'jumps', 'packed', 'packed-poly', 'poly-cubic',
            'am-sine', 'am-cosine', 'am-exp', 'am-gauss']

    def __init__(self, N=None, snr=None, default_args=None, default_tkw=None,
                 warn_alias=True, seed=None):
        self.N = N or DEFAULT_N
        self.snr = DEFAULT_SNR if snr is None else snr
        self.warn_alias = warn_alias
        self.seed = DEFAULT_SEED if seed is None else seed
        self.default_args = {**DEFAULT_ARGS, **dict(default_args or {})}
        self.default_tkw = {**DEFAULT_TKW, **dict(default_tkw or {})}

    # ---- shared plumbing --------------------------------------------------
    def _alias_check(self, name, phi, tol=.02):
        """Warn when the phase increment exceeds pi (Nyquist) anywhere."""
        if not self.warn_alias:
            return
        step = np.diff(phi).max()
        if step - pi > tol:
            WARN("signal '%s' aliases: max phase step %.6f > pi=%.6f"
                 % (name, step, pi))

    def _resolve_tkw(self, tkw):
        merged = dict(self.default_tkw)
        merged.update(tkw)
        return merged

    def _resolve_N(self, N, law, tkw, fmin, fmax):
        """Given sweep bounds, pick the smallest alias-free N; fall back
        to the instance default when any bound is open."""
        if N is not None:
            return N
        if law is None or None in (tkw['tmin'], tkw['tmax'], fmin, fmax):
            return self.N
        w_of = lambda *a, **kw: law(*a, **kw)[1]
        return self._est_N_nonalias(w_of, tkw['tmin'], tkw['tmax'],
                                    fmin, fmax)

    @staticmethod
    def _est_N_nonalias(f_fn, tmin, tmax, fmin, fmax):
        """Smallest N with max instantaneous (angular) frequency below
        Nyquist for the sweep (as ssqueezepy estimates it)."""
        dense = np.linspace(tmin, tmax, 50000, endpoint=True)
        w_peak = np.max(f_fn(dense, tmin, tmax, fmin, fmax))
        return int(np.ceil(1 + w_peak * (tmax - tmin) / pi))

    # ---- tones --------------------------------------------------------------
    def _tone(self, trig, name, N, f, phi0, tkw):
        tkw.setdefault('endpoint', False)
        tkw = self._resolve_tkw(tkw)
        N = N or self.N
        t = _timegrid(tkw['tmin'], tkw['tmax'], N, tkw['endpoint'])
        phi = TAU * f * t + phi0
        self._alias_check(name, phi)
        return trig(phi), t

    def sine(self, N=None, f=1, phi0=0, **tkw):
        return self._tone(np.sin, 'sine', N, f, phi0, tkw)

    def cosine(self, N=None, f=1, phi0=0, **tkw):
        return self._tone(np.cos, 'cosine', N, f, phi0, tkw)

    # ---- chirps (phase-law registry) ----------------------------------------
    def _chirp(self, name, N, fmin, fmax, tkw):
        law = _PHASE_LAWS[name]
        tkw = self._resolve_tkw(tkw)
        N = self._resolve_N(N, law, tkw, fmin, fmax)
        if fmax is None:
            fmax = N // 2
        t = _timegrid(tkw['tmin'], tkw['tmax'], N, tkw['endpoint'])
        phi, _ = law(t, tkw['tmin'], tkw['tmax'], fmin, fmax)
        self._alias_check(name, phi)
        return np.cos(phi), t

    def lchirp(self, N=None, fmin=0, fmax=None, **tkw):
        """Linear sweep fmin -> fmax."""
        return self._chirp('lchirp', N, fmin, fmax, tkw)

    def echirp(self, N=None, fmin=1, fmax=None, **tkw):
        """Geometric (exponential) sweep."""
        return self._chirp('echirp', N, fmin, fmax, tkw)

    def echirp_pc(self, N=None, fmin=0, fmax=None, **tkw):
        """Exponential-plus-constant sweep."""
        return self._chirp('echirp_pc', N, fmin, fmax, tkw)

    def hchirp(self, N=None, fmin=.1, fmax=None, **tkw):
        """Hyperbolic sweep."""
        return self._chirp('hchirp', N, fmin, fmax, tkw)

    # legacy static phase functions (kept for callers that sample the
    # laws directly, e.g. the anti-alias estimator in tests and `am_exp`)
    @staticmethod
    def _lchirp_fn(t, tmin, tmax, fmin, fmax, get_w=False):
        phi, w = _law_linear(t, tmin, tmax, fmin, fmax)
        return (phi, w) if get_w else phi

    @staticmethod
    def _echirp_fn(t, tmin, tmax, fmin, fmax, get_w=False):
        phi, w = _law_exp(t, tmin, tmax, fmin, fmax)
        return (phi, w) if get_w else phi

    @staticmethod
    def _echirp_pc_fn(t, tmin, tmax, fmin, fmax, get_w=False):
        phi, w = _law_exp_pc(t, tmin, tmax, fmin, fmax)
        return (phi, w) if get_w else phi

    @staticmethod
    def _hchirp_fn(t, tmin, tmax, fmin, fmax, get_w=False):
        phi, w = _law_hyperbolic(t, tmin, tmax, fmin, fmax)
        return (phi, w) if get_w else phi

    # ---- parallel chirp pairs -----------------------------------------------
    def _par_chirp(self, family, N, fmin1, fmax1, fmin2, fmax2, tkw):
        rule = _PAR_RULES[family]
        N = N or self.N
        if fmin1 is None:
            fmin1 = self.default_args[rule['fmin_key']].get(
                'fmin', 1 if family != 'lchirp' else 0)
        if fmin2 is None:
            fmin2 = rule['up'](fmin1, N)
        if fmax1 is None:
            fmax2 = N / 2
            fmax1 = rule['down'](fmax2, N)
        elif fmax2 is None:
            fmax2 = min(N / 2, rule['up'](fmax1, N))
        gen = getattr(self, family)
        x1, t = gen(N, fmin1, fmax1, **tkw)
        x2, _ = gen(N, fmin2, fmax2, **tkw)
        return x1 + x2, t

    def par_lchirp(self, N=None, fmin1=None, fmax1=None, fmin2=None,
                   fmax2=None, **tkw):
        return self._par_chirp('lchirp', N, fmin1, fmax1, fmin2, fmax2,
                               tkw)

    def par_echirp(self, N=None, fmin1=None, fmax1=None, fmin2=None,
                   fmax2=None, **tkw):
        return self._par_chirp('echirp', N, fmin1, fmax1, fmin2, fmax2,
                               tkw)

    def par_hchirp(self, N=None, fmin1=None, fmax1=None, fmin2=None,
                   fmax2=None, **tkw):
        return self._par_chirp('hchirp', N, fmin1, fmax1, fmin2, fmax2,
                               tkw)

    # ---- amplitude modulators -------------------------------------------
    def _am_from_tone(self, trig_method, N, f, amin, amax, phi, tkw):
        wave, t = trig_method(N or self.N, f, phi, **tkw)
        unit = .5 * (wave + 1)              # [-1, 1] -> [0, 1]
        return amin + (amax - amin) * unit, t

    def am_sine(self, N=None, f=1, amin=0, amax=1, phi=0, **tkw):
        return self._am_from_tone(self.sine, N, f, amin, amax, phi, tkw)

    def am_cosine(self, N=None, f=1, amin=0, amax=1, phi=0, **tkw):
        return self._am_from_tone(self.cosine, N, f, amin, amax, phi, tkw)

    def am_exp(self, N=None, amin=.1, amax=1, **tkw):
        """Exponential ramp amin -> amax (the echirp law's frequency
        curve reused as an envelope)."""
        N = N or self.N
        tkw = self._resolve_tkw(tkw)
        t = _timegrid(tkw['tmin'], tkw['tmax'], N, tkw['endpoint'])
        _, w = _law_exp(t, tkw['tmin'], tkw['tmax'], amin, amax)
        return w / TAU, t

    def am_gauss(self, N=None, amin=.1, amax=1, **tkw):
        N = N or self.N
        t = _timegrid(-1, 1, N)
        bell = np.exp(-5 * (t - t.mean())**2)
        return amin + (amax - amin) * bell, t

    # ---- composites -------------------------------------------------------
    def jumps(self, N=None, freqs=None, **tkw):
        """Piecewise-constant frequency: len(freqs) equal segments."""
        N = N or self.N
        tkw = self._resolve_tkw(tkw)
        n_seg = 4 if freqs is None else len(freqs)
        M = N // n_seg
        if freqs is None:
            freqs = [1, M / 4, M / 2, M / 16]
        span = tkw['tmax'] - tkw['tmin']
        t_all = _timegrid(tkw['tmin'], span * len(freqs), M * len(freqs),
                          tkw['endpoint'])
        x = np.concatenate([np.cos(TAU * f * t_all[i * M:(i + 1) * M])
                            for i, f in enumerate(freqs)])
        return x, t_all

    def packed(self, N=None, freqs=None, overlap=.8, **tkw):
        """Densely packed tones, alternating ends, `overlap` fractional
        time-support each."""
        N = N or self.N
        tkw = self._resolve_tkw(tkw)
        t = _timegrid(tkw['tmin'], tkw['tmax'], N, tkw['endpoint'])
        if freqs is None:
            freqs = [.5, 1, 2, N / 10, N / 10 + N / 50, N / 10 + N / 25,
                     N / 5, N / 4, N / 3, N / 3 + N / 10]
        m = int(overlap * len(t))
        x = np.zeros(len(t))
        for i, f in enumerate(freqs):
            sl = slice(0, m) if i % 2 == 0 else slice(-m, None)
            x[sl] += np.cos(TAU * f * t[sl])
        return x, t

    def packed_poly(self, N=None, **tkw):
        """Three closely-packed AM'd polynomial FM components
        (non-configurable; frequencies scale with N)."""
        N = N or self.N
        t = np.linspace(0, 10, N)
        s = N / 512
        x1 = (1 + .3 * np.cos(t)) * np.cos(
            TAU * (10 * s * t - .3 * s * np.sin(t) - 1.8 * s * t**1.5))
        x2 = (1 + .2 * np.cos(2 * t)) * np.exp(-t / 15) * np.cos(
            TAU * (2.4 * s * t + .5 * s * t**1.2 + .3 * np.sin(t)))
        x3 = np.cos(TAU * (4.8 * s * t + .2 * s * t**1.3))
        return x1 + x2 + x3, t

    def poly_cubic(self, N=None, **tkw):
        """Two cubic polynomial FMs + a pure tone (non-configurable)."""
        N = N or self.N
        t = np.linspace(0, 10, N, endpoint=True)
        s = N / 256
        x1 = sig.sweep_poly(t, np.poly1d([0.025, -0.36, 1.25, 2.0]) * s)
        x3 = sig.sweep_poly(t, np.poly1d([0.01, -0.25, 1.5, 4.0]) * s)
        x2 = np.sin(TAU * (.5 * s) * t)
        return x1 + x2 + x3, t

    # ---- batch generator --------------------------------------------------
    @classmethod
    def _parse_name(cls, name):
        """Split a catalog name into (reflect, carrier, modulator) with
        validation; grammar: ``[#]carrier[:am-modulator]``."""
        base = name.lstrip('#')
        carrier, _, mod = base.partition(':')
        for part in (carrier, mod):
            if part and part not in cls.SUPPORTED and \
                    part.replace('_', '-') not in cls.SUPPORTED:
                raise ValueError(f"unsupported signal: {part}; must be "
                                 "one of " + ', '.join(cls.SUPPORTED))
        return name.startswith('#'), carrier, mod

    def _default_params(self, name, carrier, mod):
        base = name.lstrip('#')
        entry = self.default_args.get(base, self.default_args.get(carrier,
                                                                  {}))
        if isinstance(entry, tuple):
            return dict(entry[0]), dict(entry[1])
        aparams = dict(self.default_args.get(mod, {})) if mod else {}
        return dict(entry), aparams

    def _normalize_request(self, signals):
        """-> list of (name, fparams, aparams) from the flexible
        `make_signals` input grammar."""
        if isinstance(signals, (str, tuple)):
            signals = list(self.DEMO) if signals == 'all' else [signals]
        elif not isinstance(signals, list):
            raise TypeError("`signals` must be string, list, or tuple "
                            "(got %s)" % type(signals))
        out = []
        for item in signals:
            if isinstance(item, str):
                name, params = item, None
            elif isinstance(item, (tuple, list)) and len(item) == 2:
                name, params = item
            else:
                raise TypeError(
                    "all tuple/list elements of `signals` must be "
                    "(str, dict) or (str, (dict, dict)) pairs")
            _, carrier, mod = self._parse_name(name)
            if params is None:
                fparams, aparams = self._default_params(name, carrier, mod)
            elif isinstance(params, dict):
                fparams, aparams = dict(params), {}
            else:
                fparams, aparams = dict(params[0]), dict(params[1])
            out.append((name, fparams, aparams))
        return out

    def make_signals(self, signals='all', N=None, get_params=False):
        """Generate named signals. Grammar: ``#name`` superimposes the
        time-reversed signal, ``carrier:am-name`` multiplies by an AM
        envelope; instance `snr` adds white Gaussian noise."""
        data = {}
        for name, fparams, aparams in self._normalize_request(signals):
            reflect, carrier, mod = self._parse_name(name)
            make_x = (getattr(self, carrier.replace('-', '_')) if carrier
                      else (lambda n, **kw: (np.ones(n), None)))
            make_a = (getattr(self, mod.replace('-', '_')) if mod
                      else (lambda n, **kw: (np.ones(n), None)))

            # time-grid kwargs are shared by carrier and modulator
            tkw = {k: v for d in (fparams, aparams) for k, v in d.items()
                   if k in ('tmin', 'tmax', 'endpoint')}

            fparams = dict(fparams)
            snr = fparams.pop('snr', self.snr)
            x, t = make_x(N, **fparams)
            x = x * make_a(len(x), **aparams, **tkw)[0]
            if reflect:
                x = x + x[::-1]
            if snr:
                rng = np.random.default_rng(self.seed)
                target_var = x.var() / 10 ** (snr / 10)
                noise = np.sqrt(target_var) * rng.standard_normal(len(x))
                fparams['snr'] = 10 * np.log10(x.var() / noise.var())
                x = x + noise
            data[name] = (x, t, (fparams, aparams))

        if get_params:
            return data
        xs = [v[0] for v in data.values()]
        return xs[0] if len(xs) == 1 else xs

    # ---- demo / comparison drivers (visual) -------------------------------
    def demo(self, signals='all', N=None, dft=None):
        """Plot waveforms (and optionally DFTs) of `signals`."""
        from .. import visuals
        if dft not in (None, 'rows', 'cols'):
            raise ValueError(f"`dft` must be 'rows', 'cols', or None "
                             f"(got {dft})")
        for name, (x, t, (fp, ap)) in self.make_signals(
                signals, N, get_params=True).items():
            title = self._title(name, len(x), fp, ap)
            if dft:
                visuals.plots([t, None], [x, np.abs(np.fft.rfft(x))],
                              pkw=[{'title': title},
                                   {'title': f"rDFT({name})"}], show=1)
            else:
                visuals.plot(t, x, show=1, title=title)

    def test_transforms(self, fn, signals='all', N=None):
        """Apply `fn(x, t, (name, fparams, aparams))` to every signal and
        imshow returned transforms."""
        from .. import visuals
        for name, (x, t, (fp, ap)) in self.make_signals(
                signals, N, get_params=True).items():
            out = fn(x, t, (name, fp, ap))
            if out is None:
                continue
            out, pkw = out
            pkw = dict(pkw)
            pkw.setdefault('title', self._title(name, len(x), fp, ap))
            pkw.setdefault('abs', 1)
            pkw.setdefault('show', 1)
            for o in (out if isinstance(out, (tuple, list)) else [out]):
                visuals.imshow(o, **pkw)

    def wavcomp(self, wavelets, signals='all', N=None, w=None, h=None,
                tight_kw=None, device='cuda'):
        """Compare synchrosqueezed CWTs under different wavelets (draws),
        each computed on `device`."""
        from .ssq_cwt import ssq_cwt

        def fn(x, t, params):
            return [np.abs(ssq_cwt(x, wav, astensor=False,
                                   device=device)[0])
                    for wav in wavelets], {}
        self.test_transforms(fn, signals, N)

    def cwt_vs_stft(self, wavelet, window, signals='all', N=None,
                    win_len=None, n_fft=None, window_name=None,
                    config_str='', w=None, h=None, device='cuda'):
        """Compare SSQ-CWT and SSQ-STFT side by side (draws), each
        computed on `device`."""
        from .ssq_cwt import ssq_cwt
        from .ssq_stft import ssq_stft

        def fn(x, t, params):
            Tx_c = ssq_cwt(x, wavelet, astensor=False, device=device)[0]
            Tx_s = ssq_stft(x, window, n_fft=n_fft, win_len=win_len,
                            astensor=False, device=device)[0]
            return [np.abs(Tx_c), np.abs(Tx_s)], {}
        self.test_transforms(fn, signals, N)

    def ridgecomp(self, transform='cwt', signals='all', N=None, n_ridges=2,
                  penalty=20, device='cuda', **transform_kw):
        """Ridge extraction across signals (draws): the synchrosqueezed
        CWT or STFT and `extract_ridges` of its transform, on
        `device`."""
        from .ssq_cwt import ssq_cwt
        from .ssq_stft import ssq_stft
        from .ridge_extraction import extract_ridges
        from .. import visuals

        for name, (x, t, _) in self.make_signals(
                signals, N, get_params=True).items():
            if transform == 'cwt':
                Tx, Wx, _, scales = ssq_cwt(x, astensor=False, device=device,
                                            **transform_kw)[:4]
                ridges = extract_ridges(Wx, scales, penalty=penalty,
                                        n_ridges=n_ridges, transform='cwt',
                                        device=device)
            else:
                Tx, Sx, _, Sfs = ssq_stft(x, astensor=False, device=device,
                                          **transform_kw)[:4]
                ridges = extract_ridges(Sx, Sfs, penalty=penalty,
                                        n_ridges=n_ridges, transform='stft',
                                        device=device)
            visuals.imshow(Tx, abs=1, show=0, title=name)
            for r in ridges.T:
                visuals.plot(r, color='r', show=0)
            visuals.plot([], show=1)

    @classmethod
    def _title(cls, signal, N, fparams, aparams, wrap_len=70):
        """'name | N=.., k=v, ...' figure caption."""
        shown = dict(fparams)
        if shown.get('fmax', 0) is None and any(
                fam in signal for fam in ('lchirp', 'echirp', 'hchirp')):
            shown['fmax'] = N / 2
        snr = shown.pop('snr', None)
        head = dict(N=N)
        if snr:
            head['SNR'] = "{:.1f}dB".format(snr)
        shown = {**head, **shown}
        shown = {k: (int(v) if isinstance(v, float) and v.is_integer()
                     else v) for k, v in shown.items()}
        caption = "{} | {}".format(
            signal, ', '.join(f"{k}={v}" for k, v in shown.items()))
        if aparams:
            caption += ', ' + ', '.join(f"{k}={v}"
                                        for k, v in aparams.items())
        return caption
