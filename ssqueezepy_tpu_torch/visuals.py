# -*- coding: utf-8 -*-
"""Visualization toolkit (matplotlib; host-side).

Counterpart of `ssqueezepy_tpu/visuals.py`, with its names and
signatures: the generic plotters (imshow, plot, plots, scat, plotscat,
hist) and the wavelet visuals. Every input may be a numpy array or a
tensor on any device (`_np` brings it to the host). matplotlib is
imported inside the functions that draw (`_plt`), so importing this
package needs none.
"""
import numpy as np
import torch

__all__ = ['imshow', 'plot', 'plots', 'scat', 'plotscat', 'hist',
           'wavelet_tf', 'wavelet_tf_anim', 'wavelet_heatmap',
           'wavelet_filterbank', 'wavelet_waveforms', 'sweep_std_t',
           'sweep_std_w', 'sweep_harea', 'viz_cwt_higher_order',
           'viz_gmw_orders', 'wavelet_viz', '_viz_cwt_scalebounds']


def _plt():
    import matplotlib.pyplot as plt
    return plt


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x) if x is not None else None


def _maybe_title(ax, title, fontsize=16, weight='bold', loc='left'):
    if title:
        ax.set_title(str(title), fontsize=fontsize, weight=weight, loc=loc)


def imshow(data, title=None, show=1, cmap=None, norm=None, abs=0, w=None,
           h=None, ridge=0, ticks=1, yticks=None, xticks=None, xlabel=None,
           ylabel=None, aspect='auto', ax=None, fig=None, **kw):
    """2D heatmap; `abs=1` plots |data| with 'turbo'-style colormap."""
    data = _np(data)
    plt = _plt()
    ax = ax or plt.gca()
    fig = fig or plt.gcf()

    if abs:
        data = np.abs(data)
        cmap = cmap or 'turbo'
        vmin, vmax = None, None
    else:
        cmap = cmap or 'bwr'
        mx = np.max(np.abs(data.real if np.iscomplexobj(data) else data))
        vmin, vmax = -mx, mx
        data = data.real if np.iscomplexobj(data) else data

    if norm is not None:
        vmin, vmax = norm

    im = ax.imshow(data, cmap=cmap, vmin=vmin, vmax=vmax, aspect=aspect,
                   **kw)
    if not ticks:
        ax.set_xticks([])
        ax.set_yticks([])
    if xticks is not None or yticks is not None:
        _format_ticks(ax, xticks, yticks)
    if xlabel:
        ax.set_xlabel(xlabel, weight='bold', fontsize=14)
    if ylabel:
        ax.set_ylabel(ylabel, weight='bold', fontsize=14)
    _maybe_title(ax, title)
    if w or h:
        fig.set_size_inches(12 * (w or 1), 12 * (h or 1))
    if show:
        plt.show()
    return im


def _format_ticks(ax, xticks, yticks):
    from matplotlib import ticker
    def fmt(ticks_):
        if np.all(ticks_ == ticks_.astype('int64')):
            return lambda v, p: "%d" % ticks_[min(int(round(v)),
                                                  len(ticks_) - 1)]
        return lambda v, p: "%.2f" % ticks_[min(int(round(v)),
                                                len(ticks_) - 1)]
    if xticks is not None:
        xticks = np.asarray(xticks)
        ax.xaxis.set_major_formatter(ticker.FuncFormatter(fmt(xticks)))
    if yticks is not None:
        yticks = np.asarray(yticks)
        ax.yaxis.set_major_formatter(ticker.FuncFormatter(fmt(yticks)))


def plot(x, y=None, title=None, show=0, complex=0, abs=0, w=None, h=None,
         xlims=None, ylims=None, vlines=None, hlines=None, xlabel=None,
         ylabel=None, xticks=None, yticks=None, ax=None, fig=None,
         squeeze=True, dx1=False, ticks=True, **kw):
    """1D line plot with complex/abs handling and v/h line markers."""
    x = _np(x)
    y = _np(y)
    if x is None and y is None:
        x = []
    if y is None:
        x, y = (None, x)
    plt = _plt()
    ax = ax or plt.gca()
    fig = fig or plt.gcf()

    if y is not None and np.iscomplexobj(y):
        if abs:
            y = np.abs(y)
        elif complex:
            xs = np.arange(len(y)) if x is None else x
            ax.plot(xs, y.real, color='tab:blue', **kw)
            ax.plot(xs, y.imag, color='tab:orange', **kw)
            y = None
        else:
            y = y.real

    if y is not None:
        if x is None:
            ax.plot(y, **kw)
        else:
            ax.plot(x, y, **kw)

    if vlines:
        _lines(ax, vlines, vertical=True)
    if hlines:
        _lines(ax, hlines, vertical=False)
    if xlims:
        ax.set_xlim(*xlims)
    if ylims:
        ax.set_ylim(*ylims)
    if xlabel:
        ax.set_xlabel(xlabel, weight='bold', fontsize=14)
    if ylabel:
        ax.set_ylabel(ylabel, weight='bold', fontsize=14)
    _maybe_title(ax, title)
    if w or h:
        fig.set_size_inches(14 * (w or 1), 8 * (h or 1))
    if show:
        plt.show()


def _lines(ax, lines, vertical=True):
    fn = ax.axvline if vertical else ax.axhline
    if isinstance(lines, tuple) and len(lines) == 2 and \
            isinstance(lines[1], dict):
        locs, lkw = lines
        locs = np.atleast_1d(locs)
        for loc in locs:
            fn(loc, **lkw)
    else:
        for loc in np.atleast_1d(lines):
            fn(loc)


def scat(x, y=None, title=None, show=0, abs=0, s=18, w=None, h=None,
         xlims=None, ylims=None, vlines=None, hlines=None, ax=None,
         fig=None, **kw):
    """Scatter plot."""
    x = _np(x)
    y = _np(y)
    if y is None:
        x, y = None, x
    plt = _plt()
    ax = ax or plt.gca()
    if np.iscomplexobj(y):
        y = np.abs(y) if abs else y.real
    if x is None:
        ax.scatter(np.arange(len(y)), y, s=s, **kw)
    else:
        ax.scatter(x, y, s=s, **kw)
    if vlines:
        _lines(ax, vlines, vertical=True)
    if hlines:
        _lines(ax, hlines, vertical=False)
    if xlims:
        ax.set_xlim(*xlims)
    if ylims:
        ax.set_ylim(*ylims)
    _maybe_title(ax, title)
    if show:
        plt.show()


def plotscat(*args, **kw):
    plt = _plt()
    show = kw.pop('show', 0)
    plot(*args, **kw)
    scat(*args, **kw)
    if show:
        plt.show()


def plots(X, Y=None, pkw=None, show=1, nrows=None, ncols=None, w=1, h=1,
          **kw):
    """Plot multiple signals on subplots."""
    plt = _plt()
    if Y is None:
        X, Y = [None] * len(X), X
    pkw = pkw or [{}] * len(Y)
    n = len(Y)
    if nrows is None and ncols is None:
        ncols = min(n, 2)
        nrows = int(np.ceil(n / ncols))
    elif ncols is None:
        ncols = int(np.ceil(n / nrows))
    elif nrows is None:
        nrows = int(np.ceil(n / ncols))
    fig, axes = plt.subplots(nrows, ncols, figsize=(12 * w, 6 * h))
    axes = np.atleast_1d(axes).ravel()
    for i, (x, y) in enumerate(zip(X, Y)):
        plot(x, y, ax=axes[i], fig=fig, **{**kw, **pkw[i]})
    if show:
        plt.show()


def hist(x, bins=100, title=None, show=0, stats=0, ax=None, **kw):
    """Histogram."""
    plt = _plt()
    x = np.asarray(_np(x)).ravel()
    if np.iscomplexobj(x):
        x = np.abs(x)
    ax = ax or plt.gca()
    ax.hist(x, bins=bins, **kw)
    _maybe_title(ax, title)
    if stats:
        print("(mean, std, min, max) = ({:.2e}, {:.2e}, {:.2e}, {:.2e})"
              .format(x.mean(), x.std(), x.min(), x.max()))
    if show:
        plt.show()


# --------------------------------------------------------------------------
# wavelet-specific visuals
# --------------------------------------------------------------------------
def _wavelet_psih_psi(wavelet, N, scale):
    psih = wavelet.filterbank_np(np.array([float(scale)]), N=N,
                                 nohalf=False)[0]
    psi = np.fft.ifft(psih * (-1) ** np.arange(N))
    return psih, psi


def wavelet_tf(wavelet, N=None, scale=None, notext=False, width=1.1,
               height=1, savepath=None, **kw):
    """Time + frequency domain joint view."""
    from .models.wavelets import Wavelet
    plt = _plt()
    wavelet = Wavelet._init_if_not_isinstance(wavelet)
    N = N or wavelet.N
    scale = scale or wavelet.scalec_ct
    psih, psi = _wavelet_psih_psi(wavelet, N, scale)

    fig, axes = plt.subplots(1, 2, figsize=(12 * width, 6 * height))
    t = np.arange(N) - N // 2
    axes[0].plot(t, np.fft.fftshift(psi.real), color='tab:blue')
    axes[0].plot(t, np.fft.fftshift(psi.imag), color='tab:orange')
    _maybe_title(axes[0], "psi(t)" if not notext else None)
    axes[1].plot(psih[:N // 2 + 1], color='tab:green')
    _maybe_title(axes[1], "psih(w)+" if not notext else None)
    if savepath:
        fig.savefig(savepath)
    plt.show()


def wavelet_tf_anim(wavelet, N=None, scales=None, n_frames=30, fps=10,
                    savepath=None, testing=False, **kw):
    """Animated joint time/frequency view of the wavelet sweeping through
    `scales`: left pane Re/Im of psi(t), right pane psih(w)+, one frame
    per scale. Returns the `FuncAnimation`; writes a GIF when `savepath`
    is given."""
    from matplotlib.animation import FuncAnimation, PillowWriter
    from .models.wavelets import Wavelet
    from .utils.cwt_utils import process_scales
    plt = _plt()
    wavelet = Wavelet._init_if_not_isinstance(wavelet)
    N = N or wavelet.N or 1024
    if scales is None or isinstance(scales, str):
        scales = process_scales(scales or 'log', N, wavelet)
    scales = np.asarray(scales).squeeze()
    if len(scales) > n_frames:       # uniform geometric subsample
        idx = np.unique(np.linspace(0, len(scales) - 1,
                                    n_frames).round().astype(int))
        scales = scales[idx]

    # all frames from one filterbank synthesis (host numpy)
    Psih = wavelet.filterbank_np(scales, N=N, nohalf=False)
    Psi = np.fft.ifft(Psih * (-1) ** np.arange(N), axis=-1)
    half = N // 2 + 1
    t = np.arange(N) - N // 2

    fig, axes = plt.subplots(1, 2, figsize=(12, 5))
    l_re, = axes[0].plot(t, Psi[0].real, color='tab:blue')
    l_im, = axes[0].plot(t, Psi[0].imag, color='tab:orange')
    l_fr, = axes[1].plot(np.abs(Psih[0][:half]), color='tab:green')
    axes[0].set_ylim(1.05 * np.abs(Psi).max() * np.array([-1, 1]))
    axes[1].set_ylim(0, 1.05 * np.abs(Psih).max())
    _maybe_title(axes[0], "psi(t)")
    ttl = axes[1].set_title("|psih(w)+|  scale=%.3g" % scales[0],
                            fontsize=16, weight='bold', loc='left')

    def frame(i):
        l_re.set_ydata(Psi[i].real)
        l_im.set_ydata(Psi[i].imag)
        l_fr.set_ydata(np.abs(Psih[i][:half]))
        if ttl is not None:
            ttl.set_text("|psih(w)+|  scale=%.3g" % scales[i])
        return l_re, l_im, l_fr

    anim = FuncAnimation(fig, frame, frames=len(scales), blit=False,
                         interval=1000 // fps)
    if savepath:
        anim.save(savepath, writer=PillowWriter(fps=fps))
        plt.close(fig)
    elif not testing:
        plt.show()
    return anim


def wavelet_heatmap(wavelet, scales='log', N=None, **kw):
    """|CWT filterbank| heatmaps in time & frequency."""
    from .models.wavelets import Wavelet
    from .utils.cwt_utils import process_scales
    wavelet = Wavelet._init_if_not_isinstance(wavelet)
    N = N or wavelet.N
    if isinstance(scales, str):
        scales = process_scales(scales, N, wavelet)
    Psih = wavelet.filterbank_np(np.asarray(scales).squeeze(), N=N)
    imshow(Psih, abs=1, title="|psih| per scale", show=1, **kw)
    Psi = np.fft.ifft(Psih * (-1) ** np.arange(N), axis=-1)
    imshow(Psi.real, title="Re(psi) per scale", show=1, **kw)


def wavelet_filterbank(wavelet, N=1024, scales='log', skips=0, title_append='',
                       positives_only=True, **kw):
    """Frequency-domain filterbank overlay."""
    from .models.wavelets import Wavelet
    from .utils.cwt_utils import process_scales
    plt = _plt()
    wavelet = Wavelet._init_if_not_isinstance(wavelet)
    if isinstance(scales, str):
        scales = process_scales(scales, N, wavelet)
    Psih = wavelet.filterbank_np(np.asarray(scales).squeeze(), N=N)
    half = N // 2 + 1 if positives_only else N
    for p in Psih[::max(1, int(skips) + 1)]:
        plt.plot(np.abs(p[:half]))
    _maybe_title(plt.gca(), "CWT filterbank" + title_append)
    plt.show()


def wavelet_waveforms(wavelet, N, scale, **kw):
    """Time & freq domain waveforms at one scale."""
    wavelet_tf(wavelet, N=N, scale=scale, **kw)


def _sweep(wavelet, N, scales, fn, name):
    from .models.wavelets import Wavelet
    wavelet = Wavelet._init_if_not_isinstance(wavelet)
    scales = np.asarray(scales).squeeze()
    vals = []
    for s in scales:
        try:
            vals.append(fn(wavelet, float(s), N))
        except Exception:
            vals.append(np.nan)
    plot(scales, np.asarray(vals), title=f"{name} vs scale", show=1)
    return np.asarray(vals)


def sweep_std_t(wavelet, N, scales, **kw):
    from .models.wavelets import time_resolution
    return _sweep(wavelet, N, scales,
                  lambda w, s, n: time_resolution(w, s, n, nondim=False),
                  'std_t')


def sweep_std_w(wavelet, N, scales, **kw):
    from .models.wavelets import freq_resolution
    return _sweep(wavelet, N, scales,
                  lambda w, s, n: freq_resolution(w, s, n, nondim=False),
                  'std_w')


def sweep_harea(wavelet, N, scales, **kw):
    from .models.wavelets import time_resolution, freq_resolution
    return _sweep(
        wavelet, N, scales,
        lambda w, s, n: (time_resolution(w, s, n, nondim=False) *
                         freq_resolution(w, s, n, nondim=False)), 'harea')


def _viz_cwt_scalebounds(wavelet, N, min_scale=None, max_scale=None,
                         cutoff=1, std_t=None, Nt=None):
    """Visual check of scale bounds."""
    from .models.wavelets import Wavelet
    wavelet = Wavelet._init_if_not_isinstance(wavelet)
    for scale, nm in ((min_scale, 'min'), (max_scale, 'max')):
        if scale is None:
            continue
        psih = wavelet.filterbank_np(np.array([float(scale)]), N=N)[0]
        plot(np.abs(psih[:N // 2 + 1]),
             title=f"|psih| at {nm}_scale={float(scale):.3f}", show=1)


def viz_cwt_higher_order(Wx_k, scales=None, **kw):
    """Higher-order CWT components."""
    for i, Wx in enumerate(np.atleast_3d(_np(Wx_k))):
        imshow(Wx, abs=1, title=f"|Wx| order {i}", show=1)


def viz_gmw_orders(N=1024, n_orders=3, scale=5, gamma=3, beta=60, **kw):
    """First `n_orders` GMWs in time & frequency."""
    from .models.gmw import gmw
    from .models.wavelets import _xifn
    plt = _plt()
    w = _xifn(scale, N)
    for k in range(n_orders):
        fn = gmw(gamma, beta, 'bandpass', k)
        psih = np.asarray(fn(w[:N // 2 + 1], xp=np))
        plt.plot(psih, label=f"order {k}")
    plt.legend()
    _maybe_title(plt.gca(), f"GMW orders 0..{n_orders-1} | gamma={gamma}, "
                 f"beta={beta}")
    plt.show()


def wavelet_viz(wavelet, name='overview', **kw):
    """Dispatch for `Wavelet.viz`."""
    visuals_map = {
        'heatmap': wavelet_heatmap,
        'waveforms': wavelet_waveforms,
        'filterbank': wavelet_filterbank,
        'harea': sweep_harea,
        'std_t': sweep_std_t,
        'std_w': sweep_std_w,
        'time-frequency': wavelet_tf,
        'anim:time-frequency': wavelet_tf_anim,
    }
    if name == 'overview':
        for nm in ('heatmap', 'filterbank', 'time-frequency'):
            kw.setdefault('N', wavelet.N)
            visuals_map[nm](wavelet, **kw)
        return
    if name not in visuals_map:
        raise ValueError(f"visual '{name}' not supported; must be one of: "
                         + ', '.join(visuals_map))
    visuals_map[name](wavelet, **kw)
