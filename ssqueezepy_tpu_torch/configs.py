# -*- coding: utf-8 -*-
"""Global configuration for ssqueezepy_tpu_torch.

Defaults live in typed dataclasses, layered as

    explicit kwargs  >  environment (``SSQTORCH_*``)  >  built-in defaults

Built-in defaults follow ssqueezepy's `configs.ini` values: morlet
mu=13.4; bump mu=5, s=1, om=0; cmhat mu=1, s=1; hhhat mu=5; GMW gamma=3,
beta=60, norm='bandpass'; global dtype float32; log-piecewise
downsample=4. Counterpart of `ssqueezepy_tpu/configs.py`, cut to what
the port needs. It has no backend or kernel switches: CUDA tensors always
run the hand-written kernels, CPU tensors their plain PyTorch versions.
`stft_band` (the JAX field of that name) chooses a function, not a
kernel: on, the float32 hop-1 STFT drops each row's 1e-7 spectral tail
(`ops/stft_conv.py`, the band plan); off, it computes the exact sum; both
run the same kernel on the card.
"""
import os
import dataclasses
from dataclasses import dataclass, field

__all__ = ['Config', 'get_config', 'configure',
           'default_dtype', 'device_dtype', 'gdefaults', 'backend',
           'IS_PARALLEL', 'USE_GPU']


@dataclass
class WaveletDefaults:
    """Per-wavelet default parameters (ssqueezepy configs.ini)."""
    morlet: dict = field(default_factory=lambda: dict(mu=13.4))
    bump: dict = field(default_factory=lambda: dict(mu=5.0, s=1.0, om=0.0))
    cmhat: dict = field(default_factory=lambda: dict(mu=1.0, s=1.0))
    hhhat: dict = field(default_factory=lambda: dict(mu=5.0))
    gmw: dict = field(default_factory=lambda: dict(
        gamma=3.0, beta=60.0, norm='bandpass', order=0, centered_scale=False))


@dataclass
class Config:
    """Global defaults; access via `get_config()`, override via
    `configure()` or env vars ``SSQTORCH_DTYPE``, ``SSQTORCH_DOWNSAMPLE``,
    ``SSQTORCH_STFT_BAND``.
    """
    # global compute precision ('float32' | 'float64')
    dtype: str = 'float32'
    # log-piecewise scale downsampling factor
    downsample: int = 4
    # float32 hop-1 STFT tables cut to each row's spectral band (all but
    # 1e-7 of its L1 mass) where the band pays; False: full tables
    stft_band: bool = True
    wavelets: WaveletDefaults = field(default_factory=WaveletDefaults)


_CONFIG = None


def _from_env(cfg):
    dtype = os.environ.get('SSQTORCH_DTYPE')
    if dtype:
        cfg.dtype = dtype
    ds = os.environ.get('SSQTORCH_DOWNSAMPLE')
    if ds:
        cfg.downsample = int(ds)
    sb = os.environ.get('SSQTORCH_STFT_BAND')
    if sb:
        cfg.stft_band = sb not in ('0', 'false', 'False')
    return cfg


def get_config():
    global _CONFIG
    if _CONFIG is None:
        _CONFIG = _from_env(Config())
    return _CONFIG


def configure(**kw):
    """Override global defaults, e.g. ``configure(dtype='float64')``."""
    cfg = get_config()
    for k, v in kw.items():
        if not hasattr(cfg, k):
            raise ValueError(f"unknown config field: {k}")
        setattr(cfg, k, v)
    return cfg


def backend():
    """Where the entry points run by default: 'cuda' where a CUDA card is
    present, else 'cpu' (where a default call raises and a call with
    ``device='cpu'`` runs the plain versions). A report: no setting
    changes it."""
    import torch
    return 'cuda' if torch.cuda.is_available() else 'cpu'


def default_dtype():
    return get_config().dtype


def device_dtype(dtype):
    """Compute dtype for a requested wavelet dtype. PyTorch has native
    float64 on both the CPU and the card, so the request stands."""
    dtype = str(dtype)
    if dtype not in ('float32', 'float64'):
        raise ValueError("dtype must be 'float32' or 'float64' (got %s)"
                         % dtype)
    return dtype


def gdefaults(section, **kw):
    """Fill `None` kwargs from the wavelet defaults table (`section` e.g.
    'morlet', 'gmw')."""
    table = dataclasses.asdict(get_config().wavelets).get(section, {})
    out = {}
    for k, v in kw.items():
        out[k] = table.get(k) if v is None else v
    return out


def IS_PARALLEL():
    """The reference library's `IS_PARALLEL`, as a report only: False
    where the environment sets ``SSQ_PARALLEL=0``. Nothing here reads it:
    the kernels and torch's own threads are parallel whatever it says."""
    return os.environ.get('SSQ_PARALLEL', '1') != '0'


def USE_GPU():
    """The reference library's `USE_GPU`, as a report only: True where a
    CUDA card is present, which is where the entry points' default
    ``device='cuda'`` runs. It changes nothing: a call's `device` picks
    where it runs."""
    return backend() == 'cuda'
