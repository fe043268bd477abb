# -*- coding: utf-8 -*-
"""Builds the CUDA kernels in `csrc/` at first use on a CUDA tensor.

Each `csrc/<name>.cu` is compiled by `nvcc` on its own into
`build/lib<name>-<hash>.so` at the repository root (plain C interface,
nothing else linked) and loaded with `ctypes`. All sources are compiled
together, one `nvcc` process each, the first time any kernel is asked
for; the hash in the file name covers the source, the shared headers
(`csrc/*.cuh`) and the flags, so a stale library is never loaded. Nothing here runs at import, so the package imports on a machine
without `nvcc`.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ['load', 'build_all', 'check', 'SOURCES']

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD = os.path.join(os.path.dirname(_PKG), 'build')
SOURCES = ('cwt_bins', 'scatter_kv', 'stft_conv', 'ridge_dp')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC']

_lock = threading.Lock()
_libs = {}


def _nvcc():
    found = shutil.which('nvcc')
    if found:
        return found
    for root in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if root and os.path.isfile(os.path.join(root, 'bin', 'nvcc')):
            return os.path.join(root, 'bin', 'nvcc')
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "csrc/ on a machine with the CUDA toolkit")


def _target(name):
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith('.cuh'))
    for fname in [name + '.cu'] + headers:
        with open(os.path.join(CSRC, fname), 'rb') as f:
            digest.update(f.read())
    return os.path.join(BUILD, 'lib%s-%s.so' % (name,
                                                digest.hexdigest()[:16]))


def build_all(ptxas=None):
    """Compile every missing library in parallel; returns the seconds
    spent (0.0 when all were built already). Given a dict `ptxas`, each
    source compiled now is compiled with `-Xptxas -v` and the compiler's
    report (registers, shared memory, spills per kernel) is stored under
    the source's name."""
    with _lock:
        todo = [n for n in SOURCES if not os.path.isfile(_target(n))]
        t0 = time.perf_counter()
        if todo:
            os.makedirs(BUILD, exist_ok=True)
            nvcc = _nvcc()
            procs = []
            for name in todo:
                tmp = _target(name) + '.tmp%d' % os.getpid()
                cmd = [nvcc] + NVCC_FLAGS + (['-Xptxas', '-v'] if ptxas
                                             is not None else []) + [
                    '-o', tmp, os.path.join(CSRC, name + '.cu')]
                procs.append((name, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
            errors = []
            for name, tmp, proc in procs:
                out = proc.communicate()[0].decode(errors='replace')
                if proc.returncode != 0:
                    errors.append('%s.cu:\n%s' % (name, out))
                else:
                    os.replace(tmp, _target(name))
                    if ptxas is not None:
                        ptxas[name] = out
            if errors:
                raise RuntimeError("nvcc failed:\n" + '\n'.join(errors))
        return time.perf_counter() - t0


# each library's C entry points (float32 and float64) and their arguments
_SIGNATURES = {
    'cwt_bins': [(('cwt_bins_f32', 'cwt_bins_f64'), [ctypes.c_void_p] * 10)],
    'scatter_kv': [
        (('scatter_kv_f32', 'scatter_kv_f64'),
         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2),
        (('shift_scatter_f32', 'shift_scatter_f64'),
         [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
         + [ctypes.c_void_p] * 2),
        (('ssq_fused_f32', 'ssq_fused_f64'), [ctypes.c_void_p] * 8),
        (('scatter_occupancy',), [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2)],
    'stft_conv': [(('stft_conv_f32', 'stft_conv_f64'),
                   [ctypes.c_void_p] * 11)],
    'ridge_dp': [
        (('ridge_forward_f32', 'ridge_forward_f64'),
         [ctypes.c_void_p] * 2 + [ctypes.c_double] + [ctypes.c_int] * 8
         + [ctypes.c_void_p] * 2),
        (('ridge_forward_clusters',), [ctypes.c_int] * 5 + [ctypes.c_void_p]),
        (('ridge_trace_f32', 'ridge_trace_f64'),
         [ctypes.c_void_p] * 3 + [ctypes.c_double] * 2 + [ctypes.c_int] * 7
         + [ctypes.c_void_p] * 2),
        (('ridge_forward_tiled_f32', 'ridge_forward_tiled_f64'),
         [ctypes.c_void_p] * 2 + [ctypes.c_double] + [ctypes.c_int] * 3
         + [ctypes.c_void_p] * 4),
        (('ridge_forward_tiled_ctas',), [ctypes.c_int, ctypes.c_void_p]),
        (('ridge_trace_prologue_f32', 'ridge_trace_prologue_f64'),
         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3),
        (('ridge_trace_tiled_f32', 'ridge_trace_tiled_f64'),
         [ctypes.c_void_p] * 5 + [ctypes.c_double] * 2 + [ctypes.c_int] * 6
         + [ctypes.c_void_p] * 2)],
}


def load(name):
    """ctypes handle of kernel library `name`, building all on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all()
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(_target(name))
            for fns, argtypes in _SIGNATURES[name]:
                for fn in fns:
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]


def check(err, name):
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError("CUDA kernel %s failed to launch: cudaError %d"
                           % (name, err))
