'''
ctypes loader for the native SEG-Y codec (native/segy_codec.cpp), the
port's copy of ``zephyr_tpu.middleware.segy_native``.

Compiles the shared library on first use (g++ -O3) into ``build/`` beside
the package, under a name of its own (the JAX package builds its copy
beside the source, so the two never write the same file), through a
temporary file that is then renamed into place, so processes that build
at the same moment never load a half-written library. Falls back cleanly
when no compiler is available: ``decode_traces`` returns None and
``zephyr_tpu_torch.middleware.segy`` decodes in numpy.
'''

import ctypes
import os
import subprocess

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, 'native', 'segy_codec.cpp')
_OUT = os.path.join(_ROOT, 'build', 'zephyr_tpu_torch_segy',
                    'libsegy_codec_torch.so')
_LIB = None
_TRIED = False


def _build(src, out):
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = '%s.tmp%d' % (out, os.getpid())
    cmd = ['g++', '-O3', '-shared', '-fPIC', src, '-o', tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load():
    'Load (building if needed) the native codec; None if unavailable.'

    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True

    if not os.path.exists(_SRC):
        return None
    try:
        if not os.path.exists(_OUT) or \
                os.path.getmtime(_OUT) < os.path.getmtime(_SRC):
            _build(_SRC, _OUT)
        lib = ctypes.CDLL(_OUT)
    except Exception:
        return None

    lib.ibm_to_f64.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.c_int]
    lib.f64_to_ibm.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_int64, ctypes.c_int]
    lib.decode_traces.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_double)]
    lib.decode_traces.restype = ctypes.c_int
    _LIB = lib
    return _LIB


def decode_traces(payload, ntr, ns, fmt, big_endian):
    '''
    Decode the full trace block of a SEG-Y payload (bytes starting at the
    first trace header) into an (ntr, ns) float64 array using the native
    codec. Returns None if the native library is unavailable.
    '''

    lib = load()
    if lib is None:
        return None
    buf = np.frombuffer(payload, dtype=np.uint8)
    out = np.empty((ntr, ns), dtype=np.float64)
    rc = lib.decode_traces(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(ntr), ctypes.c_int64(ns),
        ctypes.c_int(fmt), ctypes.c_int(1 if big_endian else 0),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc != 0:
        return None
    return out
