'''
Loader and wrappers of the hand-written CUDA kernels (``csrc/*.cu``).

At first use each source is compiled with ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``), one ``nvcc`` per source, all
started together, and the objects are linked into one shared library with
a plain C interface, which is bound with ``ctypes``. The library goes
into ``build/zephyr_tpu_torch_kernels/`` beside the package, under a name
keyed by a hash of the sources, so an edited kernel is rebuilt and an
unchanged one is reused. Importing this module needs neither ``nvcc``
nor a GPU.

Each wrapper checks device, dtype, shape and contiguity and raises on
anything else; passes complex64 tensors in place (the kernels read them
as float2 re/im pairs); allocates its outputs with ``torch.empty``;
launches on ``torch.cuda.current_stream()``; raises if the launch
reports an error; and adds one to its entry of ``LAUNCHES``. A failure
to build or launch is an exception: nothing falls back to the torch
twins.

    K1 apply_stencil        csrc/k1_apply_stencil.cu
    K2 presmooth_restrict   csrc/k2_presmooth_restrict.cu
    K3 pcr_sweep            csrc/k3_pcr_sweep.cu
    K4 prolong_add_smooth   csrc/k4_prolong_add_smooth.cu
    K5 jacobi_sweep         csrc/k5_jacobi_sweep.cu
    K7 restrict, prolong    csrc/k7_transfer.cu
'''

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG.parent / 'build' / 'zephyr_tpu_torch_kernels'
SOURCES = ('k1_apply_stencil.cu', 'k2_presmooth_restrict.cu',
           'k3_pcr_sweep.cu', 'k4_prolong_add_smooth.cu',
           'k5_jacobi_sweep.cu', 'k7_transfer.cu')
HEADERS = ('zt_common.cuh',)
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

#: launches of each kernel since the last ``reset_launches()``
LAUNCHES = {'apply_stencil': 0, 'presmooth_restrict': 0, 'pcr_sweep': 0,
            'prolong_add_smooth': 0, 'jacobi_sweep': 0, 'restrict': 0,
            'prolong': 0}

_lib = None
_lock = threading.Lock()
#: (seconds, compiler log) of the build this process made, if any
build_info = None


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc():
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    cand = os.path.join(home, 'bin', 'nvcc')
    if os.path.exists(cand):
        return cand
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('zephyr_tpu_torch: nvcc not found (set '
                           'CUDA_HOME); the CUDA kernels cannot be built')
    return found


def _source_hash():
    h = hashlib.sha256()
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build():
    '''
    Compile the kernels (if this source hash has no library yet) and
    return the path of the shared library.
    '''

    global build_info
    so = BUILD_DIR / ('libzt_kernels_%s.so' % _source_hash())
    if so.exists():
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = '%s.%d' % (so.stem, os.getpid())
    objs = [BUILD_DIR / ('%s.%s.o' % (Path(s).stem, tag)) for s in SOURCES]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, '-c', '-o', str(o),
                               str(CSRC / s)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s, o in zip(SOURCES, objs)]
    log, failed = '', []
    for s, p in zip(SOURCES, procs):
        out = p.communicate()[0]
        log += '%s:\n%s' % (s, out)
        if p.returncode != 0:
            failed.append('%s (%d)' % (s, p.returncode))
    tmp = so.with_suffix('.so.tmp%d' % os.getpid())
    if not failed:
        proc = subprocess.run([nvcc, *NVCC_FLAGS[:2], '-shared', '-o',
                               str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            failed.append('link (%d)' % proc.returncode)
    for o in objs:
        o.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError('zephyr_tpu_torch: nvcc failed: %s\n%s'
                           % (', '.join(failed), log))
    os.replace(tmp, so)
    (BUILD_DIR / (so.stem + '.log')).write_text(log)
    build_info = (seconds, log)
    return so


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        P, I = ctypes.c_void_p, ctypes.c_int
        sigs = {
            'zt_apply_stencil': [P, P, P, I, I, I, P],
            'zt_presmooth_restrict': [P, P, P, P, P, P, I, I, I, I, P],
            'zt_pcr_sweep': [P, P, P, P, P, I, I, I, I, I, P],
            'zt_prolong_add_smooth': [P, P, P, P, P, P, P, I, I, I, P],
            'zt_jacobi_sweep': [P, P, P, P, P, I, I, I, P],
            'zt_restrict': [P, P, I, I, I, P],
            'zt_prolong': [P, P, I, I, I, I, I, P],
        }
        for name, args in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = I
        _lib = lib
        return _lib


def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError('%s: expected a tensor' % name)
    if t.device != device:
        raise ValueError('%s: on %s, expected %s' % (name, t.device, device))
    if t.dtype != dtype:
        raise TypeError('%s: dtype %s, the kernel takes %s'
                        % (name, t.dtype, dtype))
    if tuple(t.shape) != tuple(shape):
        raise ValueError('%s: shape %s, expected %s'
                         % (name, tuple(t.shape), tuple(shape)))
    if not t.is_contiguous():
        raise ValueError('%s: must be contiguous' % name)


def _field_dims(b):
    if not isinstance(b, torch.Tensor) or b.device.type != 'cuda':
        raise ValueError('CUDA kernels take CUDA tensors')
    if b.dim() != 3:
        raise ValueError('expected an (R, nz, nx) batch, got shape %s'
                         % (tuple(b.shape),))
    R, nz, nx = b.shape
    if min(R, nz, nx) < 1:
        raise ValueError('empty batch or grid: %s' % (tuple(b.shape),))
    return R, nz, nx


def _launch(name, fn, *args):
    '''Launch on the current stream of the tensors' device; raise on error.'''
    err = fn(*args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError('zephyr_tpu_torch: %s launch failed with CUDA '
                           'error %d' % (name, err))
    LAUNCHES[name] += 1


def apply_stencil(planes, u):
    'K1: (A u)[r] for planes (9, nz, nx), u (R, nz, nx), complex64.'

    R, nz, nx = _field_dims(u)
    dev = u.device
    _check('u', u, torch.complex64, (R, nz, nx), dev)
    _check('planes', planes, torch.complex64, (9, nz, nx), dev)
    lib = _load()
    out = torch.empty_like(u)
    with torch.cuda.device(dev):
        _launch('apply_stencil', lib.zt_apply_stencil, planes.data_ptr(),
                u.data_ptr(), out.data_ptr(), R, nz, nx)
    return out


def presmooth_restrict(planes, dinv_eff, mask, b, nsweeps):
    '''
    K2: (u, rc) of the fused downstroke for b (R, nz, nx) complex64,
    dinv_eff (nz, nx) complex64, mask (nz, nx) float32.
    '''

    R, nz, nx = _field_dims(b)
    dev = b.device
    _check('b', b, torch.complex64, (R, nz, nx), dev)
    _check('planes', planes, torch.complex64, (9, nz, nx), dev)
    _check('dinv_eff', dinv_eff, torch.complex64, (nz, nx), dev)
    _check('mask', mask, torch.float32, (nz, nx), dev)
    if nsweeps not in (1, 2):
        raise ValueError('presmooth_restrict: nsweeps must be 1 or 2')
    lib = _load()
    u = torch.empty_like(b)
    rc = torch.empty((R, (nz + 1) // 2, (nx + 1) // 2), dtype=b.dtype,
                     device=dev)
    with torch.cuda.device(dev):
        _launch('presmooth_restrict', lib.zt_presmooth_restrict,
                planes.data_ptr(), dinv_eff.data_ptr(), mask.data_ptr(),
                b.data_ptr(), u.data_ptr(), rc.data_ptr(), R, nz, nx,
                nsweeps)
    return u, rc


def pcr_sweep(alphas, gammas, dinv, b):
    '''
    K3: the bf16-factor PCR sweep; alphas, gammas (nsteps, 2, nz, nx) and
    dinv (2, nz, nx) bfloat16, b (R, nz, nx) complex64.
    '''

    R, nz, nx = _field_dims(b)
    dev = b.device
    _check('b', b, torch.complex64, (R, nz, nx), dev)
    nsteps = alphas.shape[0] if alphas.dim() == 4 else -1
    if nsteps < 1:
        raise ValueError('alphas: expected (nsteps, 2, nz, nx)')
    _check('alphas', alphas, torch.bfloat16, (nsteps, 2, nz, nx), dev)
    _check('gammas', gammas, torch.bfloat16, (nsteps, 2, nz, nx), dev)
    _check('dinv', dinv, torch.bfloat16, (2, nz, nx), dev)
    tx = _pcr_tx(nz)
    lib = _load()
    out = torch.empty_like(b)
    with torch.cuda.device(dev):
        _launch('pcr_sweep', lib.zt_pcr_sweep, alphas.data_ptr(),
                gammas.data_ptr(), dinv.data_ptr(), b.data_ptr(),
                out.data_ptr(), R, nz, nx, nsteps, tx)
    return out


#: shared memory K3 may take for its two column buffers (of the 227 KB a
#: Hopper block can have)
PCR_SMEM_BUDGET = 200 * 1024


def _pcr_tx(nz):
    '''
    K3's strip width: the widest power of two <= 32 whose two buffers of
    nz x TX complex64 values fit in PCR_SMEM_BUDGET.
    '''

    tx = 32
    while tx > 1 and 2 * nz * tx * 8 > PCR_SMEM_BUDGET:
        tx //= 2
    if 2 * nz * tx * 8 > PCR_SMEM_BUDGET:
        raise ValueError('pcr_sweep: nz=%d does not fit one column in '
                         'shared memory' % nz)
    return tx


def prolong_add_smooth(planes, dinv_eff, mask, b, u, ec):
    '''
    K4: the fused upstroke for b, u (R, nz, nx) and
    ec (R, (nz+1)//2, (nx+1)//2) complex64.
    '''

    R, nz, nx = _field_dims(b)
    dev = b.device
    _check('b', b, torch.complex64, (R, nz, nx), dev)
    _check('u', u, torch.complex64, (R, nz, nx), dev)
    _check('ec', ec, torch.complex64, (R, (nz + 1) // 2, (nx + 1) // 2),
           dev)
    _check('planes', planes, torch.complex64, (9, nz, nx), dev)
    _check('dinv_eff', dinv_eff, torch.complex64, (nz, nx), dev)
    _check('mask', mask, torch.float32, (nz, nx), dev)
    lib = _load()
    out = torch.empty_like(b)
    with torch.cuda.device(dev):
        _launch('prolong_add_smooth', lib.zt_prolong_add_smooth,
                planes.data_ptr(), dinv_eff.data_ptr(), mask.data_ptr(),
                b.data_ptr(), u.data_ptr(), ec.data_ptr(), out.data_ptr(),
                R, nz, nx)
    return out


def jacobi_sweep(planes, dinv_eff, b, u):
    '''
    K5: one damped-Jacobi sweep u + dinv_eff (b - A u) for b, u
    (R, nz, nx), planes (9, nz, nx) and dinv_eff (nz, nx), complex64.
    '''

    R, nz, nx = _field_dims(b)
    dev = b.device
    _check('b', b, torch.complex64, (R, nz, nx), dev)
    _check('u', u, torch.complex64, (R, nz, nx), dev)
    _check('planes', planes, torch.complex64, (9, nz, nx), dev)
    _check('dinv_eff', dinv_eff, torch.complex64, (nz, nx), dev)
    lib = _load()
    out = torch.empty_like(b)
    with torch.cuda.device(dev):
        _launch('jacobi_sweep', lib.zt_jacobi_sweep, planes.data_ptr(),
                dinv_eff.data_ptr(), b.data_ptr(), u.data_ptr(),
                out.data_ptr(), R, nz, nx)
    return out


#: the most right-hand sides one K7 launch takes (its grid's z extent)
MAX_TRANSFER_BATCH = 65535


def restrict(v):
    '''
    K7: full-weighting restriction of v (R, nz, nx) complex64 to
    (R, (nz+1)//2, (nx+1)//2).
    '''

    R, nz, nx = _field_dims(v)
    _check('v', v, torch.complex64, (R, nz, nx), v.device)
    if R > MAX_TRANSFER_BATCH:
        raise ValueError('restrict: batch %d > %d' % (R, MAX_TRANSFER_BATCH))
    lib = _load()
    out = torch.empty((R, (nz + 1) // 2, (nx + 1) // 2), dtype=v.dtype,
                      device=v.device)
    with torch.cuda.device(v.device):
        _launch('restrict', lib.zt_restrict, v.data_ptr(), out.data_ptr(),
                R, nz, nx)
    return out


def prolong(vc, nz, nx):
    '''
    K7: bilinear prolongation of vc (R, nzc, nxc) complex64 onto the
    (nz, nx) fine grid, nz <= 2 nzc and nx <= 2 nxc.
    '''

    R, nzc, nxc = _field_dims(vc)
    _check('vc', vc, torch.complex64, (R, nzc, nxc), vc.device)
    nz, nx = int(nz), int(nx)
    if not (1 <= nz <= 2 * nzc and 1 <= nx <= 2 * nxc):
        raise ValueError('prolong: (%d, %d) is not a fine grid of (%d, %d)'
                         % (nz, nx, nzc, nxc))
    if R > MAX_TRANSFER_BATCH:
        raise ValueError('prolong: batch %d > %d' % (R, MAX_TRANSFER_BATCH))
    lib = _load()
    out = torch.empty((R, nz, nx), dtype=vc.dtype, device=vc.device)
    with torch.cuda.device(vc.device):
        _launch('prolong', lib.zt_prolong, vc.data_ptr(), out.data_ptr(),
                R, nzc, nxc, nz, nx)
    return out
