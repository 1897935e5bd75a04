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
anything else (K1 and K8 copy an operand that is not contiguous first,
and count it in ``COPIES``); passes complex64 tensors in place (the kernels
read them as float2 re/im pairs); allocates its outputs with ``torch.empty``;
launches on ``torch.cuda.current_stream()``; raises if the launch
reports an error; and adds one to its entry of ``LAUNCHES``. A failure
to build or launch is an exception: nothing falls back to the torch
twins.

    K1 apply_stencil        csrc/k1_apply_stencil.cu
    K2 presmooth_restrict   csrc/k2_presmooth_restrict.cu
    K3 pcr_sweep            csrc/k3_pcr_sweep.cu
    K4 prolong_add_smooth   csrc/k4_prolong_add_smooth.cu
    K5 jacobi_sweep         csrc/k5_jacobi_sweep.cu
    K6 jacobi_sweep2        csrc/k6_jacobi_sweep2.cu
    K7 restrict, prolong    csrc/k7_transfer.cu
    K8 apply_block_stencil  csrc/k8_apply_block_stencil.cu
    K9 presmooth_residual   csrc/k9_presmooth_residual.cu

The library also holds K11 (``csrc/k11_bicgstab.cu``, the fused
BiCGStab recurrence), which ``ops.krylov_kernels`` binds, launches and
counts itself.
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

from ..utils.profiling import span

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG.parent / 'build' / 'zephyr_tpu_torch_kernels'
SOURCES = ('k1_apply_stencil.cu', 'k2_presmooth_restrict.cu',
           'k3_pcr_sweep.cu', 'k4_prolong_add_smooth.cu',
           'k5_jacobi_sweep.cu', 'k6_jacobi_sweep2.cu', 'k7_transfer.cu',
           'k8_apply_block_stencil.cu', 'k9_presmooth_residual.cu',
           'k11_bicgstab.cu')
HEADERS = ('zt_common.cuh',)
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

#: launches of each kernel since the last ``reset_launches()`` (K6 counts
#: its two variants apart: 'jacobi_sweep2' from u, 'jacobi_sweep2_zero'
#: from zero)
LAUNCHES = {'apply_stencil': 0, 'presmooth_restrict': 0, 'pcr_sweep': 0,
            'prolong_add_smooth': 0, 'jacobi_sweep': 0, 'jacobi_sweep2': 0,
            'jacobi_sweep2_zero': 0, 'restrict': 0, 'prolong': 0,
            'apply_block_stencil': 0, 'presmooth_residual': 0}

#: K1's and K8's input copies since the last ``reset_launches()``: the
#: calls whose u or planes were not contiguous and were copied before the
#: launch
COPIES = {'apply_stencil': 0, 'apply_block_stencil': 0}

_lib = None
_lock = threading.Lock()
#: guards LAUNCHES: the parallel distributor launches from several threads
_count_lock = threading.Lock()
#: (seconds, compiler log) of the build this process made, if any
build_info = None


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for k in COPIES:
        COPIES[k] = 0


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
        with span('kernels.load'):
            lib = ctypes.CDLL(str(build()))
        P, I = ctypes.c_void_p, ctypes.c_int
        sigs = {
            'zt_apply_stencil': [P, P, P, I, I, I, P],
            'zt_presmooth_restrict': [P, P, P, P, P, P, I, I, I, I, I, P],
            'zt_pcr_sweep': [P, P, P, I, I, I, I, I, I, I, I, I, P],
            'zt_prolong_add_smooth': [P, P, P, P, P, P, P, I, I, I, P],
            'zt_jacobi_sweep': [P, P, P, P, P, I, I, I, P],
            'zt_jacobi_sweep2': [P, P, P, P, P, I, I, I, I, P],
            'zt_presmooth_residual': [P, P, P, P, P, P, I, I, I, I, P],
            'zt_restrict': [P, P, I, I, I, P],
            'zt_prolong': [P, P, I, I, I, I, I, P],
            'zt_apply_block_stencil': [P, P, P, I, I, I, I, P],
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
    with _count_lock:
        LAUNCHES[name] += 1


def apply_stencil(planes, u):
    '''
    K1: (A u)[r] for planes (9, nz, nx), u (R, nz, nx), complex64. An
    operand that is not contiguous is copied first (counted in
    ``COPIES``).
    '''

    R, nz, nx = _field_dims(u)
    if not (u.is_contiguous() and planes.is_contiguous()):
        COPIES['apply_stencil'] += 1
        u, planes = u.contiguous(), planes.contiguous()
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
    g = _ps_group(nz, nx, R)
    _check_groups(R, g)
    return _presmooth_restrict_launch(planes, dinv_eff, mask, b, nsweeps, g)


def _presmooth_restrict_launch(planes, dinv_eff, mask, b, nsweeps, g):
    'K2 with g RHS a block, on checked operands.'

    R, nz, nx = b.shape
    lib = _load()
    u = torch.empty_like(b)
    rc = torch.empty((R, (nz + 1) // 2, (nx + 1) // 2), dtype=b.dtype,
                     device=b.device)
    with torch.cuda.device(b.device):
        _launch('presmooth_restrict', lib.zt_presmooth_restrict,
                planes.data_ptr(), dinv_eff.data_ptr(), mask.data_ptr(),
                b.data_ptr(), u.data_ptr(), rc.data_ptr(), R, nz, nx,
                nsweeps, g)
    return u, rc


#: the H100's streaming multiprocessors, and the blocks K2 should launch
#: on each (one of its blocks fits an SM at a time)
SM_COUNT = 132
PS_BLOCKS_PER_SM = 2
#: the most RHS groups one launch takes (its grid's z extent)
MAX_GROUPS = 65535


def _rhs_group(tiles, R, blocks_per_sm):
    '''
    The RHS one block takes, on the coefficients of its tile loaded once:
    as large as R allows while the launch still has ``blocks_per_sm``
    blocks an SM, the groups split evenly.
    '''

    gmax = max(1, int(tiles) * int(R) // (SM_COUNT * blocks_per_sm))
    ngroups = -(-int(R) // gmax)
    return -(-int(R) // ngroups)


def _ps_group(nz, nx, R):
    '''
    K2's RHS group for its 32 x 32 fine tile (2048^2 and 1024^2 x 16: 16;
    512^2: 8; 256^2: 3; 128^2 and below: 1).
    '''

    return _rhs_group(-(-int(nz) // 32) * -(-int(nx) // 32), R,
                      PS_BLOCKS_PER_SM)


def pcr_sweep(packed, b):
    '''
    K3: the bf16-factor PCR sweep of b (R, nz, nx) complex64, with the
    factors in the packed layout of ``stratified.pack_pcr_factors``:
    (nsteps + 1, nx, nz, 4) bfloat16.
    '''

    R, nz, nx = _field_dims(b)
    dev = b.device
    _check('b', b, torch.complex64, (R, nz, nx), dev)
    nsteps = packed.shape[0] - 1 if packed.dim() == 4 else 0
    if nsteps < 1:
        raise ValueError('packed: expected (nsteps + 1, nx, nz, 4)')
    _check('packed', packed, torch.bfloat16, (nsteps + 1, nx, nz, 4), dev)
    return _pcr_sweep_launch(packed, b, _pcr_plan(nz, R))


def _pcr_sweep_launch(packed, b, plan):
    'K3 with a given (k, g, w, cb) plan, on checked operands.'

    R, nz, nx = b.shape
    nsteps = packed.shape[0] - 1
    k, g, w, cb = plan
    lib = _load()
    out = torch.empty_like(b)
    with torch.cuda.device(b.device):
        _launch('pcr_sweep', lib.zt_pcr_sweep, packed.data_ptr(),
                b.data_ptr(), out.data_ptr(), R, nz, nx, nsteps,
                min(nsteps, _pcr_levels(nz)), k, g, w, cb)
    return out


#: shared memory K3 may take for its staging and exchange regions (all a
#: Hopper block can have)
PCR_SMEM_BUDGET = 227 * 1024
#: the deepest column K3 takes (32 warps of 16 slots a lane)
PCR_MAX_NZ = 32 * 32 * 16


def _pcr_levels(nz):
    'The PCR levels with stride s = 2^level < nz.'
    return max(0, (int(nz) - 1).bit_length())


def _pcr_plan(nz, R):
    '''
    K3's launch plan (k, g, w, cb) for columns of depth nz and R RHS: k
    slots a lane (a power of two <= 16), w warps a column (more than one
    only at k = 16), g RHS a thread (4 at k <= 8, 2 at k = 16, at most the
    power of two <= R, halved while the block's shared regions exceed
    PCR_SMEM_BUDGET) and cb columns a block (4, fewer when a column takes
    more than 4 warps: at most 16 warps a block, or one column of up to 32
    warps at g = 1). State 2 g k floats and k factor words a thread keep
    it within 128 registers.
    '''

    nz, R = int(nz), int(R)
    if not 1 <= nz <= PCR_MAX_NZ:
        raise ValueError('pcr_sweep: nz=%d outside 1..%d' % (nz, PCR_MAX_NZ))
    k = 1
    while k < 16 and 32 * k < nz:
        k *= 2
    w = -(-nz // (32 * k))
    g = 4 if k <= 8 else 2
    while g > 1 and g > R:
        g //= 2
    cb = max(1, min(4, 16 // w))
    if w > 16:
        g = 1
    while g > 1 and cb * g * w * 32 * k * 8 > PCR_SMEM_BUDGET:
        g //= 2
    while cb > 1 and cb * g * w * 32 * k * 8 > PCR_SMEM_BUDGET:
        cb -= 1
    return k, g, w, cb


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


def jacobi_sweep2(planes, dinv_eff, b, u=None):
    '''
    K6: two damped-Jacobi sweeps for b, u (R, nz, nx), planes (9, nz, nx)
    and dinv_eff (nz, nx), complex64; ``u=None`` starts from zero.
    '''

    R, nz, nx = _field_dims(b)
    dev = b.device
    _check('b', b, torch.complex64, (R, nz, nx), dev)
    if u is not None:
        _check('u', u, torch.complex64, (R, nz, nx), dev)
    _check('planes', planes, torch.complex64, (9, nz, nx), dev)
    _check('dinv_eff', dinv_eff, torch.complex64, (nz, nx), dev)
    g = _k6_group(nz, nx, R)
    _check_groups(R, g)
    return _jacobi_sweep2_launch(planes, dinv_eff, b, u, g)


#: the blocks K6 should launch on each SM: one wave of the two that fit an
#: SM at a time (more groups than that only re-read the coefficients)
K6_BLOCKS_PER_SM = 2


def _k6_group(nz, nx, R):
    '''
    K6's RHS group for its 16 x 32 tile (``_rhs_group``; 2048^2 to 512^2
    x 16: 16; 256^2: 6; 128^2 and below: 1).
    '''

    return _rhs_group(-(-int(nz) // 16) * -(-int(nx) // 32), R,
                      K6_BLOCKS_PER_SM)


def _jacobi_sweep2_launch(planes, dinv_eff, b, u, g):
    'K6 with g RHS a block, on checked operands.'

    R, nz, nx = b.shape
    lib = _load()
    out = torch.empty_like(b)
    with torch.cuda.device(b.device):
        _launch('jacobi_sweep2' if u is not None else 'jacobi_sweep2_zero',
                lib.zt_jacobi_sweep2, planes.data_ptr(),
                dinv_eff.data_ptr(), b.data_ptr(),
                None if u is None else u.data_ptr(), out.data_ptr(), R, nz,
                nx, g)
    return out


def _check_groups(R, g):
    if -(-int(R) // g) > MAX_GROUPS:
        raise ValueError('batch %d in groups of %d: more than %d groups'
                         % (R, g, MAX_GROUPS))


def presmooth_residual(planes, dinv_eff, mask, b):
    '''
    K9: (u2, mask * (b - A u2)) of two damped-Jacobi sweeps from zero, for
    b (R, nz, nx) and dinv_eff (nz, nx) complex64, mask (nz, nx) float32.
    '''

    R, nz, nx = _field_dims(b)
    dev = b.device
    _check('b', b, torch.complex64, (R, nz, nx), dev)
    _check('planes', planes, torch.complex64, (9, nz, nx), dev)
    _check('dinv_eff', dinv_eff, torch.complex64, (nz, nx), dev)
    _check('mask', mask, torch.float32, (nz, nx), dev)
    g = _k9_group(nz, nx, R)
    _check_groups(R, g)
    return _presmooth_residual_launch(planes, dinv_eff, mask, b, g)


def _k9_group(nz, nx, R):
    '''
    K9's RHS group: it runs on K6's 16 x 32 tile, two blocks an SM
    (``_k6_group``).
    '''

    return _k6_group(nz, nx, R)


def _presmooth_residual_launch(planes, dinv_eff, mask, b, g):
    'K9 with g RHS a block, on checked operands.'

    R, nz, nx = b.shape
    lib = _load()
    u = torch.empty_like(b)
    res = torch.empty_like(b)
    with torch.cuda.device(b.device):
        _launch('presmooth_residual', lib.zt_presmooth_residual,
                planes.data_ptr(), dinv_eff.data_ptr(), mask.data_ptr(),
                b.data_ptr(), u.data_ptr(), res.data_ptr(), R, nz, nx, g)
    return u, res


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


#: the blocks K8 should launch on each SM: one wave of the four that fit
#: an SM at a time
K8_BLOCKS_PER_SM = 4


def _k8_group(nz, nx, R):
    '''
    K8's RHS group for its 4 x 32 tile (``_rhs_group``; 2048^2 and 512^2
    x 16: 16; 256^2: 8; 128^2: 3; 64^2 and below: 1).
    '''

    return _rhs_group(-(-int(nz) // 4) * -(-int(nx) // 32), R,
                      K8_BLOCKS_PER_SM)


def apply_block_stencil(planes, u):
    '''
    K8: the 2x2 block apply (A u)[r] for planes (2, 2, 9, nz, nx) and
    u (R, 2, nz, nx), complex64. An operand that is not contiguous is
    copied first (counted in ``COPIES``).
    '''

    if not isinstance(u, torch.Tensor) or u.device.type != 'cuda':
        raise ValueError('CUDA kernels take CUDA tensors')
    if u.dim() != 4 or u.shape[1] != 2:
        raise ValueError('expected an (R, 2, nz, nx) batch, got shape %s'
                         % (tuple(u.shape),))
    R, _, nz, nx = u.shape
    if min(R, nz, nx) < 1:
        raise ValueError('empty batch or grid: %s' % (tuple(u.shape),))
    if not (u.is_contiguous() and planes.is_contiguous()):
        COPIES['apply_block_stencil'] += 1
        u, planes = u.contiguous(), planes.contiguous()
    dev = u.device
    _check('u', u, torch.complex64, (R, 2, nz, nx), dev)
    _check('planes', planes, torch.complex64, (2, 2, 9, nz, nx), dev)
    g = _k8_group(nz, nx, R)
    _check_groups(R, g)
    return _apply_block_stencil_launch(planes, u, g)


def _apply_block_stencil_launch(planes, u, g):
    'K8 with g RHS a block, on checked operands.'

    R, _, nz, nx = u.shape
    lib = _load()
    out = torch.empty_like(u)
    with torch.cuda.device(u.device):
        _launch('apply_block_stencil', lib.zt_apply_block_stencil,
                planes.data_ptr(), u.data_ptr(), out.data_ptr(), R, nz, nx,
                g)
    return out
