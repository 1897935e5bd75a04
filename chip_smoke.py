#!/usr/bin/env python3
'''
Drive the PyTorch/CUDA port (zephyr_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each fails loudly: a non-zero exit and no final ok line):

1. versions, the card's name and power limit, the TF32 switches (both
   set off and printed);
2. build the CUDA kernels K1-K9 from zephyr_tpu_torch/csrc with nvcc
   (one nvcc per source, all started together), printing ptxas's
   register and spill counts;
3. hold each kernel against its plain torch twin on the card, complex64,
   at the main path's shapes and at odd ones (fail above 1e-5 relative to
   the twin's largest magnitude), and time both, beside the least time
   the card could take (its byte or operation bound) and, where one
   PyTorch call computes the same function (K7: a strided convolution),
   that call's time; K3 also at nz=2048 (the default config's
   full-resolution family, 11 levels); K1 also at R=1 and odd shapes
   (the unbatched apply K10); K8 at 2048^2 and 512^2 x 16 and 37x53 x 3;
   K6 (from u and from zero) and K9 beside K1/K2/K4;
4. the forward-modelling oracle: ``MiniZephyr(config) * q`` on the card
   with the production solver options (4) and with no solverOpts, the
   default SolverConfig (4b), against AnalyticalHelmholtz
   (interior-window error must stay below 1e-2);
5. the headline: 2048^2, 16 point sources, 16 cells per wavelength,
   ``prepare_operator`` + ``make_chunked_solver(cfg, chunk=32)`` on the
   homogeneous and the 4-layer model with the production config, and on
   the homogeneous model with the default config (5b) (relres <= 1e-5),
   plus the homogeneous oracle errors;
6. (after 7-9) the launch counts of every kernel: over phases 4-7
   (K1-K5, K7 must be > 0), over phase 8 (K7, K8) and over phase 9 (K1-K4,
   K6 both variants, K7, K9), each path driven with the counts set to 0
   just before it;
7. gradients: (a) ``fwi_misfit_grad_chunked`` at the bench's gradient
   size (2048^2 layered, 16 sources, 8 frequencies, 64 receivers, grids
   by targetGPW 16), finite and non-zero; (b) the backward of ``solve``
   at 2048^2 x 16 with the production config, timed; (c) at 512^2
   layered, one frequency, the gradient w.r.t. c by autograd through
   ``solve`` against ``fwi_misfit_grad_chunked`` (max-norm relative
   difference <= 1e-3);
8. TTI (the Eurus 2x2 block system, GMRES, line-smoothed multigrid, K8)
   in complex64: (a) ``Eurus(config) * q`` against the analytical oracle
   at 200x100, isotropic and elliptical (error < 3e-2), default
   SolverConfig; (b) the bench's ``eurus`` row (bench.py:425-484): 512^2
   homogeneous, 16 sources, theta 0.3, eps 0.2, delta 0.1, the production
   config with gmres_restart=20, mg_nu1=mg_nu2=1, make_chunked_solver
   (chunk 16), warm-up then timed; (c) ``eurus_layered`` at 256^2 on the
   4-layer model, timed without a warm-up of its own; (d) the
   line-smoother pin of tests/test_eurus.py:86-123 (128^2 layered,
   solve_info). (b)-(d) must end finite and below their
   starting residual; whether they reach 1e-5 is printed, with the chunk
   residual trace;
9. Marmousi-class media (the bench's rough model, bench.py:107-157, 16
   sources as phase 5 draws them): (a) the bench's ``marmousi`` row,
   2048^2 with the production config, whose auto rule must give 8
   x-panels (relres <= 1e-5), warm-up then timed; (b) the same row with
   mg_nu1=mg_nu2=3 (K6 both variants, no K2), run once, stopped at (a)'s
   iteration count (it stalls, in the JAX package too: finite and below
   its start is checked); (c) the public ``multigrid.presmooth_residual``
   on level 0 of (a)'s hierarchy at R=16 (K9), held against K2's
   restriction of the same downstroke; (d) the bench's
   ``gradient_marmousi`` row at 512^2 (finite, non-zero); (e) phase 7c's
   autograd-vs-chunked agreement on the 512^2 Marmousi model (2 panels,
   the transposed panel family in the backward).

It prints one JSON line of per-kernel results, the nvidia-smi line, and
as its last line {"ok": true, "device": {...}}. It needs one CUDA device
and exits non-zero without one.
'''

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

#: the production solver config (bench.py:91-93)
PRODUCTION = dict(tol=1e-5, maxiter=2000, mg_coarse='inv', mg_min_size=32,
                  fft_mode='strat', fft_scale=2, hybrid_comp='fused',
                  mg_nu1=2, mg_nu2=1)

KERNELS = {
    'apply_stencil': ('K1', 'zephyr_tpu_torch/csrc/k1_apply_stencil.cu',
                      'zephyr_tpu/ops/pallas_stencil.py:312'),
    'presmooth_restrict': ('K2',
                           'zephyr_tpu_torch/csrc/k2_presmooth_restrict.cu',
                           'zephyr_tpu/ops/pallas_stencil.py:1687'),
    'pcr_sweep': ('K3', 'zephyr_tpu_torch/csrc/k3_pcr_sweep.cu',
                  'zephyr_tpu/ops/pallas_pcr.py:236'),
    'prolong_add_smooth': ('K4',
                           'zephyr_tpu_torch/csrc/k4_prolong_add_smooth.cu',
                           'zephyr_tpu/ops/pallas_stencil.py:1321'),
    'jacobi_sweep': ('K5', 'zephyr_tpu_torch/csrc/k5_jacobi_sweep.cu',
                     'zephyr_tpu/ops/pallas_stencil.py:450'),
    'jacobi_sweep2': ('K6', 'zephyr_tpu_torch/csrc/k6_jacobi_sweep2.cu',
                      'zephyr_tpu/ops/pallas_stencil.py:534'),
    'jacobi_sweep2_zero': ('K6',
                           'zephyr_tpu_torch/csrc/k6_jacobi_sweep2.cu',
                           'zephyr_tpu/ops/pallas_stencil.py:534'),
    'restrict': ('K7', 'zephyr_tpu_torch/csrc/k7_transfer.cu',
                 'zephyr_tpu/ops/pallas_transfer.py:77'),
    'prolong': ('K7', 'zephyr_tpu_torch/csrc/k7_transfer.cu',
                'zephyr_tpu/ops/pallas_transfer.py:77'),
    'apply_block_stencil': ('K8',
                            'zephyr_tpu_torch/csrc/k8_apply_block_stencil.cu',
                            'zephyr_tpu/ops/pallas_stencil.py:1013'),
    'presmooth_residual': ('K9',
                           'zephyr_tpu_torch/csrc/k9_presmooth_residual.cu',
                           'zephyr_tpu/ops/pallas_stencil.py:748'),
}
KERNEL_TOL = 1e-5
#: the card's peaks for the bounds (H100 SXM data sheet, at 700 W): device
#: memory bytes/s, and float32 flop/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
#: the device of every phase (a CPU rehearsal of the control flow may set
#: it to 'cpu'; the script itself always runs on 'cuda')
DEV = 'cuda'


def fail(msg):
    print('FAIL: ' + msg, flush=True)
    raise SystemExit(1)


def say(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --- phase 3 helpers ------------------------------------------------------

def work(name, nz, nx, R, nsteps=None):
    '''
    (bytes, flops) one launch must move and compute at this shape: each
    input read once, each output written once (complex64 8 B, the mask
    float32 4 B, the bf16 PCR factors 2 B per part); flops count a complex
    product as 6 and a complex multiply-add as 8.
    '''
    N = nz * nx
    Nc = ((nz + 1) // 2) * ((nx + 1) // 2)
    if name == 'apply_stencil':
        return 8 * (9 * N + 2 * R * N), 72 * R * N
    if name == 'presmooth_restrict':     # two sweeps (the main path)
        return 8 * (10 * N + 2 * R * N + R * Nc) + 4 * N, \
            R * (164 * N + 36 * Nc)
    if name == 'pcr_sweep':
        return 8 * nsteps * N + 4 * N + 16 * R * N, \
            R * N * (16 * nsteps + 6)
    if name == 'prolong_add_smooth':
        return 8 * (10 * N + 3 * R * N + R * Nc) + 4 * N, 102 * R * N
    if name == 'jacobi_sweep':
        return 8 * (10 * N + 3 * R * N), 82 * R * N
    if name == 'jacobi_sweep2':          # two sweeps from u
        return 8 * (10 * N + 3 * R * N), 164 * R * N
    if name == 'jacobi_sweep2_zero':     # D b, then one sweep
        return 8 * (10 * N + 2 * R * N), 88 * R * N
    if name == 'presmooth_residual':     # two sweeps + masked residual
        return 8 * (10 * N + 3 * R * N) + 4 * N, 164 * R * N
    if name == 'restrict':
        return 8 * R * (N + Nc), 36 * R * Nc
    if name == 'prolong':
        return 8 * R * (Nc + N), 16 * R * N
    if name == 'apply_block_stencil':
        return 8 * (36 * N + 4 * R * N), 292 * R * N
    raise KeyError(name)


def bound(nbytes, flops):
    '(ms, "bytes" or "operations"): the least time the card could take.'
    t_b = nbytes / PEAK_BYTES_S * 1e3
    t_f = flops / PEAK_F32_FLOPS * 1e3
    return (t_b, 'bytes') if t_b >= t_f else (t_f, 'operations')


def library_restrict(v):
    '''
    One PyTorch call computing K7's restriction: a stride-2 3x3
    convolution of the (R, 1, nz, nx, 2) real view.
    '''
    import torch
    w = torch.tensor([0.5, 1.0, 0.5], device=v.device)
    W = (0.25 * torch.outer(w, w)).reshape(1, 1, 3, 3, 1)
    out = torch.nn.functional.conv3d(torch.view_as_real(v).unsqueeze(1), W,
                                     stride=(2, 2, 1), padding=(1, 1, 0))
    return torch.view_as_complex(out.squeeze(1))


def library_prolong(vc):
    '''
    One PyTorch call computing K7's prolongation onto the (2 nzc, 2 nxc)
    grid: a stride-2 transposed 3x3 convolution of the real view.
    '''
    import torch
    w = torch.tensor([0.5, 1.0, 0.5], device=vc.device)
    W = torch.outer(w, w).reshape(1, 1, 3, 3, 1)
    out = torch.nn.functional.conv_transpose3d(
        torch.view_as_real(vc).unsqueeze(1), W, stride=(2, 2, 1),
        padding=(1, 1, 0), output_padding=(1, 1, 0))
    return torch.view_as_complex(out.squeeze(1))


def compact_trace(trace):
    '''
    A chunk trace [(iterations, worst relres), ...] with runs of equal
    entries (relres to 4 digits) merged: [[iterations, relres, count]].
    '''
    out = []
    for it, rr in trace:
        rr = float('%.4g' % rr)
        if out and out[-1][:2] == [it, rr]:
            out[-1][2] += 1
        else:
            out.append([it, rr, 1])
    return out


def cuda_ms(fn, reps=10, warm=2):
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def rel_err(out, ref):
    '(max |out - ref| / max |ref|, max |out - ref|), over all outputs.'
    import torch
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    abs_err = max(float(torch.max(torch.abs(o - r)))
                  for o, r in zip(outs, refs))
    scale = max(float(torch.max(torch.abs(r))) for r in refs)
    for o in outs:
        if not bool(torch.isfinite(o).all()):
            return float('inf'), float('inf')
    return abs_err / scale, abs_err


def level_inputs(n_z, n_x, R, gen, shifted=True):
    '''
    Real main-path operands at (n_z, n_x): MiniZephyr planes of the
    CSLP-shifted operator (c 1500, 16 cells per wavelength), the damped
    diagonal inverse and the ring mask, plus random fields.
    '''
    import torch
    from zephyr_tpu_torch.ops.minizephyr_coeff import minizephyr_planes
    from zephyr_tpu_torch.solver.helmholtz import shifted_velocity
    from zephyr_tpu_torch.solver.multigrid import _ring_mask
    dev = DEV
    c = torch.full((n_z, n_x), 1500.0, dtype=torch.complex64, device=dev)
    rho = torch.ones((n_z, n_x), dtype=torch.float32, device=dev)
    if shifted:
        c = shifted_velocity(c, 0.5j)
    planes = minizephyr_planes(c, rho, 1500.0 / 16, pml_cap=1.0)
    D = (0.5 / planes[4]).contiguous()
    mask = _ring_mask(n_z, n_x, torch.float32, dev)

    def field(*shape):
        return torch.complex(
            torch.randn(shape, generator=gen, device=dev),
            torch.randn(shape, generator=gen, device=dev)).contiguous()
    return planes.contiguous(), D, mask, field


#: the bench's TTI anisotropy (bench.py:447-449)
TTI_ANISO = dict(theta=0.3, eps=0.2, delta=0.1)
#: the bench's TTI solver options: production with gmres_restart=20 and
#: mg_nu1=mg_nu2=1 (bench.py:441)
TTI_OPTS = dict(PRODUCTION, gmres_restart=20, mg_nu1=1, mg_nu2=1)


def tti_planes(n_z, n_x, c_np=None, shift=0.5j, pml_cap=1.0):
    '''
    The true and the CSLP-shifted Eurus planes, complex64 on the card, of
    the bench's TTI rows: c 1500 (or ``c_np``), rho 1, freq 1500/16 and
    TTI_ANISO.
    '''
    import torch
    from zephyr_tpu_torch.ops.eurus_coeff import eurus_planes
    from zephyr_tpu_torch.solver.helmholtz import shifted_velocity
    if c_np is None:
        c_np = np.full((n_z, n_x), 1500.0, np.float32)
    c = torch.as_tensor(c_np, device=DEV).to(torch.complex64)
    rho = torch.ones((n_z, n_x), dtype=torch.float32, device=DEV)
    aniso = {k: torch.full((n_z, n_x), v, dtype=torch.float32, device=DEV)
             for k, v in TTI_ANISO.items()}
    freq = 1500.0 / 16
    return (eurus_planes(c, rho, freq, **aniso),
            eurus_planes(shifted_velocity(c, shift), rho, freq,
                         pml_cap=pml_cap, **aniso))


def strat_factors(n, full=False):
    '''
    bf16 PCR factors for the n x n homogeneous model: of the fused
    cycle's half grid (the stratified coefficients of its Galerkin-
    coarsened true and shifted operators), or with ``full`` of the
    default config's full-resolution family (the fine planes).
    '''
    import torch
    from zephyr_tpu_torch.ops.minizephyr_coeff import minizephyr_planes
    from zephyr_tpu_torch.solver.helmholtz import shifted_velocity
    from zephyr_tpu_torch.solver.multigrid import (
        _ring_mask, _mask_ring_planes, _fix_empty_rows, galerkin_coarsen)
    from zephyr_tpu_torch.solver.stratified import (stratified_coeffs,
                                                    pcr_precompute)
    c = torch.full((n, n), 1500.0, dtype=torch.complex64, device=DEV)
    rho = torch.ones((n, n), dtype=torch.float32, device=DEV)
    f = 1500.0 / 16
    tp = minizephyr_planes(c, rho, f)[None, None]
    pp = minizephyr_planes(shifted_velocity(c, 0.5j), rho, f,
                           pml_cap=1.0)[None, None]
    if full:
        return pcr_precompute(*stratified_coeffs(tp, pp, 0.5j, 'auto'))
    mask = _ring_mask(n, n, torch.float32, DEV)
    ct = _fix_empty_rows(galerkin_coarsen(_mask_ring_planes(tp, mask)))
    cp = _fix_empty_rows(galerkin_coarsen(_mask_ring_planes(pp, mask)))
    return pcr_precompute(*stratified_coeffs(ct, cp, 0.5j, 'auto'))


def check_kernels():
    '''
    Phase 3: every kernel against its twin on the card. Returns
    {name: {'max_abs_err', 'ms', 'plain_ms'}} with the error and times
    at the main-path shape.
    '''
    import torch
    from zephyr_tpu_torch.ops import cuda_kernels as ck
    from zephyr_tpu_torch.ops import stencil
    from zephyr_tpu_torch.solver import multigrid, stratified
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    results = {}

    def record(name, shape_desc, out, ref, main=False, timing=None,
               key=None, shape=None, library=None):
        '''
        Check out against ref; for a main-path shape also time the kernel
        and its twin (and the library call, if any), beside the bound of
        ``work(name, *shape)``.
        '''
        rel, abs_err = rel_err(out, ref)
        say('  %-19s %-26s rel err %.3e  abs err %.3e'
            % (name, shape_desc, rel, abs_err))
        if not rel <= KERNEL_TOL:
            fail('%s disagrees with its twin at %s: %.3e > %.0e'
                 % (name, shape_desc, rel, KERNEL_TOL))
        if main:
            key = key or name
            kern, plain = timing
            nbytes, flops = work(name, *shape)
            b_ms, b_by = bound(nbytes, flops)
            r = {'max_abs_err': abs_err, 'ms': cuda_ms(kern),
                 'plain_ms': cuda_ms(plain), 'bound_ms': b_ms,
                 'bound_by': b_by, 'bytes': nbytes, 'flops': flops,
                 'library_ms': None}
            if library is not None:
                lib_err = rel_err(library(), ref)[0]
                r['library_ms'] = cuda_ms(library)
                r['library_rel_err'] = lib_err
            results[key] = r
            say('  %-19s %-26s kernel %.3f ms  plain %.3f ms  bound %.3f ms '
                '(%s)  library %s'
                % (name, shape_desc, r['ms'], r['plain_ms'], b_ms, b_by,
                   'none' if r['library_ms'] is None
                   else '%.3f ms (rel err %.1e)' % (r['library_ms'],
                                                    r['library_rel_err'])))

    # K1, K2 (1 and 2 sweeps), K4: main-path shapes and an odd one
    for (nz, nx, R, main) in ((2048, 2048, 16, True),
                              (1024, 1024, 16, False),
                              (37, 53, 3, False), (25, 50, 1, False)):
        desc = '%dx%d R=%d' % (nz, nx, R)
        planes, D, mask, field = level_inputs(nz, nx, R, gen)
        u = field(R, nz, nx)
        b = field(R, nz, nx)
        ec = field(R, (nz + 1) // 2, (nx + 1) // 2)

        shape = (nz, nx, R)
        record('apply_stencil', desc, ck.apply_stencil(planes, u),
               stencil.apply_stencil(planes, u), main,
               (lambda: ck.apply_stencil(planes, u),
                lambda: stencil.apply_stencil(planes, u)), shape=shape)
        # K10, the unbatched apply: K1 at R=1
        u1 = u[:1].contiguous()
        record('apply_stencil', desc.replace('R=%d' % R, 'R=1'),
               ck.apply_stencil(planes, u1), stencil.apply_stencil(planes, u1),
               main, (lambda: ck.apply_stencil(planes, u1),
                      lambda: stencil.apply_stencil(planes, u1)),
               key='apply_stencil R=1', shape=(nz, nx, 1))
        for ns, ref in ((2, stencil._ps2rr_ref), (1, stencil._ps1rr_ref)):
            record('presmooth_restrict',
                   desc + ' nsweeps=%d' % ns,
                   ck.presmooth_restrict(planes, D, mask, b, ns),
                   ref(planes, D, mask, b), main and ns == 2,
                   (lambda: ck.presmooth_restrict(planes, D, mask, b, 2),
                    lambda: stencil._ps2rr_ref(planes, D, mask, b)),
                   shape=shape)
        record('prolong_add_smooth', desc,
               ck.prolong_add_smooth(planes, D, mask, b, u, ec),
               stencil._pas_ref(planes, D, mask, b, u, ec), main,
               (lambda: ck.prolong_add_smooth(planes, D, mask, b, u, ec),
                lambda: stencil._pas_ref(planes, D, mask, b, u, ec)),
               shape=shape)
        record('jacobi_sweep', desc, ck.jacobi_sweep(planes, D, b, u),
               stencil._jacobi_ref(planes, D, b, u), main,
               (lambda: ck.jacobi_sweep(planes, D, b, u),
                lambda: stencil._jacobi_ref(planes, D, b, u)), shape=shape)
        record('jacobi_sweep2', desc, ck.jacobi_sweep2(planes, D, b, u),
               stencil._jacobi2_ref(planes, D, b, u), main,
               (lambda: ck.jacobi_sweep2(planes, D, b, u),
                lambda: stencil._jacobi2_ref(planes, D, b, u)), shape=shape)
        record('jacobi_sweep2_zero', desc, ck.jacobi_sweep2(planes, D, b),
               stencil._jacobi2z_ref(planes, D, b), main,
               (lambda: ck.jacobi_sweep2(planes, D, b),
                lambda: stencil._jacobi2z_ref(planes, D, b)), shape=shape)
        record('presmooth_residual', desc,
               ck.presmooth_residual(planes, D, mask, b),
               stencil._ps2r_ref(planes, D, mask, b), main,
               (lambda: ck.presmooth_residual(planes, D, mask, b),
                lambda: stencil._ps2r_ref(planes, D, mask, b)), shape=shape)
        cdesc = '%s -> %dx%d' % (desc, (nz + 1) // 2, (nx + 1) // 2)
        record('restrict', cdesc, ck.restrict(b),
               multigrid._restrict_ref(b), main,
               (lambda: ck.restrict(b),
                lambda: multigrid._restrict_ref(b)), shape=shape,
               library=lambda: library_restrict(b))
        pdesc = '%dx%d -> %s' % ((nz + 1) // 2, (nx + 1) // 2, desc)
        record('prolong', pdesc, ck.prolong(ec, nz, nx),
               multigrid._prolong_ref(ec, nz, nx), main,
               (lambda: ck.prolong(ec, nz, nx),
                lambda: multigrid._prolong_ref(ec, nz, nx)), shape=shape,
               library=lambda: library_prolong(ec))
        del planes, D, mask, u, u1, b, ec
        torch.cuda.empty_cache()

    # K8: the 2x2 block apply on the shifted Eurus TTI planes
    for (nz, nx, R, main) in ((2048, 2048, 16, True), (512, 512, 16, False),
                              (37, 53, 3, False)):
        desc = '%dx%d R=%d' % (nz, nx, R)
        planes = tti_planes(nz, nx)[1]
        u = torch.complex(torch.randn((R, 2, nz, nx), generator=gen,
                                      device=DEV),
                          torch.randn((R, 2, nz, nx), generator=gen,
                                      device=DEV))
        record('apply_block_stencil', desc,
               ck.apply_block_stencil(planes, u),
               stencil.apply_block_stencil(planes, u), main,
               (lambda: ck.apply_block_stencil(planes, u),
                lambda: stencil.apply_block_stencil(planes, u)),
               shape=(nz, nx, R))
        del planes, u
        torch.cuda.empty_cache()

    # K3: half grids of the 2048^2 (nz=1024, 10 levels) and 1024^2
    # (nz=512, 9 levels) fused cycles, and the full-resolution family of
    # the default config at 2048^2 (nz=2048, 11 levels, strip width 4);
    # R=1 and R=16
    for n, main_R, full in ((2048, 16, False), (1024, None, False),
                            (2048, 16, True)):
        pcr = strat_factors(n, full)
        nz = n if full else n // 2
        for R in (1, 16):
            b = torch.complex(torch.randn((R, nz, nz), generator=gen,
                                          device=DEV),
                              torch.randn((R, nz, nz), generator=gen,
                                          device=DEV))
            args = (pcr.alphas, pcr.gammas, pcr.dinv, b)
            record('pcr_sweep', 'nz=%d levels=%d R=%d'
                   % (nz, pcr.alphas.shape[0], R),
                   ck.pcr_sweep(*args),
                   stratified._pcr_sweep_bf16_ref(*args),
                   R == main_R,
                   (lambda: ck.pcr_sweep(*args),
                    lambda: stratified._pcr_sweep_bf16_ref(*args)),
                   key='pcr_sweep nz=%d' % nz if full else None,
                   shape=(nz, nz, R, pcr.alphas.shape[0]))
            del b, args
        del pcr
        torch.cuda.empty_cache()
    return results


# --- phases 4-5 -----------------------------------------------------------

def oracle_flow(opts=PRODUCTION):
    '''
    Phase 4: MiniZephyr * q on the card against the analytical oracle,
    with the given solverOpts (None: none, the default SolverConfig).
    '''
    from zephyr_tpu_torch.backend import (MiniZephyr, SparseKaiserSource,
                                          AnalyticalHelmholtz)
    config = {'c': 2500., 'rho': 1., 'nx': 100, 'nz': 200, 'freq': 200.,
              'device': DEV}
    if opts is not None:
        config['solverOpts'] = dict(opts)
    loc = np.array([[25., 25.]])
    t0 = time.perf_counter()
    u = MiniZephyr(config) * SparseKaiserSource(config)(loc)
    secs = time.perf_counter() - t0
    uAH = AnalyticalHelmholtz(config)(loc)
    if u.shape != (200 * 100, 1) or not np.isfinite(u).all():
        fail('oracle: wavefield of shape %s, finite %s'
             % (u.shape, np.isfinite(u).all()))
    seg = (slice(40, 180), slice(40, 80))
    uM, uA = u.ravel().reshape(200, 100)[seg], uAH.reshape(200, 100)[seg]
    rel = (uA - uM) / abs(uA)
    err = np.sqrt((rel.conj() * rel).sum()).real / rel.size
    say('oracle 200x100 MiniZephyr * q on %s, %s config: error %.3e '
        '(limit 1e-2), %.2f s' % (DEV, 'default' if opts is None
                                  else 'production', err, secs))
    if not err < 1e-2:
        fail('oracle error %.3e >= 1e-2' % err)
    return err


def layered_c(n):
    'The 4-layer 1500-3000 m/s model of bench.py:100-104.'
    c = np.zeros((n, n), dtype=np.float32)
    for i, v in enumerate([1500., 2000., 2500., 3000.]):
        c[i * n // 4:(i + 1) * n // 4] = v
    return c


def marmousi_c(n, dtype=np.float32):
    '''
    The bench's rough Marmousi-style model (bench.py:107-157, a copy):
    dipping folded thin beds with a lateral trend, fault offsets, a
    low-velocity lens and band-limited 1/k roughness of 120 m/s rms.
    '''
    z = np.linspace(0., 1., n)[:, None]
    x = np.linspace(0., 1., n)[None, :]
    horizon = z + 0.15 * x + 0.05 * np.sin(6.0 * np.pi * x) * (0.3 + z)
    for fx, dzo in ((0.3, 0.06), (0.55, -0.08), (0.8, 0.05)):
        horizon = horizon + dzo * (x > fx)
    nlayer = 24
    idx = np.clip(np.floor(horizon * nlayer).astype(int), 0, nlayer + 4)
    rng = np.random.default_rng(42)
    vels = (1500. + 2200. * np.arange(nlayer + 5) / (nlayer + 4)
            + rng.uniform(-220., 220., nlayer + 5))
    vels = np.maximum.accumulate(vels)
    c = vels[idx]
    r2 = (z - 0.45) ** 2 + (x - 0.5) ** 2
    c = c - 300. * np.exp(-r2 / 0.01)
    w = rng.standard_normal((n, n))
    kz = np.fft.fftfreq(n)[:, None]
    kx = np.fft.fftfreq(n)[None, :]
    k = np.sqrt(kz ** 2 + kx ** 2)
    lo, hi = 2.0 / n, 1.0 / 16.0
    filt = np.where((k >= lo) & (k <= hi), 1.0 / np.maximum(k, lo), 0.0)
    rough = np.real(np.fft.ifft2(np.fft.fft2(w) * filt))
    rough = rough / max(rough.std(), 1e-30)
    c = c + 120.0 * rough
    return np.asarray(np.maximum(c, 1400.), dtype)


def scalar_operator(c_np, cfg, freq=1500.0 / 16):
    '''
    The prepared scalar operator (MiniZephyr true and CSLP-shifted planes,
    complex64, on the card) of a host velocity model; (op, prep seconds).
    '''
    import torch
    from zephyr_tpu_torch.ops.minizephyr_coeff import minizephyr_planes
    from zephyr_tpu_torch.solver.helmholtz import (prepare_operator,
                                                   shifted_velocity)
    n_z, n_x = c_np.shape
    c = torch.as_tensor(c_np, device=DEV).to(torch.complex64)
    rho = torch.ones((n_z, n_x), dtype=torch.float32, device=DEV)
    t0 = time.perf_counter()
    planes = minizephyr_planes(c, rho, freq)[None, None]
    pplanes = minizephyr_planes(shifted_velocity(c, cfg.shift), rho, freq,
                                pml_cap=cfg.pml_cap)[None, None]
    op = prepare_operator(planes, pplanes, cfg, with_transpose=False)
    torch.cuda.synchronize()
    return op, time.perf_counter() - t0


def point_sources(n, nsrc):
    '''
    (nsrc, 1, n, n) unit point sources, complex64 on the card, at the
    positions bench.py draws (seed 0).
    '''
    import torch
    pos = np.random.default_rng(0).integers(n // 8, 7 * n // 8,
                                            size=(nsrc, 2))
    b = torch.zeros((nsrc, 1, n, n), dtype=torch.complex64, device=DEV)
    b[torch.arange(nsrc), 0, torch.as_tensor(pos[:, 0]),
      torch.as_tensor(pos[:, 1])] = 1.0
    return b


MEDIA = {'hom': lambda n: np.full((n, n), 1500.0, np.float32),
         'layered': lambda n: layered_c(n),
         'marmousi': lambda n: marmousi_c(n)}


def headline(n, nsrc, medium, card, opts=PRODUCTION):
    '''
    Phase 5 (and 9a): prepare_operator + make_chunked_solver on the card
    at n^2 with nsrc point sources and the given solver options (None: the
    default SolverConfig), the auto x-panel rule applied; a warm-up solve,
    then a timed one, which must reach tol. Returns a dict of the run's
    numbers (with the chunk trace and the launches per iteration) and the
    prepared operator.
    '''
    import torch
    from zephyr_tpu_torch.ops import cuda_kernels as ck
    from zephyr_tpu_torch.ops.special import hankel1_0
    from zephyr_tpu_torch.solver.helmholtz import (
        make_chunked_solver, resolve_solver_config, resolve_panels)
    cval = 1500.0
    freq = cval / 16.0
    c_np = MEDIA[medium](n)
    cname = 'default' if opts is None else 'production'
    cfg = resolve_panels(resolve_solver_config(opts, torch.complex64), c_np)
    reset_peak()
    op, t_prep = scalar_operator(c_np, cfg, freq)
    b = point_sources(n, nsrc)
    solver = make_chunked_solver(cfg, chunk=32)

    _, iters0, relres0 = solver(op, b)      # warm-up
    torch.cuda.synchronize()
    before = dict(ck.LAUNCHES)
    trace = []
    t0 = time.perf_counter()
    x, iters, relres = solver(op, b, trace=trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    per_iter = {k: (ck.LAUNCHES[k] - before[k]) / max(iters, 1)
                for k in ck.LAUNCHES if ck.LAUNCHES[k] > before[k]}
    if not (np.isfinite(relres) and relres <= cfg.tol):
        fail('%s %d^2: relres %.3e > tol %.0e; chunk trace %s'
             % (medium, n, relres, cfg.tol, trace))
    if not bool(torch.isfinite(x).all()):
        fail('%s %d^2: non-finite wavefield' % (medium, n))
    out = {'medium': medium, 'config': cname, 'n': n, 'nsrc': nsrc,
           'panels': cfg.strat_panels, 'iters': iters, 'relres': relres,
           'wall_s': wall, 'solves_per_s': nsrc / wall, 'prep_s': t_prep,
           'warmup_iters': iters0, 'peak_gb': peak_gb(),
           'trace': compact_trace(trace), 'launches_per_iter': per_iter}
    say('headline %s %s %d^2 x %d src (%d panels): iters %d  relres %.3e  '
        'wall %.3f s  %.3f solves/s  (prep %.2f s; peak %.2f GB; card %s)'
        % (medium, cname, n, nsrc, cfg.strat_panels, iters, relres, wall,
           nsrc / wall, t_prep, out['peak_gb'], card))

    if medium == 'hom':
        # interior-window oracle of one source outside the window
        # (bench.py's on-chip accuracy pin)
        p0 = (n // 16, n // 16)
        b0 = torch.zeros((1, 1, n, n), dtype=torch.complex64,
                         device=DEV)
        b0[0, 0, p0[0], p0[1]] = 1.0
        x0, it0, rr0 = solver(op, b0)
        u = torch.conj(x0[0, 0]).to(torch.complex128)
        k = 2 * np.pi * freq / cval
        Z, X = torch.meshgrid(torch.arange(n, device=DEV),
                              torch.arange(n, device=DEV),
                              indexing='ij')
        r = torch.sqrt(((Z - p0[0]) ** 2 + (X - p0[1]) ** 2).double())
        uA = 0.5 * (-0.5j) * hankel1_0(k * r)
        uA = torch.complex(torch.nan_to_num(uA.real),
                           torch.nan_to_num(uA.imag))
        w = slice(n // 8, 7 * n // 8)
        rel = (uA - u)[w, w] / torch.abs(uA[w, w])
        err = float(torch.sqrt(torch.sum(torch.abs(rel) ** 2))
                    / rel.numel())
        out['oracle_error'] = err
        say('headline hom %s %d^2 oracle error %.3e (limit 1e-2; 1 '
            'source, %d iters, relres %.3e)' % (cname, n, err, it0, rr0))
        if not err < 1e-2:
            fail('headline oracle error %.3e >= 1e-2' % err)
    return out, op


# --- phase 7 -------------------------------------------------------------

def peak_gb():
    import torch
    return torch.cuda.max_memory_allocated() / 2 ** 30


def reset_peak():
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def fwi_gradient(n, nsrc, nfreq, card, medium='layered'):
    '''
    Phase 7a (and 9d on the Marmousi model): the bench's gradient row
    (bench.py:590-629) through the port: fwi_misfit_grad_chunked, zero
    observed data, grids by targetGPW 16, the production config with the
    auto x-panel rule (resolved per grid inside), chunk 16.
    '''
    from zephyr_tpu_torch.parallel import fwi_misfit_grad_chunked
    from zephyr_tpu_torch.solver.helmholtz import SolverConfig
    c = MEDIA[medium](n).astype(np.float64)
    rho = np.ones((n, n))
    freqs = np.linspace(0.6, 1.0, nfreq) * (1500.0 / 16)
    rng = np.random.default_rng(2)
    src_pos = rng.integers(n // 8, 7 * n // 8,
                           size=(nsrc, 2)).astype(np.float64)
    nrec = 64
    rx = np.linspace(n // 8, 7 * n // 8, nrec)
    rec_pos = np.stack([rx, np.full(nrec, float(n // 8))], axis=1)
    dobs = np.zeros((nfreq, nsrc, nrec), np.complex64)
    stats = {}
    reset_peak()
    t0 = time.perf_counter()
    misfit, grad = fwi_misfit_grad_chunked(
        c, rho, freqs, None, None, dobs, config=SolverConfig(**PRODUCTION),
        chunk=16, target_gpw=16, src_pos=src_pos, rec_pos=rec_pos,
        cmin=1500.0, device=DEV, stats=stats)
    wall = time.perf_counter() - t0
    gnorm = float(np.linalg.norm(grad))
    out = {'medium': medium, 'n': n, 'nsrc': nsrc, 'nfreq': nfreq,
           'wall_s': wall, 'misfit': float(misfit), 'grad_norm': gnorm,
           'grids': sorted(set(stats['shapes'])),
           'iters_fwd_adj': [(it_f, it_a) for _, _, it_f, it_a
                             in stats['iters']],
           'phase_s': stats['seconds'], 'peak_gb': peak_gb()}
    say('gradient %d^2 %s x %d src x %d freq: wall %.3f s  misfit '
        '%.6e  |grad| %.6e  peak %.2f GB  (card %s)'
        % (n, medium, nsrc, nfreq, wall, misfit, gnorm, out['peak_gb'],
           card))
    say('  grids %s; (forward, adjoint) iterations per frequency %s'
        % (out['grids'], out['iters_fwd_adj']))
    say('  host seconds by phase %s' % json.dumps(out['phase_s']))
    if not (np.isfinite(misfit) and np.isfinite(grad).all() and gnorm > 0):
        fail('gradient: misfit %r, finite %s, |grad| %r'
             % (misfit, np.isfinite(grad).all(), gnorm))
    return out


def solve_backward(n, nsrc, card):
    '''
    Phase 7b: the backward of solve at n^2 hom x nsrc point sources with
    the production config: L = sum |x|^2, dL/dc through the implicit
    adjoint (one transpose solve, the 'mult' transpose preconditioner
    with K7) and the plane construction.
    '''
    import torch
    from zephyr_tpu_torch.ops.minizephyr_coeff import minizephyr_planes
    from zephyr_tpu_torch.solver.helmholtz import (
        SolverConfig, prepare_operator, shifted_velocity, solve_batched)
    cfg = SolverConfig(**PRODUCTION)
    freq = 1500.0 / 16
    c = torch.full((n, n), 1500.0, dtype=torch.float32, device=DEV,
                   requires_grad=True)
    rho = torch.ones((n, n), dtype=torch.float32, device=DEV)
    rng = np.random.default_rng(0)
    pos = rng.integers(n // 8, 7 * n // 8, size=(nsrc, 2))
    b = torch.zeros((nsrc, 1, n, n), dtype=torch.complex64, device=DEV)
    b[torch.arange(nsrc), 0, torch.as_tensor(pos[:, 0]),
      torch.as_tensor(pos[:, 1])] = 1.0
    reset_peak()
    t0 = time.perf_counter()
    cc = c.to(torch.complex64)
    planes = minizephyr_planes(cc, rho, freq)[None, None]
    pplanes = minizephyr_planes(shifted_velocity(cc.detach(), cfg.shift),
                                rho, freq, pml_cap=cfg.pml_cap)[None, None]
    op = prepare_operator(planes, pplanes, cfg)
    x = solve_batched(op, b, cfg)
    loss = torch.sum(torch.abs(x) ** 2)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    t0 = time.perf_counter()
    g, = torch.autograd.grad(loss, c)
    torch.cuda.synchronize()
    t_bwd = time.perf_counter() - t0
    gnorm = float(torch.linalg.norm(g))
    out = {'n': n, 'nsrc': nsrc, 'forward_s': t_fwd, 'backward_s': t_bwd,
           'grad_norm': gnorm, 'peak_gb': peak_gb()}
    say('solve backward %d^2 hom x %d src: forward (prep + solve) %.3f s  '
        'backward %.3f s  |grad| %.6e  peak %.2f GB  (card %s)'
        % (n, nsrc, t_fwd, t_bwd, gnorm, out['peak_gb'], card))
    if not (np.isfinite(gnorm) and gnorm > 0):
        fail('solve backward: |grad| %r' % gnorm)
    return out


def gradient_agreement(n, nsrc, nrec, card, limit=1e-3, medium='layered'):
    '''
    Phase 7c (and 9e on the Marmousi model): at n^2, one frequency, the
    production config with the auto x-panel rule, the misfit gradient
    w.r.t. c by autograd through solve (its backward a transpose solve)
    against fwi_misfit_grad_chunked on the same sources, receivers and
    data.
    '''
    import torch
    from zephyr_tpu_torch.ops.minizephyr_coeff import minizephyr_planes
    from zephyr_tpu_torch.parallel import fwi_misfit_grad_chunked
    from zephyr_tpu_torch.parallel.multifreq import _kaiser_stamps
    from zephyr_tpu_torch.solver.helmholtz import (
        SolverConfig, prepare_operator, shifted_velocity, solve_batched,
        resolve_panels)
    freq = 1500.0 / 16
    c = MEDIA[medium](n).astype(np.float64)
    cfg = resolve_panels(SolverConfig(**PRODUCTION), c)
    rng = np.random.default_rng(4)
    src_pos = rng.uniform(n // 8, 7 * n // 8, size=(nsrc, 2))
    rec_pos = np.stack([np.linspace(n // 8, 7 * n // 8, nrec),
                        np.full(nrec, float(n // 8))], axis=1)
    scols, svals = _kaiser_stamps((n, n), 1.0, 1.0, src_pos, 4)
    rcols, rvals = _kaiser_stamps((n, n), 1.0, 1.0, rec_pos, 4,
                                  receiver=True)
    q = np.zeros((1, nsrc, n * n), np.complex64)
    np.add.at(q[0], (np.arange(nsrc)[:, None], scols), svals)
    R = np.zeros((nrec, n * n), np.complex64)
    np.add.at(R, (np.arange(nrec)[:, None], rcols), rvals)
    dobs = (0.01 * (rng.standard_normal((1, nsrc, nrec))
                    + 1j * rng.standard_normal((1, nsrc, nrec)))
            ).astype(np.complex64)
    q = q.reshape(1, nsrc, n, n)

    reset_peak()
    t0 = time.perf_counter()
    m_ch, g_ch = fwi_misfit_grad_chunked(
        c, np.ones((n, n)), np.array([freq]), q, R, dobs, config=cfg,
        chunk=nsrc, device=DEV)
    t_ch = time.perf_counter() - t0

    t0 = time.perf_counter()
    ct = torch.as_tensor(c, dtype=torch.float32, device=DEV)
    ct.requires_grad_(True)
    rho = torch.ones((n, n), dtype=torch.float32, device=DEV)
    cc = ct.to(torch.complex64)
    planes = minizephyr_planes(cc, rho, freq)[None, None]
    pplanes = minizephyr_planes(shifted_velocity(cc.detach(), cfg.shift),
                                rho, freq, pml_cap=cfg.pml_cap)[None, None]
    op = prepare_operator(planes, pplanes, cfg)
    b = torch.as_tensor(q[0][:, None], device=DEV)
    x = solve_batched(op, b, cfg)
    u = torch.conj(x[:, 0].reshape(nsrc, -1))
    r = u @ torch.as_tensor(R, device=DEV).T - torch.as_tensor(dobs[0],
                                                              device=DEV)
    loss = 0.5 * torch.sum(torch.abs(r) ** 2)
    g_ad, = torch.autograd.grad(loss, ct)
    g_ad = g_ad.cpu().numpy()
    t_ad = time.perf_counter() - t0
    diff = float(np.max(np.abs(g_ad - g_ch)) / np.max(np.abs(g_ch)))
    mis_diff = abs(float(loss.detach()) - m_ch) / m_ch
    out = {'medium': medium, 'panels': cfg.strat_panels, 'n': n,
           'nsrc': nsrc, 'nrec': nrec, 'max_rel_diff': diff,
           'misfit_rel_diff': mis_diff, 'chunked_s': t_ch,
           'autograd_s': t_ad, 'peak_gb': peak_gb()}
    say('gradient agreement %d^2 %s (%d panels), 1 freq, %d src, %d rec: '
        'max|g_solve - g_chunked| / max|g_chunked| %.3e (limit %.0e), '
        'misfit rel diff %.3e; chunked %.2f s, autograd %.2f s; peak %.2f '
        'GB (card %s)' % (n, medium, cfg.strat_panels, nsrc, nrec, diff,
                          limit, mis_diff, t_ch, t_ad, out['peak_gb'],
                          card))
    if not diff <= limit:
        fail('autograd and chunked gradients differ by %.3e > %.0e'
             % (diff, limit))
    return out


# --- phase 8 -------------------------------------------------------------

def eurus_oracle(eps_delta):
    '''
    Phase 8a: Eurus(config) * q on the card against the analytical oracle,
    the reference test configuration of tests/test_eurus.py:19-35, no
    solverOpts (the default SolverConfig; GMRES for the block system).
    '''
    from zephyr_tpu_torch.backend import (Eurus, StackedSimpleSource,
                                          AnalyticalHelmholtz)
    nx, nz = 100, 200
    e, d = eps_delta
    config = {'c': 2000. * np.ones((nz, nx)), 'rho': np.ones((nz, nx)),
              'freq': 2e2, 'nx': nx, 'nz': nz, 'dx': 1., 'dz': 1.,
              'theta': np.zeros((nz, nx)), 'eps': e * np.ones((nz, nx)),
              'delta': d * np.ones((nz, nx)), 'nPML': 10, 'cPML': 1e3,
              'freeSurf': (False, False, False, False), 'device': DEV}
    sloc = np.array([[25, 25]])
    t0 = time.perf_counter()
    u = (Eurus(config) * StackedSimpleSource(config)(sloc)).ravel()
    secs = time.perf_counter() - t0
    if u.shape != (2 * nz * nx,) or not np.isfinite(u).all():
        fail('Eurus oracle: wavefield of shape %s, finite %s'
             % (u.shape, np.isfinite(u).all()))
    uAH = AnalyticalHelmholtz(config)(sloc)
    segA = uAH.reshape((nz, nx))[40:180, 40:80]
    segE = u[:nx * nz].reshape((nz, nx))[40:180, 40:80]
    rel = (segA - segE) / abs(segA)
    err = np.sqrt((rel.conj() * rel).sum()).real / rel.size
    name = 'isotropic' if e == 0 and d == 0 else 'elliptical'
    say('Eurus oracle 200x100 %s (eps %.1f, delta %.1f) on %s, default '
        'config: error %.3e (limit 3e-2), %.2f s' % (name, e, d, DEV, err,
                                                     secs))
    if not err < 3e-2:
        fail('Eurus oracle error %.3e >= 3e-2' % err)
    return {'case': name, 'error': err, 'seconds': secs}


def tti_sources(n, nsrc):
    '''
    The TTI rows' right-hand sides, (nsrc, 2, n, n) complex64 on the card:
    unit point sources on the first component at positions drawn as
    bench.py:464-465 does (seed 1).
    '''
    import torch
    pos = np.random.default_rng(1).integers(n // 8, 7 * n // 8,
                                            size=(nsrc, 2))
    b = torch.zeros((nsrc, 2, n, n), dtype=torch.complex64, device=DEV)
    b[torch.arange(nsrc), 0, torch.as_tensor(pos[:, 0]),
      torch.as_tensor(pos[:, 1])] = 1.0
    return b


def tti_bench(n, nsrc, medium, card, warm=True):
    '''
    Phase 8b/8c: the bench's eurus / eurus_layered row (bench.py:425-484)
    through the port: prepare_operator + make_chunked_solver(chunk=16),
    the production config with gmres_restart=20 and mg_nu1=mg_nu2=1,
    a warm-up solve (``warm``) then a timed one. Returns the run's
    numbers, the chunk residual trace and the K8 launches per GMRES
    iteration of the timed solve.
    '''
    import torch
    from zephyr_tpu_torch.ops import cuda_kernels as ck
    from zephyr_tpu_torch.solver.helmholtz import (
        SolverConfig, prepare_operator, make_chunked_solver)
    cfg = SolverConfig(**TTI_OPTS)
    c_np = None if medium == 'hom' else layered_c(n)
    reset_peak()
    t0 = time.perf_counter()
    planes, pplanes = tti_planes(n, n, c_np, cfg.shift, cfg.pml_cap)
    op = prepare_operator(planes, pplanes, cfg, with_transpose=False)
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    b = tti_sources(n, nsrc)
    solver = make_chunked_solver(cfg, chunk=16)
    iters0 = relres0 = None
    if warm:
        _, iters0, relres0 = solver(op, b)
    torch.cuda.synchronize()
    before = dict(ck.LAUNCHES)
    trace = []
    t0 = time.perf_counter()
    x, iters, relres = solver(op, b, trace=trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    per_iter = {k: (ck.LAUNCHES[k] - before[k]) / max(iters, 1)
                for k in ('apply_block_stencil', 'restrict', 'prolong')}
    out = {'row': 'eurus' if medium == 'hom' else 'eurus_layered',
           'n': n, 'nsrc': nsrc, 'iters': iters, 'relres': relres,
           'reached_1e-5': bool(relres <= 1e-5), 'wall_s': wall,
           'solves_per_s': nsrc / wall, 'prep_s': t_prep,
           'warmup_iters': iters0, 'warmup_relres': relres0,
           'launches_per_iter': per_iter, 'trace': compact_trace(trace),
           'peak_gb': peak_gb()}
    say('TTI %s %d^2 x %d src: iters %d  relres %.3e (1e-5 %s)  wall %.3f s'
        '  %.3f solves/s  (prep %.2f s; peak %.2f GB; card %s)'
        % (out['row'], n, nsrc, iters, relres,
           'reached' if out['reached_1e-5'] else 'NOT reached', wall,
           nsrc / wall, t_prep, out['peak_gb'], card))
    say('  chunk trace [iterations, worst relres, repeats]: %s'
        % json.dumps(out['trace']))
    say('  launches per GMRES iteration: %s' % json.dumps(per_iter))
    if not (np.isfinite(relres) and relres < 1.0):
        fail('TTI %s: relres %r is not finite and below the starting 1.0'
             % (out['row'], relres))
    if not bool(torch.isfinite(x).all()):
        fail('TTI %s: non-finite wavefield' % out['row'])
    return out


def tti_pin(card, n=128):
    '''
    Phase 8d: the line-smoother pin of tests/test_eurus.py:86-123, 128^2
    layered TTI with solve_info.
    '''
    import torch
    from zephyr_tpu_torch.solver.helmholtz import (
        SolverConfig, prepare_operator, solve_info)
    cfg = SolverConfig(**dict(TTI_OPTS, maxiter=280, fft_shift=0.25j))
    planes, pplanes = tti_planes(n, n, layered_c(n), cfg.shift, cfg.pml_cap)
    op = prepare_operator(planes, pplanes, cfg, with_transpose=False)
    b = torch.zeros((1, 2, n, n), dtype=torch.complex64, device=DEV)
    b[0, 0, n // 2, n // 2] = 1.0
    t0 = time.perf_counter()
    x, iters, relres = solve_info(op, b, cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    it, rr = int(iters[0]), float(relres[0])
    say('TTI pin %d^2 layered solve_info: iters %d  relres %.3e (1e-5 %s)'
        '  %.2f s (card %s)' % (n, it, rr, 'reached' if rr <= 1e-5
                                else 'NOT reached', secs, card))
    if not (np.isfinite(rr) and rr < 1.0 and bool(torch.isfinite(x).all())):
        fail('TTI pin: relres %r' % rr)
    return {'n': n, 'iters': it, 'relres': rr, 'reached_1e-5': rr <= 1e-5,
            'seconds': secs}


# --- phase 9 -------------------------------------------------------------

class uncounted:
    '''
    A block whose kernel launches are not counted: the launch counts are
    restored on exit (for the comparisons that hold a path's kernel
    against another computation of the same function).
    '''

    def __enter__(self):
        from zephyr_tpu_torch.ops import cuda_kernels as ck
        self.saved = dict(ck.LAUNCHES)

    def __exit__(self, *exc):
        from zephyr_tpu_torch.ops import cuda_kernels as ck
        ck.LAUNCHES.update(self.saved)


def presmooth_residual_check(op, nsrc, card):
    '''
    Phase 9c: the public multigrid.presmooth_residual on level 0 of a
    prepared operator's hierarchy at nu1 = 2 (K9) for an (nsrc, 1, nz, nx)
    random batch, held against K2's fused downstroke of the same batch:
    the same iterate, and K2's restriction of the K9 residual.
    '''
    import torch
    from zephyr_tpu_torch.solver import multigrid
    from zephyr_tpu_torch.solver.helmholtz import SolverConfig
    omega = SolverConfig(**PRODUCTION).mg_omega
    lvl = op.hier.levels[0]
    n_z, n_x = lvl.planes.shape[-2:]
    gen = torch.Generator(device=DEV)
    gen.manual_seed(9)
    b = torch.complex(torch.randn((nsrc, 1, n_z, n_x), generator=gen,
                                  device=DEV),
                      torch.randn((nsrc, 1, n_z, n_x), generator=gen,
                                  device=DEV))
    u, resm = multigrid.presmooth_residual(lvl, b, omega, 2)
    torch.cuda.synchronize()
    with uncounted():
        u_k2, rc_k2 = multigrid.presmooth_restrict(lvl, b, omega, 2)
        rel, abs_err = rel_err((u, multigrid.restrict(resm)), (u_k2, rc_k2))
    out = {'n': n_z, 'nsrc': nsrc, 'rel_err_vs_k2': rel,
           'abs_err_vs_k2': abs_err}
    say('presmooth_residual (K9) on level 0, %dx%d x %d: against K2 rel '
        'err %.3e (limit %.0e) (card %s)' % (n_z, n_x, nsrc, rel,
                                             KERNEL_TOL, card))
    if not rel <= KERNEL_TOL:
        fail('presmooth_residual disagrees with K2: %.3e' % rel)
    return out


def marmousi_nu33(n, nsrc, card, max_iters):
    '''
    Phase 9b: the bench's marmousi row with mg_nu1 = mg_nu2 = 3 (K6 from
    zero and from u, K5 for the odd sweep, the downstroke through K1 and
    K7 instead of K2), one solve stopped at ``max_iters`` (chunks of 32).
    It stalls in the JAX package too, so it must only end finite and
    below its starting residual; the chunk trace and the launches per
    iteration are printed.
    '''
    import torch
    from zephyr_tpu_torch.ops import cuda_kernels as ck
    from zephyr_tpu_torch.solver.helmholtz import (
        make_chunked_solver, resolve_solver_config, resolve_panels)
    c_np = marmousi_c(n)
    cfg = resolve_panels(resolve_solver_config(
        dict(PRODUCTION, mg_nu1=3, mg_nu2=3), torch.complex64), c_np)
    reset_peak()
    op, t_prep = scalar_operator(c_np, cfg)
    b = point_sources(n, nsrc)
    before = dict(ck.LAUNCHES)
    trace = []
    t0 = time.perf_counter()
    x, iters, relres = make_chunked_solver(cfg, chunk=32)(
        op, b, max_chunks=max(1, -(-max_iters // 32)), trace=trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    per_iter = {k: (ck.LAUNCHES[k] - before[k]) / max(iters, 1)
                for k in ck.LAUNCHES if ck.LAUNCHES[k] > before[k]}
    out = {'medium': 'marmousi', 'config': 'production nu 3/3', 'n': n,
           'nsrc': nsrc, 'panels': cfg.strat_panels, 'iters': iters,
           'relres': relres, 'reached_1e-5': bool(relres <= 1e-5),
           'wall_s': wall, 'ms_per_iter': 1e3 * wall / max(iters, 1),
           'prep_s': t_prep, 'peak_gb': peak_gb(),
           'trace': compact_trace(trace), 'launches_per_iter': per_iter}
    say('marmousi nu 3/3 %d^2 x %d src (%d panels): iters %d  relres %.3e '
        '(1e-5 %s)  wall %.3f s, %.2f ms per iteration  (prep %.2f s; peak '
        '%.2f GB; card %s)' % (n, nsrc, cfg.strat_panels, iters, relres,
                               'reached' if out['reached_1e-5']
                               else 'NOT reached', wall, out['ms_per_iter'],
                               t_prep, out['peak_gb'], card))
    say('  chunk trace [iterations, worst relres, repeats]: %s'
        % json.dumps(out['trace']))
    say('  launches per BiCGStab iteration: %s' % json.dumps(per_iter))
    if not (np.isfinite(relres) and relres < 1.0
            and bool(torch.isfinite(x).all())):
        fail('marmousi nu 3/3: relres %r is not finite and below the '
             'starting 1.0' % relres)
    if 'presmooth_restrict' in per_iter or not per_iter.get('jacobi_sweep2'):
        fail('marmousi nu 3/3 ran K2 or no K6: %s' % per_iter)
    return out


#: the kernels each main path must launch (phase 6)
SCALAR_PATH = ('apply_stencil', 'presmooth_restrict', 'pcr_sweep',
               'prolong_add_smooth', 'jacobi_sweep', 'restrict', 'prolong')
TTI_PATH = ('apply_block_stencil', 'restrict', 'prolong')
MARMOUSI_PATH = ('apply_stencil', 'presmooth_restrict', 'pcr_sweep',
                 'prolong_add_smooth', 'jacobi_sweep', 'jacobi_sweep2',
                 'jacobi_sweep2_zero', 'restrict', 'prolong',
                 'presmooth_residual')


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import zephyr_tpu_torch  # noqa: F401  (fails outside the repo)
    from zephyr_tpu_torch.ops import cuda_kernels as ck

    # phase 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    say('torch %s, CUDA %s, python %s' % (torch.__version__,
                                           torch.version.cuda,
                                           sys.version.split()[0]))
    say('card: %s; devices %d' % (card, torch.cuda.device_count()))
    say('tf32: matmul %s, cudnn %s'
        % (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32))

    # phase 2
    t0 = time.perf_counter()
    so = ck.build()
    ck._load()
    say('kernels built in %.1f s: %s' % (time.perf_counter() - t0,
                                         os.path.relpath(so, HERE)))
    if ck.build_info is not None:
        for line in ck.build_info[1].splitlines():
            if 'Used' in line or 'spill' in line or 'Compiling' in line:
                say('  ptxas: ' + line.split('ptxas info    : ')[-1])

    # phase 3
    say('phase 3: kernels against their torch twins (complex64, card)')
    kres = check_kernels()

    # phases 4-7 (the scalar paths) and phase 8 (TTI), each with the
    # launch counts set to 0 just before it and read just after
    launches = {}
    ck.reset_launches()
    oracle_flow()
    oracle_flow(None)
    runs = [headline(2048, 16, 'hom', card)[0],
            headline(2048, 16, 'layered', card)[0],
            headline(2048, 16, 'hom', card, opts=None)[0]]
    grads = {'fwi': fwi_gradient(2048, 16, 8, card),
             'solve_backward': solve_backward(2048, 16, card),
             'agreement': gradient_agreement(512, 8, 32, card)}
    torch.cuda.synchronize()
    launches['scalar'] = dict(ck.LAUNCHES)
    ck.reset_launches()
    # the layered row stalls on the card (fault F4: 2000 iterations,
    # 80 s a solve), so it runs once, after the hom row has warmed
    # every code path
    tti = {'oracle': [eurus_oracle((0., 0.)), eurus_oracle((0.2, 0.2))],
           'eurus': tti_bench(512, 16, 'hom', card),
           'eurus_layered': tti_bench(256, 16, 'layered', card, warm=False),
           'pin': tti_pin(card)}
    torch.cuda.synchronize()
    launches['tti'] = dict(ck.LAUNCHES)
    ck.reset_launches()
    row_a, op_a = headline(2048, 16, 'marmousi', card)
    if row_a['panels'] != 8:
        fail('marmousi 2048^2: the auto rule gave %d panels, not 8'
             % row_a['panels'])
    marm = {'marmousi': row_a,
            'presmooth_residual': presmooth_residual_check(op_a, 16, card)}
    del op_a
    marm['marmousi_nu33'] = marmousi_nu33(2048, 16, card, row_a['iters'])
    marm['gradient_marmousi'] = fwi_gradient(512, 16, 8, card,
                                             medium='marmousi')
    marm['agreement'] = gradient_agreement(512, 8, 32, card,
                                           medium='marmousi')
    torch.cuda.synchronize()
    launches['marmousi'] = dict(ck.LAUNCHES)

    # phase 6
    for path, names in (('scalar', SCALAR_PATH), ('tti', TTI_PATH),
                        ('marmousi', MARMOUSI_PATH)):
        say('launches over the %s path: %s'
            % (path, json.dumps(launches[path])))
        for name in names:
            if launches[path][name] == 0:
                fail('kernel %s was never launched on the %s path'
                     % (name, path))
    for key in sorted(k for k in kres if k not in KERNELS):
        say('%s: %s' % (key, json.dumps(kres[key])))
    say(json.dumps({'runs': runs, 'card': card}))
    say(json.dumps({'gradients': grads, 'card': card}))
    say(json.dumps({'tti': tti, 'card': card}))
    say(json.dumps({'marmousi': marm, 'card': card}))

    kernels = []
    for name, (tag, src, repl) in KERNELS.items():
        r = kres[name]
        kernels.append({'name': '%s %s' % (tag, name), 'route': 'cuda',
                        'source': src, 'replaces': repl,
                        'launches': sum(launches[p].get(name, 0)
                                        for p in launches),
                        'max_abs_err': r['max_abs_err'], 'ms': r['ms'],
                        'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
                        'bound_by': r['bound_by'],
                        'library_ms': r['library_ms']})
    say(json.dumps({'kernels': kernels}))
    say(card_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
