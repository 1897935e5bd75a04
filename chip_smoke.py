#!/usr/bin/env python3
'''
Drive the PyTorch/CUDA port (zephyr_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each fails loudly: a non-zero exit and no final ok line):

1. versions, the card's name and power limit, the TF32 switches (both
   set off and printed);
2. build the CUDA kernels K1-K5 and K7 from zephyr_tpu_torch/csrc with
   nvcc (one nvcc per source, all started together);
3. hold each kernel against its plain torch twin on the card, complex64,
   at the main path's shapes and at odd ones (fail above 1e-5 relative to
   the twin's largest magnitude), and time both; K3 also at nz=2048 (the
   default config's full-resolution family, 11 levels);
4. the forward-modelling oracle: ``MiniZephyr(config) * q`` on the card
   with the production solver options (4) and with no solverOpts, the
   default SolverConfig (4b), against AnalyticalHelmholtz
   (interior-window error must stay below 1e-2);
5. the headline: 2048^2, 16 point sources, 16 cells per wavelength,
   ``prepare_operator`` + ``make_chunked_solver(cfg, chunk=32)`` on the
   homogeneous and the 4-layer model with the production config, and on
   the homogeneous model with the default config (5b) (relres <= 1e-5),
   plus the homogeneous oracle errors;
6. (after 7) the launch counts of every kernel over phases 4-7 (each must
   be > 0);
7. gradients: (a) ``fwi_misfit_grad_chunked`` at the bench's gradient
   size (2048^2 layered, 16 sources, 8 frequencies, 64 receivers, grids
   by targetGPW 16), finite and non-zero; (b) the backward of ``solve``
   at 2048^2 x 16 with the production config, timed; (c) at 512^2
   layered, one frequency, the gradient w.r.t. c by autograd through
   ``solve`` against ``fwi_misfit_grad_chunked`` (max-norm relative
   difference <= 1e-3).

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
    'restrict': ('K7', 'zephyr_tpu_torch/csrc/k7_transfer.cu',
                 'zephyr_tpu/ops/pallas_transfer.py:77'),
    'prolong': ('K7', 'zephyr_tpu_torch/csrc/k7_transfer.cu',
                'zephyr_tpu/ops/pallas_transfer.py:77'),
}
KERNEL_TOL = 1e-5
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
               key=None):
        rel, abs_err = rel_err(out, ref)
        say('  %-19s %-26s rel err %.3e  abs err %.3e'
            % (name, shape_desc, rel, abs_err))
        if not rel <= KERNEL_TOL:
            fail('%s disagrees with its twin at %s: %.3e > %.0e'
                 % (name, shape_desc, rel, KERNEL_TOL))
        if main:
            key = key or name
            results[key] = {'max_abs_err': abs_err}
            kern, plain = timing
            results[key]['ms'] = cuda_ms(kern)
            results[key]['plain_ms'] = cuda_ms(plain)
            say('  %-19s %-26s kernel %.3f ms  plain %.3f ms'
                % (name, shape_desc, results[key]['ms'],
                   results[key]['plain_ms']))

    # K1, K2 (1 and 2 sweeps), K4: main-path shapes and an odd one
    for (nz, nx, R, main) in ((2048, 2048, 16, True),
                              (1024, 1024, 16, False),
                              (37, 53, 3, False), (25, 50, 1, False)):
        desc = '%dx%d R=%d' % (nz, nx, R)
        planes, D, mask, field = level_inputs(nz, nx, R, gen)
        u = field(R, nz, nx)
        b = field(R, nz, nx)
        ec = field(R, (nz + 1) // 2, (nx + 1) // 2)

        record('apply_stencil', desc, ck.apply_stencil(planes, u),
               stencil.apply_stencil(planes, u), main,
               (lambda: ck.apply_stencil(planes, u),
                lambda: stencil.apply_stencil(planes, u)))
        for ns, ref in ((2, stencil._ps2rr_ref), (1, stencil._ps1rr_ref)):
            record('presmooth_restrict',
                   desc + ' nsweeps=%d' % ns,
                   ck.presmooth_restrict(planes, D, mask, b, ns),
                   ref(planes, D, mask, b), main and ns == 2,
                   (lambda: ck.presmooth_restrict(planes, D, mask, b, 2),
                    lambda: stencil._ps2rr_ref(planes, D, mask, b)))
        record('prolong_add_smooth', desc,
               ck.prolong_add_smooth(planes, D, mask, b, u, ec),
               stencil._pas_ref(planes, D, mask, b, u, ec), main,
               (lambda: ck.prolong_add_smooth(planes, D, mask, b, u, ec),
                lambda: stencil._pas_ref(planes, D, mask, b, u, ec)))
        record('jacobi_sweep', desc, ck.jacobi_sweep(planes, D, b, u),
               stencil._jacobi_ref(planes, D, b, u), main,
               (lambda: ck.jacobi_sweep(planes, D, b, u),
                lambda: stencil._jacobi_ref(planes, D, b, u)))
        cdesc = '%s -> %dx%d' % (desc, (nz + 1) // 2, (nx + 1) // 2)
        record('restrict', cdesc, ck.restrict(b),
               multigrid._restrict_ref(b), main,
               (lambda: ck.restrict(b),
                lambda: multigrid._restrict_ref(b)))
        pdesc = '%dx%d -> %s' % ((nz + 1) // 2, (nx + 1) // 2, desc)
        record('prolong', pdesc, ck.prolong(ec, nz, nx),
               multigrid._prolong_ref(ec, nz, nx), main,
               (lambda: ck.prolong(ec, nz, nx),
                lambda: multigrid._prolong_ref(ec, nz, nx)))
        del planes, D, mask, u, b, ec
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
                   key='pcr_sweep nz=%d' % nz if full else None)
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


def headline(n, nsrc, medium, card, opts=PRODUCTION):
    '''
    Phase 5: prepare_operator + make_chunked_solver on the card at n^2
    with nsrc point sources and the given solver options (None: the
    default SolverConfig); returns a dict of the run's numbers.
    '''
    import torch
    from zephyr_tpu_torch.ops.minizephyr_coeff import minizephyr_planes
    from zephyr_tpu_torch.ops.special import hankel1_0
    from zephyr_tpu_torch.solver.helmholtz import (
        prepare_operator, make_chunked_solver, resolve_solver_config,
        shifted_velocity, resolve_panels)
    cval = 1500.0
    freq = cval / 16.0
    c_np = (np.full((n, n), cval, np.float32) if medium == 'hom'
            else layered_c(n))
    cname = 'default' if opts is None else 'production'
    cfg = resolve_panels(resolve_solver_config(opts, torch.complex64), c_np)
    c = torch.as_tensor(c_np, device=DEV).to(torch.complex64)
    rho = torch.ones((n, n), dtype=torch.float32, device=DEV)
    reset_peak()
    t0 = time.perf_counter()
    planes = minizephyr_planes(c, rho, freq)[None, None]
    pplanes = minizephyr_planes(shifted_velocity(c, cfg.shift), rho, freq,
                                pml_cap=cfg.pml_cap)[None, None]
    op = prepare_operator(planes, pplanes, cfg, with_transpose=False)
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0

    rng = np.random.default_rng(0)
    pos = rng.integers(n // 8, 7 * n // 8, size=(nsrc, 2))
    b = torch.zeros((nsrc, 1, n, n), dtype=torch.complex64, device=DEV)
    b[torch.arange(nsrc), 0, torch.as_tensor(pos[:, 0]),
      torch.as_tensor(pos[:, 1])] = 1.0
    solver = make_chunked_solver(cfg, chunk=32)

    _, iters0, relres0 = solver(op, b)      # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, iters, relres = solver(op, b)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not (np.isfinite(relres) and relres <= cfg.tol):
        fail('%s %d^2: relres %.3e > tol %.0e' % (medium, n, relres,
                                                  cfg.tol))
    if not bool(torch.isfinite(x).all()):
        fail('%s %d^2: non-finite wavefield' % (medium, n))
    out = {'medium': medium, 'config': cname, 'n': n, 'nsrc': nsrc,
           'iters': iters, 'relres': relres, 'wall_s': wall,
           'solves_per_s': nsrc / wall, 'prep_s': t_prep,
           'warmup_iters': iters0, 'peak_gb': peak_gb()}
    say('headline %s %s %d^2 x %d src: iters %d  relres %.3e  wall %.3f s'
        '  %.3f solves/s  (prep %.2f s; peak %.2f GB; card %s)'
        % (medium, cname, n, nsrc, iters, relres, wall, nsrc / wall,
           t_prep, out['peak_gb'], card))

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
    return out


# --- phase 7 -------------------------------------------------------------

def peak_gb():
    import torch
    return torch.cuda.max_memory_allocated() / 2 ** 30


def reset_peak():
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def fwi_gradient(n, nsrc, nfreq, card):
    '''
    Phase 7a: the bench's gradient row (bench.py:590-629) through the
    port: fwi_misfit_grad_chunked on the layered model, zero observed
    data, grids by targetGPW 16, the production config, chunk 16.
    '''
    from zephyr_tpu_torch.parallel import fwi_misfit_grad_chunked
    from zephyr_tpu_torch.solver.helmholtz import SolverConfig
    c = layered_c(n).astype(np.float64)
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
    out = {'n': n, 'nsrc': nsrc, 'nfreq': nfreq, 'wall_s': wall,
           'misfit': float(misfit), 'grad_norm': gnorm,
           'grids': sorted(set(stats['shapes'])),
           'iters_fwd_adj': [(it_f, it_a) for _, _, it_f, it_a
                             in stats['iters']],
           'phase_s': stats['seconds'], 'peak_gb': peak_gb()}
    say('gradient %d^2 layered x %d src x %d freq: wall %.3f s  misfit '
        '%.6e  |grad| %.6e  peak %.2f GB  (card %s)'
        % (n, nsrc, nfreq, wall, misfit, gnorm, out['peak_gb'], card))
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


def gradient_agreement(n, nsrc, nrec, card, limit=1e-3):
    '''
    Phase 7c: at n^2 layered, one frequency, the production config, the
    misfit gradient w.r.t. c by autograd through solve against
    fwi_misfit_grad_chunked on the same sources, receivers and data.
    '''
    import torch
    from zephyr_tpu_torch.ops.minizephyr_coeff import minizephyr_planes
    from zephyr_tpu_torch.parallel import fwi_misfit_grad_chunked
    from zephyr_tpu_torch.parallel.multifreq import _kaiser_stamps
    from zephyr_tpu_torch.solver.helmholtz import (
        SolverConfig, prepare_operator, shifted_velocity, solve_batched)
    cfg = SolverConfig(**PRODUCTION)
    freq = 1500.0 / 16
    c = layered_c(n).astype(np.float64)
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
    out = {'n': n, 'nsrc': nsrc, 'nrec': nrec, 'max_rel_diff': diff,
           'misfit_rel_diff': mis_diff, 'chunked_s': t_ch,
           'autograd_s': t_ad, 'peak_gb': peak_gb()}
    say('gradient agreement %d^2 layered, 1 freq, %d src, %d rec: '
        'max|g_solve - g_chunked| / max|g_chunked| %.3e (limit %.0e), '
        'misfit rel diff %.3e; chunked %.2f s, autograd %.2f s; peak %.2f '
        'GB (card %s)' % (n, nsrc, nrec, diff, limit, mis_diff, t_ch, t_ad,
                          out['peak_gb'], card))
    if not diff <= limit:
        fail('autograd and chunked gradients differ by %.3e > %.0e'
             % (diff, limit))
    return out


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

    # phases 4-7 on the main paths, with the launch counts reset
    ck.reset_launches()
    oracle_flow()
    oracle_flow(None)
    runs = [headline(2048, 16, 'hom', card),
            headline(2048, 16, 'layered', card),
            headline(2048, 16, 'hom', card, opts=None)]
    grads = {'fwi': fwi_gradient(2048, 16, 8, card),
             'solve_backward': solve_backward(2048, 16, card),
             'agreement': gradient_agreement(512, 8, 32, card)}
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)

    # phase 6
    say('launches over phases 4-7: %s' % json.dumps(launches))
    for name, count in launches.items():
        if count == 0:
            fail('kernel %s was never launched on the main path' % name)
    for key in sorted(k for k in kres if k not in KERNELS):
        say('%s: %s' % (key, json.dumps(kres[key])))

    kernels = []
    for name, (tag, src, repl) in KERNELS.items():
        r = kres[name]
        kernels.append({'name': '%s %s' % (tag, name), 'route': 'cuda',
                        'source': src, 'replaces': repl,
                        'launches': launches[name],
                        'max_abs_err': r['max_abs_err'], 'ms': r['ms'],
                        'plain_ms': r['plain_ms']})
    say(json.dumps({'runs': runs, 'card': card}))
    say(json.dumps({'gradients': grads, 'card': card}))
    say(json.dumps({'kernels': kernels}))
    say(card_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
