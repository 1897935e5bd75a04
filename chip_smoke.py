#!/usr/bin/env python3
'''
Drive the PyTorch/CUDA port (zephyr_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each fails loudly: a non-zero exit and no final ok line):

1. versions, the card's name and power limit, the TF32 switches (both
   set off and printed);
2. build the CUDA kernels K1-K9 from zephyr_tpu_torch/csrc with nvcc
   (one nvcc per source, all started together), printing ptxas's
   register and spill counts (K9's on a line of its own);
3. hold each kernel against its plain torch twin on the card, complex64,
   at the main path's shapes and at odd ones (fail above 1e-5 relative to
   the twin's largest magnitude), and time both, beside the least time
   the card could take (its byte or operation bound) and, where one
   PyTorch call computes the same function (K7: a strided convolution),
   that call's time; K3 also at the 8-panel width of the Marmousi row
   (nz=1024 x 1536 columns) and at nz=2048 (the default config's
   full-resolution family, 11 levels); K2 at every level size of the
   2048^2 hierarchy (2048^2 to 64^2) at R=16 and R=1, and the K2 + K3
   milliseconds of one production iteration (2 x (K2 at 6 levels + K3));
   K1 also at R=1 and odd shapes (the unbatched apply K10); K6 (from u
   and from zero) and K9 beside K1/K2/K4, and both again at every level
   size of the 2048^2 hierarchy at R=16 and R=1; K8 at 2048^2 x 16, at
   512^2 x 16 (the `eurus` row's fine level) and the other level sizes
   of its hierarchy (256^2 to 32^2) x 16, at R=1 at 2048^2 and 512^2,
   and at 37x53 x 3; K2 (1 and 2 sweeps), K4 and K9 again at 2048^2 x 16
   and 37x53 x 3 under the closure mask of an overlapped-Schwarz slab
   (columns 0..16 and nx-17..nx-1 zeroed on top of the ring);
4. the forward-modelling oracle: ``MiniZephyr(config) * q`` on the card
   with the production solver options (4) and with no solverOpts, the
   default SolverConfig (4b), against AnalyticalHelmholtz
   (interior-window error must stay below 1e-2);
5. the headline: 2048^2, 16 point sources, 16 cells per wavelength,
   ``prepare_operator`` + ``make_chunked_solver(cfg, chunk=32)`` on the
   homogeneous and the 4-layer model with the production config, and on
   the homogeneous model with the default config (5b) (relres <= 1e-5),
   plus the homogeneous oracle errors;
6. (after 7-13) the launch counts of every kernel: over phases 4-7
   (K1-K5, K7 must be > 0), over phase 8 (K7, K8), over phase 9 (K1-K4,
   K6 both variants, K7, K9), over phase 10 (K1-K4, K7), over phase 11
   (K1-K4, K7), over phase 12 (K7, K8), over 13a-c (K1, K2, K4, K7),
   over 13d (K8), over 13e (K1-K5) and over phase 14's spatial path
   (14a-c and 14d's traced solve: K1-K4), each path driven with the
   counts set to 0 just before it;
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
   (chunk 16), warm-up then timed, with its milliseconds per GMRES
   iteration and the K8 calls whose operands had to be copied to be
   contiguous; (c) ``eurus_layered`` at 256^2 on the
   4-layer model, timed without a warm-up of its own and stopped after
   20 chunks (it stalls at 3.78e-2 from the sixth: fault F4); (d) the
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
   its start is checked), with its milliseconds per iteration; (c) the
   public ``multigrid.presmooth_residual``
   on level 0 of (a)'s hierarchy at R=16 (K9), held against K2's
   restriction of the same downstroke; (d) the bench's
   ``gradient_marmousi`` row at 512^2 (finite, non-zero); (e) phase 7c's
   autograd-vs-chunked agreement on the 512^2 Marmousi model (2 panels,
   the transposed panel family in the backward);
10. the 2D inverse-problem layer (zephyr_tpu_torch.middleware) on the
   bench's Marmousi model, the production config, phase 7a's 16 sources
   and 64 receivers: (a) at 2048^2 (8 x-panels), one frequency 1500/16,
   Helm2DProblem + Helm2DSurvey: survey.dpred() through the MultiFreq
   distributor, the differentiable forward map at the same model (within
   1e-3 of it), Jvec (forward mode: a tangent solve) and Jtvec (reverse
   mode: an adjoint solve) and their adjoint dot test (within 1e-3),
   each call's wall, peak GB, and each of its Krylov runs' iterations
   and seconds printed; (b) at 512^2,
   two frequencies, misfit_and_gradient at a smoothed start model against
   data made at the true model, finite, non-zero and within 1e-3 of
   Jtvec(dpred(m0) - dobs); (c) at 512^2 the dot test (within 1e-3) of
   Helm2DViscoProblem (Q 50, freqBase) and of
   Helm2DViscoMultiGridProblem on a Helm2DMultiGridSurvey (MiniZephyrHD,
   two frequencies on two grids).
11. multi-frequency block modelling, multiscale inversion and 2.5D, the
   production config: (a) the bench's ``freqblock`` row (staged config
   3, bench.py:487-582): 768^2 layered, 16 frequencies on their targetGPW
   grids (512^2 and 768^2), 48 point sources (the bench's 96, halved to
   fit phase 12 in the time limit) in batches of 16 through
   make_chunked_solver(chunk=32) (the bench's 16-iteration restarts stop
   near 5e-4 on frequency 0 in both packages: printed for the first
   batch), relres <= 1e-5 on every batch, warm-up then timed, solves/s
   and the iterations per frequency; (b)
   ``multifreq_dpred`` and the autograd gradient of ``fwi_misfit`` at
   512^2 layered (4 frequencies, 16 sources, 64 receivers) against
   ``fwi_misfit_grad_chunked`` (max-norm relative <= 1e-3); (c) the
   bench's ``multiscale`` row (staged config 5, bench.py:704-770): 256^2,
   data by ``multifreq_dpred_chunked``, 2 blocks x 3 steps of
   ``fwi_misfit_grad_chunked``, then FrequencyContinuation over
   Helm2DProblem (2 blocks x 2 ProjectedGradient iterations); both must
   lower the misfit; (d) 2.5D: the reference's oracle
   (MiniZephyr25D * q, 200x100, nky 20, error < 1e-2), then
   Helm25DProblem on the 512^2 Marmousi model with nky 20, 16 sources and
   64 receivers: dpred through the distributor chain, the forward map
   (its iterations per ky, its peak beside that at nky 2), Jvec,
   Jtvec, the dot test (<= 1e-3) and ``multifreq_dpred_25d`` (within
   1e-3 of dpred). Each prints its wall, iterations, worst relres and
   peak GB.
12. TTI gradients (the backward of the 2x2 block solve) on the bench's
   ``eurus`` row (512^2 hom, theta 0.3, eps 0.2, delta 0.1, TTI_OPTS,
   complex64): (a) the backward of ``solve_batched`` (prepared
   with_transpose=True, 16 sources as 8b draws them) for a misfit at 64
   receivers on phase 7a's line: the forward and the backward timed
   apart, the forward and the adjoint GMRES runs' iterations and ms an
   iteration, the peak GB, a finite non-zero gradient; (b) the Eurus
   Helm2DProblem + Helm2DSurvey on the same model (one frequency, phase
   7a's 16 sources and 64 receivers): dpred, Jvec, Jtvec and their dot
   test (within 1e-3), each call's wall, peak GB and Krylov iterations;
   (c) its misfit_and_gradient at 256^2 at a smoothed start model
   against data at a perturbed one, finite, non-zero and within 1e-3 of
   Jtvec(dpred(m0) - dobs). No K8 call of the phase may copy its
   operands.
13. the solver configurations beside the production one, and the CLI:
   (a) phase 5's 2048^2 hom x 16 row (warm-up then timed, relres <= 1e-5,
   the oracle error < 1e-2) with fft_mode='2d' (the fused cycle with the
   2D-FFT symbol solve at level 1) and with hybrid_comp='add'
   (stratified); (b) the same with mg_coarse='iterative' (its ms an
   iteration beside phase 5's: the coarse loop makes no host sync); (c)
   the production row as one overlapped-Schwarz slab holds it: the
   planes grown by 16 mirrored columns a side, prepared with the slab's
   closure mask as interior_mask (relres <= 1e-5); (d) the `eurus` row
   (512^2 x 16, TTI_OPTS) with fft_mode='2d', chunked and stopped after
   8 chunks (finite, below its start), then the backward of solve_batched at 256^2 (GMRES capped at
   200; a finite, non-zero gradient); (e) the CLI (``cli.main``): an
   OMEGA project written under build/ (the 4-layer model at 2048^2, 2
   frequencies at 16 and 8 cells per wavelength, 16 sources, 64
   receivers) through ``model`` (its .utout file must read back as the
   returned data), ``inspect``, and ``migrate`` and ``invert --maxiter
   1`` on a 256^2 project (finite outputs). Each run prints its
   iterations, worst relres, wall, solves/s and peak GB.
14. the scale-out layer (zephyr_tpu_torch.parallel.mesh / spatial,
   ``make_sharded_fwi_step``, utils, entry) on virtual meshes of the
   card, complex64, production config: (a) ``make_sharded_apply`` (K1
   on each halo-grown shard) on 2x2 tiles and 4 x slabs against the
   global K1 and the plain sharded sum at 2048^2 x 16 (1e-6), then
   ``make_dd_solver`` on phase 5's 2048^2 layered
   row on a 2x2 ('z', 'x') mesh, 1024^2 shards, at overlap 16 (grown to
   1056^2) and 32 (one wavelength in the 3000 m/s layer), warm-up then
   timed, the shards' operators alone timed beside: relres (the true
   residual, globally too) <= 1e-5, within 1e-4 of the global chunked
   solve, at overlap 32 iterations <= 2x phase 5's layered count (at 16
   printed: there it exceeds 2x), its ms an iteration,
   walls and peak GB; no K1 call may copy its operands;
   (b) ``make_dd_dpred`` at 2048^2 layered, the top 2 of phase 7a's
   frequencies (88.4, 93.75 Hz) x 16 sources x 64 receivers on the same
   mesh, within 1e-4 of ``multifreq_dpred_chunked``, every relres of
   both <= 1e-5 (at 56.25 Hz neither converges on this grid: F7, F10);
   (c)
   ``make_sharded_fwi_step`` at the ``gradient_marmousi`` size (512^2,
   8 frequencies, 16 sources, 64 receivers) on a (freq=4, src=2) mesh,
   one step, against ``fwi_misfit`` + ``torch.autograd.grad`` on one
   device (misfit 1e-4, gradient 1e-3); (d) the first 4 iterations of
   (a)'s solve under ``utils.trace()`` and ``annotate('dd_solve')`` (the
   Chrome trace must name the annotation and K1-K4, ``stats()`` the
   ``timeIt``-wrapped call), ``InversionCheckpointer`` on (c)'s state
   (bit for bit), ``entry()`` and ``dryrun_multichip(4)``.

After phase 6 it prints the K6 milliseconds of one nu 3/3 iteration (9b)
and the K8 milliseconds of one `eurus` GMRES iteration (8b): the launches
per iteration at each level size, counted in those runs, times that
level's phase-3 time. It prints one JSON line of per-kernel results, the
nvidia-smi line, and as its last line {"ok": true, "device": {...}}. It
needs one CUDA device and exits non-zero without one.
``tools/time_port_configs.py`` runs phase 3's slab-mask checks and
phase 13 alone, ``tools/time_port_spatial.py`` phase 14.
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


def ptxas_of(log, kernel):
    '''
    {entry: (registers, spill store bytes, spill load bytes)} that ptxas
    reported (``-Xptxas -v`` in the build log) for each compiled entry
    whose mangled name holds ``kernel``.
    '''
    import re
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1) if kernel in m.group(1) else None
            continue
        if entry is None:
            continue
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                      line)
        if m:
            out[entry] = (None, int(m.group(1)), int(m.group(2)))
        m = re.search(r'Used (\d+) registers', line)
        if m and entry in out:
            out[entry] = (int(m.group(1)),) + out[entry][1:]
    return out


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


class level_launches:
    '''
    Count the calls of K6 (each variant) and K8 inside the block by level:
    {kernel name: {'<n>^2 R=<R>': calls}}. The wrappers are replaced for
    the block's duration by functions that count and call through, so the
    kernels' own launch counts are unchanged.
    '''

    def __enter__(self):
        from zephyr_tpu_torch.ops import cuda_kernels as ck
        self.counts = {}
        self.saved = j2, k8 = ck.jacobi_sweep2, ck.apply_block_stencil

        def tally(name, t):
            nz, nx = t.shape[-2:]
            key = ('%d^2' % nz if nz == nx else '%dx%d' % (nz, nx)) \
                + ' R=%d' % t.shape[0]
            c = self.counts.setdefault(name, {})
            c[key] = c.get(key, 0) + 1

        def jacobi_sweep2(planes, dinv_eff, b, u=None):
            tally('jacobi_sweep2' if u is not None else 'jacobi_sweep2_zero',
                  b)
            return j2(planes, dinv_eff, b, u)

        def apply_block_stencil(planes, u):
            tally('apply_block_stencil', u)
            return k8(planes, u)
        ck.jacobi_sweep2 = jacobi_sweep2
        ck.apply_block_stencil = apply_block_stencil
        return self

    def __exit__(self, *exc):
        from zephyr_tpu_torch.ops import cuda_kernels as ck
        ck.jacobi_sweep2, ck.apply_block_stencil = self.saved

    def per_iter(self, iters):
        return {name: {lv: n / max(iters, 1) for lv, n in c.items()}
                for name, c in self.counts.items()}


def per_iteration_ms(by_level, kres):
    '''
    {kernel name: ms}: the kernel's launches per iteration at each level
    (``level_launches.per_iter``) times that level's phase-3 time, and
    the levels phase 3 did not time.
    '''
    out, untimed = {}, []
    for name, levels in by_level.items():
        out[name] = 0.0
        for lv, n in levels.items():
            key = name if lv == '2048^2 R=16' else '%s %s' % (name, lv)
            if key in kres:
                out[name] += n * kres[key]['ms']
            else:
                untimed.append('%s %s' % (name, lv))
    return out, untimed


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

    # K8: the 2x2 block apply on the shifted Eurus TTI planes, at 2048^2
    # x 16 (the main row), at every level size of the `eurus` row's 512^2
    # hierarchy x 16 and at R=1
    for (n, R) in ((2048, 16), (2048, 1), (512, 16), (512, 1), (256, 16),
                   (128, 16), (64, 16), (32, 16), (37, 3)):
        nz, nx = (n, n) if n != 37 else (37, 53)
        desc = '%dx%d R=%d' % (nz, nx, R)
        planes = tti_planes(nz, nx)[1]
        u = torch.complex(torch.randn((R, 2, nz, nx), generator=gen,
                                      device=DEV),
                          torch.randn((R, 2, nz, nx), generator=gen,
                                      device=DEV))
        record('apply_block_stencil', desc,
               ck.apply_block_stencil(planes, u),
               stencil.apply_block_stencil(planes, u), n != 37,
               (lambda: ck.apply_block_stencil(planes, u),
                lambda: stencil.apply_block_stencil(planes, u)),
               key=(None if (n, R) == (2048, 16)
                    else 'apply_block_stencil %d^2 R=%d' % (n, R)),
               shape=(nz, nx, R))
        del planes, u
        torch.cuda.empty_cache()

    # K3: half grids of the 2048^2 (nz=1024, 10 levels) and 1024^2
    # (nz=512, 9 levels) fused cycles, the 8-panel width of the Marmousi
    # row (nz=1024 x 1536 columns: the 2048^2 half grid's factors tiled in
    # x) and the full-resolution family of the default config at 2048^2
    # (nz=2048, 11 levels); R=1 and R=16
    from zephyr_tpu_torch.solver.stratified import pack_pcr_factors
    for n, main_R, key in ((2048, 16, None), (1024, None, None),
                           (2048, 16, 'pcr_sweep width=1536'),
                           (2048, 16, 'pcr_sweep nz=2048')):
        pcr = strat_factors(n, key == 'pcr_sweep nz=2048')
        planes3 = (pcr.alphas, pcr.gammas, pcr.dinv)
        packed = pcr.packed
        if key == 'pcr_sweep width=1536':
            planes3 = tuple(torch.cat([t, t[..., :512]], dim=-1).contiguous()
                            for t in planes3)
            packed = pack_pcr_factors(*planes3)
        del pcr
        nsteps, _, nz, nx = planes3[0].shape
        for R in (1, 16):
            b = torch.complex(torch.randn((R, nz, nx), generator=gen,
                                          device=DEV),
                              torch.randn((R, nz, nx), generator=gen,
                                          device=DEV))
            args = planes3 + (b,)
            record('pcr_sweep', 'nz=%d x %d levels=%d R=%d'
                   % (nz, nx, nsteps, R),
                   ck.pcr_sweep(packed, b),
                   stratified._pcr_sweep_bf16_ref(*args),
                   R == main_R,
                   (lambda: ck.pcr_sweep(packed, b),
                    lambda: stratified._pcr_sweep_bf16_ref(*args)),
                   key=key, shape=(nz, nx, R, nsteps))
            del b, args
        del planes3, packed
        torch.cuda.empty_cache()

    # K2, K6 (both variants) and K9 at every level size of the 2048^2
    # hierarchy (the smoothed levels), R=16 and R=1 (2048^2 x 16 is the
    # main row)
    for n in (2048, 1024, 512, 256, 128, 64):
        planes, D, mask, field = level_inputs(n, n, 16, gen)
        for R in (16, 1):
            if (n, R) == (2048, 16):
                continue
            b, u = field(R, n, n), field(R, n, n)
            desc = '%dx%d R=%d' % (n, n, R)
            record('presmooth_restrict', desc + ' nsweeps=2',
                   ck.presmooth_restrict(planes, D, mask, b, 2),
                   stencil._ps2rr_ref(planes, D, mask, b), True,
                   (lambda: ck.presmooth_restrict(planes, D, mask, b, 2),
                    lambda: stencil._ps2rr_ref(planes, D, mask, b)),
                   key='presmooth_restrict %d^2 R=%d' % (n, R),
                   shape=(n, n, R))
            record('jacobi_sweep2', desc, ck.jacobi_sweep2(planes, D, b, u),
                   stencil._jacobi2_ref(planes, D, b, u), True,
                   (lambda: ck.jacobi_sweep2(planes, D, b, u),
                    lambda: stencil._jacobi2_ref(planes, D, b, u)),
                   key='jacobi_sweep2 %d^2 R=%d' % (n, R), shape=(n, n, R))
            record('jacobi_sweep2_zero', desc, ck.jacobi_sweep2(planes, D, b),
                   stencil._jacobi2z_ref(planes, D, b), True,
                   (lambda: ck.jacobi_sweep2(planes, D, b),
                    lambda: stencil._jacobi2z_ref(planes, D, b)),
                   key='jacobi_sweep2_zero %d^2 R=%d' % (n, R),
                   shape=(n, n, R))
            record('presmooth_residual', desc,
                   ck.presmooth_residual(planes, D, mask, b),
                   stencil._ps2r_ref(planes, D, mask, b), True,
                   (lambda: ck.presmooth_residual(planes, D, mask, b),
                    lambda: stencil._ps2r_ref(planes, D, mask, b)),
                   key='presmooth_residual %d^2 R=%d' % (n, R),
                   shape=(n, n, R))
            del b, u
        del planes, D, mask
        torch.cuda.empty_cache()

    # K2 + K3 per production iteration: 2 preconditioner applications,
    # each one K2 at every smoothed level and one K3 sweep
    k2 = 2 * sum(results['presmooth_restrict %d^2 R=16' % n]['ms']
                 if n != 2048 else results['presmooth_restrict']['ms']
                 for n in (2048, 1024, 512, 256, 128, 64))
    per_it = {'K2_ms': k2,
              'K3_ms_hom': 2 * results['pcr_sweep']['ms'],
              'K3_ms_marmousi': 2 * results['pcr_sweep width=1536']['ms'],
              'K3_ms_default': 2 * results['pcr_sweep nz=2048']['ms']}
    check_slab_masks(gen)
    per_it['K2_K3_ms_hom'] = k2 + per_it['K3_ms_hom']
    per_it['K2_K3_ms_marmousi'] = k2 + per_it['K3_ms_marmousi']
    results['per_iteration'] = per_it
    say('  K2 + K3 per production iteration (2 x (K2 at 6 levels + K3)): '
        'hom %.3f ms (K2 %.3f, K3 %.3f), marmousi %.3f ms (K3 at the '
        '8-panel width %.3f); default config K3 %.3f ms'
        % (per_it['K2_K3_ms_hom'], k2, per_it['K3_ms_hom'],
           per_it['K2_K3_ms_marmousi'], per_it['K3_ms_marmousi'],
           per_it['K3_ms_default']))
    return results


def slab_mask(nz, nx, overlap=16):
    '''
    The closure mask of an overlapped-Schwarz slab with x-overlap
    ``overlap`` (zephyr_tpu/parallel/spatial.py:305-316): columns
    0..overlap and nx-1-overlap..nx-1 zero, float32 on the host.
    '''
    m = np.ones((nz, nx), np.float32)
    m[:, :overlap + 1] = 0.
    m[:, nx - overlap - 1:] = 0.
    return m


def check_slab_masks(gen):
    '''
    Phase 3, masked: K2 (1 and 2 sweeps), K4 and K9 against their twins
    under the ring mask times a slab's closure mask (zeros inside the
    grid, where K2's restriction stage and every kernel's per-point mask
    read them), at 2048^2 x 16 and at 37x53 x 3; the limit is KERNEL_TOL
    relative to the twin's largest magnitude.
    '''
    import torch
    from zephyr_tpu_torch.ops import cuda_kernels as ck
    from zephyr_tpu_torch.ops import stencil
    worst = 0.0
    for (nz, nx, R) in ((2048, 2048, 16), (37, 53, 3)):
        planes, D, ring, field = level_inputs(nz, nx, R, gen)
        mask = ring * torch.as_tensor(slab_mask(nz, nx), device=DEV)
        b, u = field(R, nz, nx), field(R, nz, nx)
        ec = field(R, (nz + 1) // 2, (nx + 1) // 2)
        desc = '%dx%d R=%d slab mask' % (nz, nx, R)
        checks = [('presmooth_restrict', ' nsweeps=2',
                   ck.presmooth_restrict(planes, D, mask, b, 2),
                   stencil._ps2rr_ref(planes, D, mask, b)),
                  ('presmooth_restrict', ' nsweeps=1',
                   ck.presmooth_restrict(planes, D, mask, b, 1),
                   stencil._ps1rr_ref(planes, D, mask, b)),
                  ('prolong_add_smooth', '',
                   ck.prolong_add_smooth(planes, D, mask, b, u, ec),
                   stencil._pas_ref(planes, D, mask, b, u, ec)),
                  ('presmooth_residual', '',
                   ck.presmooth_residual(planes, D, mask, b),
                   stencil._ps2r_ref(planes, D, mask, b))]
        for name, extra, out, ref in checks:
            rel, abs_err = rel_err(out, ref)
            worst = max(worst, rel)
            say('  %-19s %-38s rel err %.3e  abs err %.3e'
                % (name, desc + extra, rel, abs_err))
            if not rel <= KERNEL_TOL:
                fail('%s disagrees with its twin at %s: %.3e > %.0e'
                     % (name, desc + extra, rel, KERNEL_TOL))
        del planes, D, ring, mask, b, u, ec, checks
        torch.cuda.empty_cache()
    return worst


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


def headline(n, nsrc, medium, card, opts=PRODUCTION, label=None):
    '''
    Phase 5 (and 9a, 13a-b): prepare_operator + make_chunked_solver on
    the card at n^2 with nsrc point sources and the given solver options
    (None: the default SolverConfig; ``label`` names them in the printed
    line), the auto x-panel rule applied; a warm-up solve, then a timed
    one, which must reach tol. Returns a dict of the run's numbers (with
    the chunk trace and the launches per iteration) and the prepared
    operator.
    '''
    import torch
    from zephyr_tpu_torch.ops import cuda_kernels as ck
    from zephyr_tpu_torch.ops.special import hankel1_0
    from zephyr_tpu_torch.solver.helmholtz import (
        make_chunked_solver, resolve_solver_config, resolve_panels)
    cval = 1500.0
    freq = cval / 16.0
    c_np = MEDIA[medium](n)
    cname = label or ('default' if opts is None else 'production')
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
           'ms_per_iter': 1e3 * wall / max(iters, 1),
           'warmup_iters': iters0, 'peak_gb': peak_gb(),
           'trace': compact_trace(trace), 'launches_per_iter': per_iter}
    say('headline %s %s %d^2 x %d src (%d panels): iters %d  relres %.3e  '
        'wall %.3f s  %.3f solves/s  %.2f ms an iteration  (prep %.2f s; '
        'peak %.2f GB; card %s)'
        % (medium, cname, n, nsrc, cfg.strat_panels, iters, relres, wall,
           nsrc / wall, out['ms_per_iter'], t_prep, out['peak_gb'], card))

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


def kaiser_q_R(n, nfreq, src_pos, rec_pos):
    """
    Dense (nfreq, nsrc, n, n) Kaiser point sources and the (nrec, n^2)
    Kaiser receiver matrix, complex64, on the n^2 unit grid.
    """
    from zephyr_tpu_torch.parallel.multifreq import _kaiser_stamps
    nsrc, nrec = len(src_pos), len(rec_pos)
    scols, svals = _kaiser_stamps((n, n), 1.0, 1.0, src_pos, 4)
    rcols, rvals = _kaiser_stamps((n, n), 1.0, 1.0, rec_pos, 4,
                                  receiver=True)
    q = np.zeros((nsrc, n * n), np.complex64)
    np.add.at(q, (np.arange(nsrc)[:, None], scols), svals)
    R = np.zeros((nrec, n * n), np.complex64)
    np.add.at(R, (np.arange(nrec)[:, None], rcols), rvals)
    return np.repeat(q.reshape(1, nsrc, n, n), nfreq, axis=0), R


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
    q, R = kaiser_q_R(n, 1, src_pos, rec_pos)
    dobs = (0.01 * (rng.standard_normal((1, nsrc, nrec))
                    + 1j * rng.standard_normal((1, nsrc, nrec)))
            ).astype(np.complex64)

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


def tti_bench(n, nsrc, medium, card, warm=True, max_chunks=None,
              opts=None, label=None):
    '''
    Phase 8b/8c (and 13d): the bench's eurus / eurus_layered row
    (bench.py:425-484) through the port: prepare_operator +
    make_chunked_solver(chunk=16), the production config with
    gmres_restart=20 and mg_nu1=mg_nu2=1 (or ``opts``, named ``label``),
    a warm-up solve (``warm``) then a timed one of at most ``max_chunks``
    chunks (default: maxiter's). Returns the run's numbers, the chunk
    residual trace and the K8 launches per GMRES iteration of the timed
    solve.
    '''
    import torch
    from zephyr_tpu_torch.ops import cuda_kernels as ck
    from zephyr_tpu_torch.solver.helmholtz import (
        SolverConfig, prepare_operator, make_chunked_solver)
    cfg = SolverConfig(**(opts or TTI_OPTS))
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
    copies = ck.COPIES['apply_block_stencil']
    trace = []
    t0 = time.perf_counter()
    with level_launches() as lv:
        x, iters, relres = solver(op, b, max_chunks=max_chunks,
                                  trace=trace)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    per_iter = {k: (ck.LAUNCHES[k] - before[k]) / max(iters, 1)
                for k in ('apply_block_stencil', 'restrict', 'prolong')}
    out = {'row': ('eurus' if medium == 'hom' else 'eurus_layered')
           + (' ' + label if label else ''),
           'n': n, 'nsrc': nsrc, 'iters': iters, 'relres': relres,
           'reached_1e-5': bool(relres <= 1e-5), 'wall_s': wall,
           'ms_per_iter': 1e3 * wall / max(iters, 1),
           'solves_per_s': nsrc / wall, 'prep_s': t_prep,
           'warmup_iters': iters0, 'warmup_relres': relres0,
           'launches_per_iter': per_iter,
           'launches_by_level': lv.per_iter(iters),
           'k8_copies': ck.COPIES['apply_block_stencil'] - copies,
           'trace': compact_trace(trace), 'peak_gb': peak_gb()}
    say('TTI %s %d^2 x %d src: iters %d  relres %.3e (1e-5 %s)  wall %.3f s'
        '  %.3f solves/s, %.2f ms per GMRES iteration  (prep %.2f s; peak '
        '%.2f GB; card %s)'
        % (out['row'], n, nsrc, iters, relres,
           'reached' if out['reached_1e-5'] else 'NOT reached', wall,
           nsrc / wall, out['ms_per_iter'], t_prep, out['peak_gb'], card))
    say('  chunk trace [iterations, worst relres, repeats]: %s'
        % json.dumps(out['trace']))
    say('  launches per GMRES iteration: %s; K8 by level: %s; K8 calls '
        'whose operands were copied: %d'
        % (json.dumps(per_iter), json.dumps(out['launches_by_level']),
           out['k8_copies']))
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
    with level_launches() as lv:
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
           'trace': compact_trace(trace), 'launches_per_iter': per_iter,
           'launches_by_level': lv.per_iter(iters)}
    say('marmousi nu 3/3 %d^2 x %d src (%d panels): iters %d  relres %.3e '
        '(1e-5 %s)  wall %.3f s, %.2f ms per iteration  (prep %.2f s; peak '
        '%.2f GB; card %s)' % (n, nsrc, cfg.strat_panels, iters, relres,
                               'reached' if out['reached_1e-5']
                               else 'NOT reached', wall, out['ms_per_iter'],
                               t_prep, out['peak_gb'], card))
    say('  chunk trace [iterations, worst relres, repeats]: %s'
        % json.dumps(out['trace']))
    say('  launches per BiCGStab iteration: %s; K6 by level: %s'
        % (json.dumps(per_iter), json.dumps(out['launches_by_level'])))
    if not (np.isfinite(relres) and relres < 1.0
            and bool(torch.isfinite(x).all())):
        fail('marmousi nu 3/3: relres %r is not finite and below the '
             'starting 1.0' % relres)
    if 'presmooth_restrict' in per_iter or not per_iter.get('jacobi_sweep2'):
        fail('marmousi nu 3/3 ran K2 or no K6: %s' % per_iter)
    return out


# --- phase 10 ------------------------------------------------------------

def middleware_geometry(n, nsrc=16, nrec=64):
    '''
    Phase 7a's acquisition at n^2 as a survey geometry: nsrc sources drawn
    with seed 2, nrec receivers on row n/8, fixed spread.
    '''
    src = np.random.default_rng(2).integers(
        n // 8, 7 * n // 8, size=(nsrc, 2)).astype(np.float64)
    rec = np.stack([np.linspace(n // 8, 7 * n // 8, nrec),
                    np.full(nrec, float(n // 8))], axis=1)
    return {'src': src, 'rec': rec, 'mode': 'fixed'}


def middleware_pair(problem_cls, survey_cls, n, c, freqs, **kw):
    '''
    A paired problem and survey on the card: MiniZephyr at dx = dz = 1,
    the production solver options, phase 7a's geometry.
    '''
    from zephyr_tpu_torch.backend import MiniZephyr
    sc = {'Disc': MiniZephyr, 'nx': n, 'nz': n, 'dx': 1., 'dz': 1.,
          'c': c, 'rho': 1., 'freqs': list(freqs), 'nPML': 10,
          'geom': middleware_geometry(n), 'solverOpts': dict(PRODUCTION),
          'device': DEV}
    sc.update(kw)
    problem, survey = problem_cls(sc), survey_cls(sc)
    problem.pair(survey)
    return problem, survey


def smooth_field(n, seed, width=16.0):
    '''
    A smooth seeded (n, n) field of unit rms: white noise low-passed to
    wavelengths above ``width`` cells.
    '''
    w = np.random.default_rng(seed).standard_normal((n, n))
    k = np.sqrt(np.fft.fftfreq(n)[:, None] ** 2
                + np.fft.fftfreq(n)[None, :] ** 2)
    f = np.real(np.fft.ifft2(np.fft.fft2(w) * (k <= 1.0 / width)))
    return f / max(f.std(), 1e-30)


class krylov_runs:
    '''
    Record, in call order, the outer iterations (the worst over its batch)
    and the wall of every Krylov run inside the block: the solver's
    ``_krylov_solve`` is replaced for the block's duration by a function
    that synchronises the card, calls through, synchronises again and
    records.
    '''

    def __enter__(self):
        import torch
        from zephyr_tpu_torch.solver import helmholtz
        self.saved = run = helmholtz._krylov_solve
        self.iters, self.seconds, self.relres = [], [], []

        def _krylov_solve(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            self.iters.append(int(res.iters.max()))
            self.relres.append(float(res.relres.max()))
            return res
        helmholtz._krylov_solve = _krylov_solve
        return self

    def __exit__(self, *exc):
        from zephyr_tpu_torch.solver import helmholtz
        helmholtz._krylov_solve = self.saved


def timed(label, fn, out):
    '''
    Run fn on the card with the peak memory reset before it; record its
    wall, peak GB (and the GB allocated when it started), and the
    iterations, seconds and worst relres of each Krylov run it made
    (forward, then tangent or adjoint) in ``out[label]``, and return its
    result.
    '''
    import torch
    reset_peak()
    base = torch.cuda.memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    with krylov_runs() as kr:
        res = fn()
        torch.cuda.synchronize()
    out[label] = {'wall_s': time.perf_counter() - t0, 'peak_gb': peak_gb(),
                  'base_gb': base,
                  'iters': kr.iters, 'solve_s': kr.seconds,
                  'relres': kr.relres}
    return res


def dot_test(problem, survey, n, seed, out, label):
    '''
    Jvec(v) and Jtvec(w) for a smooth seeded v and seeded complex w, timed
    into ``out``; returns |Re<w, Jv> - <J^T w, v>| / |Re<w, Jv>|.
    '''
    v = 10.0 * smooth_field(n, seed).ravel()
    rng = np.random.default_rng(seed + 1)
    w = rng.standard_normal(survey.nD) + 1j * rng.standard_normal(survey.nD)
    jv = timed(label + ' Jvec', lambda: problem.Jvec(v=v), out)
    jtw = timed(label + ' Jtvec', lambda: problem.Jtvec(v=w), out)
    if not (np.isfinite(jv).all() and np.isfinite(jtw).all()):
        fail('%s: non-finite Jvec or Jtvec' % label)
    lhs = float(np.real(np.vdot(w, jv)))
    rhs = float(np.dot(jtw.astype(np.float64), v))
    return abs(lhs - rhs) / abs(lhs)


def middleware_marmousi(n, card, limit=1e-3):
    '''
    Phase 10a: the 2D inverse-problem layer on the bench's Marmousi model
    at n^2 (Helm2DProblem + Helm2DSurvey, one frequency 1500/16, the
    production config, whose auto rule gives 8 x-panels at 2048^2):
    survey.dpred() through the MultiFreq distributor, the differentiable
    forward map at the same model (must agree within ``limit``), Jvec,
    Jtvec and their adjoint dot test (within ``limit``).
    '''
    import torch
    from zephyr_tpu_torch.middleware import Helm2DProblem, Helm2DSurvey
    c = marmousi_c(n).astype(np.float64)
    problem, survey = middleware_pair(Helm2DProblem, Helm2DSurvey, n, c,
                                      [1500.0 / 16])
    out = {'n': n, 'nsrc': survey.nsrc, 'nrec': survey.nrec,
           'nfreq': survey.nfreq,
           'panels': problem.solverConfig.strat_panels}
    walls = {}
    d = timed('dpred', survey.dpred, walls)

    def forward_map():
        with torch.no_grad():
            return problem._dpred_fn()(problem._baseTensor())
    d_fn = timed('forward map', forward_map, walls).cpu().numpy().ravel()
    if not (d.shape == (survey.nD,) and np.isfinite(d).all()
            and np.abs(d).max() > 0):
        fail('middleware dpred %d^2: shape %s, finite %s'
             % (n, d.shape, np.isfinite(d).all()))
    out['forward_rel_diff'] = float(np.linalg.norm(d_fn - d)
                                    / np.linalg.norm(d))
    out['dot_test'] = dot_test(problem, survey, n, 7, walls, 'marmousi')
    out['walls'] = walls
    say('middleware %d^2 marmousi (%d panels), %d src x %d rec x %d freq: '
        'forward map vs dpred %.3e, dot test %.3e (limits %.0e); %s '
        '(card %s)' % (n, out['panels'], survey.nsrc, survey.nrec,
                       survey.nfreq, out['forward_rel_diff'],
                       out['dot_test'], limit, json.dumps(walls), card))
    if not out['forward_rel_diff'] <= limit:
        fail('middleware: the forward map and dpred differ by %.3e'
             % out['forward_rel_diff'])
    if not out['dot_test'] <= limit:
        fail('middleware: dot test %.3e > %.0e' % (out['dot_test'], limit))
    return out


def middleware_gradient(n, card, limit=1e-3):
    '''
    Phase 10b: misfit_and_gradient at a smoothed start model against
    data dpred made at the true Marmousi model (n^2, two frequencies),
    held against Jtvec of the residual dpred(m0) - dobs (the same VJP).
    '''
    from scipy.ndimage import gaussian_filter
    from zephyr_tpu_torch.middleware import Helm2DProblem, Helm2DSurvey
    c = marmousi_c(n).astype(np.float64)
    freqs = [0.75 * 1500.0 / 16, 1500.0 / 16]
    problem, survey = middleware_pair(Helm2DProblem, Helm2DSurvey, n, c,
                                      freqs)
    walls = {}
    dobs = timed('dobs', survey.dpred, walls)
    m0 = gaussian_filter(c, 8.0)
    f, g = timed('misfit_and_gradient',
                 lambda: problem.misfit_and_gradient(m0, dobs), walls)
    r = timed('dpred(m0)', lambda: survey.dpred(m0), walls) - dobs
    jtr = timed('Jtvec(residual)', lambda: problem.Jtvec(m0, r), walls)
    gnorm = float(np.linalg.norm(g))
    diff = float(np.linalg.norm(g - jtr) / np.linalg.norm(jtr))
    out = {'n': n, 'nfreq': len(freqs), 'misfit': f, 'grad_norm': gnorm,
           'rel_diff_vs_jtvec': diff, 'walls': walls,
           'panels': problem.solverConfig.strat_panels}
    say('middleware %d^2 marmousi misfit_and_gradient (%d freq, %d panels): '
        'misfit %.6e |grad| %.6e, against Jtvec(dpred(m0) - dobs) %.3e '
        '(limit %.0e); %s (card %s)' % (n, len(freqs), out['panels'], f,
                                        gnorm, diff, limit,
                                        json.dumps(walls), card))
    if not (np.isfinite(f) and np.isfinite(g).all() and gnorm > 0):
        fail('middleware gradient: misfit %r, finite %s, |grad| %r'
             % (f, np.isfinite(g).all(), gnorm))
    if not diff <= limit:
        fail('middleware gradient differs from Jtvec by %.3e' % diff)
    return out


def middleware_visco(n, card, limit=1e-3):
    '''
    Phase 10c: the adjoint dot test at n^2 on the Marmousi model for
    Helm2DViscoProblem (Q 50, freqBase half the frequency: the dispersed
    velocity) and for Helm2DViscoMultiGridProblem with
    Helm2DMultiGridSurvey (MiniZephyrHD, two frequencies on two grids:
    n^2 and (n/2)^2 by targetGPW 16).
    '''
    from zephyr_tpu_torch.backend import MiniZephyrHD
    from zephyr_tpu_torch.middleware import (
        Helm2DViscoProblem, Helm2DViscoMultiGridProblem, Helm2DSurvey,
        Helm2DMultiGridSurvey)
    c = marmousi_c(n).astype(np.float64)
    f1 = 1500.0 / 16
    out = {}
    for label, cls, scls, freqs, kw in (
            ('visco', Helm2DViscoProblem, Helm2DSurvey, [f1],
             {'Q': 50., 'freqBase': f1 / 2}),
            ('visco multigrid', Helm2DViscoMultiGridProblem,
             Helm2DMultiGridSurvey, [f1 / 2, f1],
             {'Q': 50., 'freqBase': f1 / 4, 'Disc': MiniZephyrHD,
              'cMin': 1500., 'targetGPW': 16.})):
        problem, survey = middleware_pair(cls, scls, n, c, freqs, **kw)
        walls = {}
        err = dot_test(problem, survey, n, 11, walls, label)
        row = {'n': n, 'nfreq': len(freqs), 'dot_test': err,
               'walls': walls}
        if label == 'visco multigrid':
            row['grids'] = [
                int(survey.scScales[survey.buildSC(i)]['nz'])
                for i in range(len(freqs))]
            if len(set(row['grids'])) != 2:
                fail('visco multigrid: grids %s, not two' % row['grids'])
        out[label] = row
        say('middleware %d^2 %s, %d freq%s: dot test %.3e (limit %.0e); %s '
            '(card %s)' % (n, label, len(freqs),
                           ' on grids %s' % row['grids'] if 'grids' in row
                           else '', err, limit, json.dumps(walls), card))
        if not err <= limit:
            fail('%s: dot test %.3e > %.0e' % (label, err, limit))
    return out


# --- phase 11 ------------------------------------------------------------

def freqblock(n, nfreq, nsrc, card, batch=16, chunk=32):
    """
    Phase 11a: staged config 3 by the recipe of the bench's ``freqblock``
    row (bench.py:487-582): the n^2 4-layer model, nfreq frequencies
    linspace(0.5, 1.0) * 1500/16, each on its grid by targetGPW 16
    (``freq_grid_plan``, quantum 256: the model resampled to it), nsrc
    point sources drawn with seed 3, in batches of ``batch``; a warm-up
    solve per grid shape, then the timed block. Every batch must reach
    tol. The solver restarts every ``chunk`` iterations
    (make_chunked_solver(chunk=32), as phase 5): the bench restarts every
    16, and on frequency 0 that stops on the restart guard near 5e-4 in
    both packages (printed here for the first batch, before the timed
    block).
    """
    import torch
    from zephyr_tpu_torch.backend import resample_field
    from zephyr_tpu_torch.ops.minizephyr_coeff import minizephyr_planes
    from zephyr_tpu_torch.parallel import freq_grid_plan
    from zephyr_tpu_torch.solver.helmholtz import (
        make_chunked_solver, prepare_operator, resolve_panels,
        resolve_solver_config, shifted_velocity)
    cval = 1500.0
    c_np = layered_c(n)
    cfg = resolve_panels(resolve_solver_config(PRODUCTION, torch.complex64),
                         c_np)
    freqs = np.linspace(0.5, 1.0, nfreq) * (cval / 16)
    plans = freq_grid_plan(n, n, freqs, cval, target_gpw=16,
                           quantum=max(n // 4, 256))
    c_t = torch.as_tensor(c_np, device=DEV).to(torch.complex64)

    def prep(freq, shape):
        c = c_t if shape == (n, n) else resample_field(c_t, shape)
        rho = torch.ones(shape, dtype=torch.float32, device=DEV)
        pk = dict(dx=float(n) / shape[1], dz=float(n) / shape[0])
        planes = minizephyr_planes(c, rho, freq, **pk)[None, None]
        pplanes = minizephyr_planes(shifted_velocity(c, cfg.shift), rho,
                                    freq, pml_cap=cfg.pml_cap,
                                    **pk)[None, None]
        return prepare_operator(planes, pplanes, cfg, with_transpose=False)

    def rhs(pos, shape):
        b = torch.zeros((pos.shape[0], 1) + shape, dtype=torch.complex64,
                        device=DEV)
        b[torch.arange(pos.shape[0]), 0, torch.as_tensor(pos[:, 0]),
          torch.as_tensor(pos[:, 1])] = 1.0
        return b

    rng = np.random.default_rng(3)
    solver = make_chunked_solver(cfg, chunk=chunk)
    reset_peak()
    for shape in dict.fromkeys(plans):      # warm-up, one per grid shape
        op = prep(freqs[plans.index(shape)], shape)
        pos = rng.integers(shape[0] // 8, 7 * shape[0] // 8, size=(batch, 2))
        solver(op, rhs(pos, shape))
    # the bench's restart length on frequency 0 (its grid is the first
    # warm-up shape: the warm-up's first positions)
    pos = np.random.default_rng(3).integers(plans[0][0] // 8,
                                            7 * plans[0][0] // 8,
                                            size=(batch, 2))
    trace16 = []
    _, it16, rr16 = make_chunked_solver(cfg, chunk=16)(
        prep(freqs[0], plans[0]), rhs(pos, plans[0]), trace=trace16)
    say('11a the bench\'s restarts (chunk 16), frequency 0, first batch of '
        '%d: %d iterations, relres %.3e, chunk trace %s'
        % (batch, it16, rr16, compact_trace(trace16)))
    torch.cuda.synchronize()
    iters_by_freq, worst = [], 0.0
    t0 = time.perf_counter()
    for i, f in enumerate(freqs):
        shape = plans[i]
        op = prep(f, shape)
        pos = rng.integers(shape[0] // 8, 7 * shape[0] // 8, size=(nsrc, 2))
        tot = 0
        for s0 in range(0, nsrc, batch):
            x, iters, relres = solver(op, rhs(pos[s0:s0 + batch], shape))
            if not (np.isfinite(relres) and relres <= cfg.tol):
                fail('freqblock %d^2: frequency %d, batch %d: relres %.3e '
                     '> tol %.0e' % (n, i, s0 // batch, relres, cfg.tol))
            worst = max(worst, relres)
            tot += int(iters)
        iters_by_freq.append(tot // max(1, nsrc // batch))
        del op
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {'n': n, 'nfreq': nfreq, 'nsrc': nsrc, 'batch': batch,
           'chunk': chunk, 'grids': sorted(set(plans)), 'wall_s': wall,
           'bench_chunk16_first_batch': {'iters': it16, 'relres': rr16},
           'solves_per_s': nfreq * nsrc / wall, 'worst_relres': worst,
           'iters_by_freq': iters_by_freq, 'peak_gb': peak_gb()}
    say('11a freqblock %d^2 layered, %d freq x %d src on grids %s: wall '
        '%.3f s, %.3f solves/s, worst relres %.3e, peak %.2f GB (card %s)'
        % (n, nfreq, nsrc, out['grids'], wall, out['solves_per_s'], worst,
           out['peak_gb'], card))
    say('11a iterations per frequency (mean over batches): %s'
        % iters_by_freq)
    return out


def multifreq_gradient(n, nfreq, nsrc, nrec, card, limit=1e-3):
    """
    Phase 11b: the differentiable multi-frequency forward map
    (``multifreq_dpred``) at n^2 on the 4-layer model, nfreq frequencies
    0.75-1.0 x 1500/16, nsrc Kaiser sources, nrec receivers, and the
    autograd gradient of ``fwi_misfit`` against ``fwi_misfit_grad_chunked``
    on the same inputs (max-norm relative <= ``limit``, as phase 7c).
    """
    import torch
    from zephyr_tpu_torch.parallel import (fwi_misfit, fwi_misfit_grad_chunked,
                                           multifreq_dpred)
    from zephyr_tpu_torch.solver.helmholtz import SolverConfig, resolve_panels
    c = layered_c(n).astype(np.float64)
    cfg = resolve_panels(SolverConfig(**PRODUCTION), c)
    freqs = np.linspace(0.75, 1.0, nfreq) * (1500.0 / 16)
    rng = np.random.default_rng(4)
    src_pos = rng.uniform(n // 8, 7 * n // 8, size=(nsrc, 2))
    rec_pos = np.stack([np.linspace(n // 8, 7 * n // 8, nrec),
                        np.full(nrec, float(n // 8))], axis=1)
    q, R = kaiser_q_R(n, nfreq, src_pos, rec_pos)
    dobs = (0.01 * (rng.standard_normal((nfreq, nsrc, nrec))
                    + 1j * rng.standard_normal((nfreq, nsrc, nrec)))
            ).astype(np.complex64)
    rho = np.ones((n, n))
    walls = {}

    def dpred():
        with torch.no_grad():
            return multifreq_dpred(c.astype(np.float32), rho, freqs, q, R,
                                   config=cfg, device=DEV)
    d = timed('multifreq_dpred', dpred, walls)

    def autograd():
        ct = torch.as_tensor(c, dtype=torch.float32, device=DEV)
        ct.requires_grad_(True)
        f = fwi_misfit(ct, dobs, rho, freqs, q, R, config=cfg, device=DEV)
        g, = torch.autograd.grad(f, ct)
        return float(f.detach()), g.cpu().numpy()
    m_ad, g_ad = timed('fwi_misfit + autograd', autograd, walls)
    m_ch, g_ch = timed('fwi_misfit_grad_chunked', lambda: (
        fwi_misfit_grad_chunked(c, rho, freqs, q, R, dobs, config=cfg,
                                chunk=nsrc, device=DEV)), walls)
    if not (d.shape == (nfreq, nsrc, nrec) and bool(torch.isfinite(d).all())
            and np.isfinite(g_ad).all()):
        fail('11b: dpred shape %s / non-finite data or gradient'
             % (tuple(d.shape),))
    diff = float(np.max(np.abs(g_ad - g_ch)) / np.max(np.abs(g_ch)))
    mis_diff = abs(m_ad - m_ch) / m_ch
    out = {'n': n, 'nfreq': nfreq, 'nsrc': nsrc, 'nrec': nrec,
           'max_rel_diff': diff, 'misfit_rel_diff': mis_diff,
           'walls': walls}
    say('11b multifreq_dpred + autograd fwi_misfit %d^2 layered, %d freq x '
        '%d src x %d rec: max|g_autograd - g_chunked| / max|g_chunked| '
        '%.3e (limit %.0e), misfit rel diff %.3e; %s (card %s)'
        % (n, nfreq, nsrc, nrec, diff, limit, mis_diff, json.dumps(walls),
           card))
    if not diff <= limit:
        fail('11b: autograd and chunked gradients differ by %.3e' % diff)
    return out


def multiscale(n, card, iters_per_block=3):
    """
    Phase 11c: staged config 5 by the recipe of the bench's ``multiscale``
    row (bench.py:704-770): n^2 layered model with a slow box, a
    depth-trend start, 8 sources and 32 receivers on row n/8, 4
    frequencies; data by ``multifreq_dpred_chunked`` (restarts every 32
    iterations, as 11a), then 2 blocks x
    ``iters_per_block`` gradient steps by ``fwi_misfit_grad_chunked``
    (fixed step, ~30 m/s at the gradient peak). Then the same inversion
    through the middleware: FrequencyContinuation(Helm2DProblem,
    Helm2DSurvey) over the same blocks, 2 ProjectedGradient iterations a
    block, on data the survey makes at the true model. Both must lower
    the misfit.
    """
    import torch
    from zephyr_tpu_torch.backend import MiniZephyr
    from zephyr_tpu_torch.middleware import (
        FrequencyContinuation, Helm2DProblem, Helm2DSurvey, ProjectedGradient,
        l2_DataMisfit)
    from zephyr_tpu_torch.parallel import (fwi_misfit_grad_chunked,
                                           multifreq_dpred_chunked)
    from zephyr_tpu_torch.solver.helmholtz import SolverConfig
    cfg = SolverConfig(**PRODUCTION)
    nsrc, nrec, nfreq = 8, 32, 4
    freqs = np.linspace(0.4, 1.0, nfreq) * (1500.0 / 16)
    c_true = layered_c(n).astype(np.float64)
    c_true[(3 * n) // 8:(5 * n) // 8, (3 * n) // 8:(5 * n) // 8] -= 150.
    m0 = np.broadcast_to(np.linspace(1500., 3000., n)[:, None],
                         (n, n)).copy()
    rho = np.ones((n, n))
    sx = np.linspace(n // 8, 7 * n // 8, nsrc).astype(int)
    q = np.zeros((nfreq, nsrc, n, n), np.complex64)
    for i in range(nfreq):
        q[i, np.arange(nsrc), n // 8, sx] = 1.0
    rxs = np.linspace(n // 8, 7 * n // 8, nrec).astype(int)
    R = np.zeros((nrec, n * n), np.complex64)
    R[np.arange(nrec), (n // 8) * n + rxs] = 1.0
    blocks = [[0, 1], [2, 3]]
    err0 = float(np.linalg.norm(m0 - c_true))
    out = {'n': n, 'nsrc': nsrc, 'nrec': nrec, 'nfreq': nfreq,
           'blocks': blocks}

    reset_peak()
    stats = {}
    t0 = time.perf_counter()
    dobs = multifreq_dpred_chunked(c_true, rho, freqs, q, R, config=cfg,
                                   chunk=32, device=DEV, stats=stats)
    t_data = time.perf_counter() - t0
    m, hist, fwi_iters = m0.copy(), [], []
    t0 = time.perf_counter()
    for blk in blocks:
        lr = None
        for _ in range(iters_per_block):
            st = {}
            mis, grad = fwi_misfit_grad_chunked(
                m, rho, freqs[blk], q[blk], R, dobs[blk], config=cfg,
                chunk=16, device=DEV, stats=st)
            if lr is None:
                lr = 30.0 / max(float(np.abs(grad).max()), 1e-30)
            m = m - lr * grad
            hist.append(float(mis))
            fwi_iters.append([(a, b) for _, _, a, b in st['iters']])
    wall = time.perf_counter() - t0
    out['chunked'] = {
        'data_s': t_data, 'data_iters_by_freq': stats['iters'],
        'data_worst_relres': max(stats['relres']), 'wall_s': wall,
        'misfit_trajectory': hist,
        'misfit_reduction_by_block': [
            hist[b * iters_per_block + iters_per_block - 1]
            / hist[b * iters_per_block] for b in range(len(blocks))],
        'model_err_reduction': float(np.linalg.norm(m - c_true)) / err0,
        'iters_fwd_adj': fwi_iters, 'peak_gb': peak_gb()}
    ch = out['chunked']
    say('11c multiscale %d^2 chunked drivers: data %.2f s (iterations per '
        'frequency %s, worst relres %.3e), 2 blocks x %d steps %.2f s, '
        'misfit %s, reduction by block %s, model error reduction %.4f, peak '
        '%.2f GB (card %s)' % (n, t_data, stats['iters'],
                               ch['data_worst_relres'], iters_per_block,
                               wall, ['%.6e' % h for h in hist],
                               ['%.4f' % r for r in
                                ch['misfit_reduction_by_block']],
                               ch['model_err_reduction'], ch['peak_gb'],
                               card))
    say('11c chunked (forward, adjoint) iterations per step and frequency: '
        '%s' % fwi_iters)
    k = iters_per_block
    if not (np.isfinite(hist).all()
            and all(hist[b * k + k - 1] < hist[b * k]
                    for b in range(len(blocks)))):
        fail('11c: the chunked drivers did not lower the misfit within each '
             'block: %s' % hist)

    geom = {'src': np.stack([sx, np.full(nsrc, n // 8)], 1).astype(float),
            'rec': np.stack([rxs, np.full(nrec, n // 8)], 1).astype(float),
            'mode': 'fixed'}
    sc = {'Disc': MiniZephyr, 'nx': n, 'nz': n, 'dx': 1., 'dz': 1.,
          'c': c_true, 'rho': 1., 'freqs': list(freqs), 'nPML': 10,
          'geom': geom, 'solverOpts': dict(PRODUCTION), 'device': DEV}
    reset_peak()
    walls = {}
    problem, survey = Helm2DProblem(sc), Helm2DSurvey(sc)
    problem.pair(survey)
    d_true = timed('dobs', survey.dpred, walls)
    dobs_mw = d_true.reshape((survey.nrec, survey.nsrc, survey.nfreq))
    sc0 = dict(sc, c=m0.copy())
    p0, s0 = Helm2DProblem(sc0), Helm2DSurvey(sc0)
    p0.pair(s0)
    dmisfit = l2_DataMisfit(s0, d_true)
    f0 = timed('misfit(m0)', lambda: dmisfit.eval(m0.ravel()), walls)
    driver = FrequencyContinuation(
        Helm2DProblem, Helm2DSurvey, sc, dobs_mw, blocks=blocks,
        optFactory=lambda: ProjectedGradient(maxIter=2, print_progress=False))
    with krylov_runs() as kr:
        t0 = time.perf_counter()
        m_mw = driver.run(m0)
        torch.cuda.synchronize()
        walls['FrequencyContinuation'] = time.perf_counter() - t0
    f1 = timed('misfit(m)', lambda: dmisfit.eval(m_mw), walls)
    out['middleware'] = {
        'misfit_start': f0, 'misfit_end': f1,
        'block_misfits': [h['f'] for h in driver.history],
        'model_err_reduction': float(np.linalg.norm(m_mw.reshape(n, n)
                                                    - c_true)) / err0,
        'krylov_runs': len(kr.iters), 'max_iters': max(kr.iters),
        'worst_relres': max(kr.relres), 'walls': walls,
        'peak_gb': peak_gb()}
    mw = out['middleware']
    say('11c multiscale %d^2 middleware FrequencyContinuation (2 blocks x 2 '
        'ProjectedGradient iterations): misfit over all frequencies %.6e -> '
        '%.6e (its solves: iterations %s, worst relres %.3e), block misfits '
        '%s, model error reduction %.4f, %d Krylov runs in the driver (at '
        'most %d iterations, worst relres %.3e), peak %.2f GB; %s (card %s)'
        % (n, f0, f1, walls['misfit(m)']['iters'],
           max(walls['misfit(m)']['relres']),
           ['%.6e' % f for f in mw['block_misfits']],
           mw['model_err_reduction'], mw['krylov_runs'], mw['max_iters'],
           mw['worst_relres'], mw['peak_gb'], json.dumps(walls), card))
    if not (np.isfinite(f1) and f1 < f0):
        fail('11c: FrequencyContinuation did not lower the misfit: %.6e -> '
             '%.6e' % (f0, f1))
    return out


def oracle_25d(card):
    """
    Phase 11d, first part: the reference's 2.5D oracle
    (tests/test_minizephyr.py:88-115): MiniZephyr25D * q at 200x100, nky
    20, against AnalyticalHelmholtz in 3D, with the production solver
    options, on the card; interior-window error below 1e-2.
    """
    from zephyr_tpu_torch.backend import (MiniZephyr25D, SimpleSource,
                                          AnalyticalHelmholtz)
    config = {'c': 2500., 'rho': 1., 'nx': 100, 'nz': 200, 'freq': 200.,
              'nky': 20, '3D': True, 'solverOpts': dict(PRODUCTION),
              'device': DEV}
    loc = np.array([[25., 25.]])
    reset_peak()
    with krylov_runs() as kr:
        t0 = time.perf_counter()
        u = MiniZephyr25D(config) * SimpleSource(config)(loc)
        secs = time.perf_counter() - t0
    uA = np.asarray(AnalyticalHelmholtz(config)(loc))
    if u.shape != (200 * 100, 1) or not np.isfinite(u).all():
        fail('2.5D oracle: wavefield of shape %s' % (u.shape,))
    seg = (slice(40, 180), slice(40, 80))
    rel = ((uA.reshape(200, 100)[seg] - u.reshape(200, 100)[seg])
           / abs(uA.reshape(200, 100)[seg]))
    err = float(np.sqrt((rel.conj() * rel).sum()).real / rel.size)
    out = {'error': err, 'wall_s': secs, 'iters_by_ky': kr.iters,
           'worst_relres': max(kr.relres), 'peak_gb': peak_gb()}
    say('11d 2.5D oracle 200x100 nky 20 MiniZephyr25D * q: error %.3e (limit '
        '1e-2), %.2f s, iterations per ky %s, worst relres %.3e, peak %.2f '
        'GB (card %s)' % (err, secs, kr.iters, out['worst_relres'],
                          out['peak_gb'], card))
    if not err < 1e-2:
        fail('2.5D oracle error %.3e >= 1e-2' % err)
    return out


def middleware_25d(n, nky, card, limit=1e-3):
    """
    Phase 11d, second part: Helm25DProblem + Helm25DSurvey on the bench's
    Marmousi model at n^2 (the reference's remDists chain: MultiFreq over
    MiniZephyr25D over MiniZephyr), nky cross-line wavenumbers, one
    frequency 1500/16, phase 7a's 16 sources and 64 receivers, the
    production config: survey.dpred() through the distributor, the
    differentiable forward map (its per-ky iterations; its peak beside
    that of the same map at nky 2), Jvec, Jtvec and their dot test
    (within ``limit``), and ``multifreq_dpred_25d`` on the same model,
    sources and receivers (within ``limit`` of dpred).
    """
    import torch
    from zephyr_tpu_torch.backend import MiniZephyr25D
    from zephyr_tpu_torch.middleware import Helm25DProblem, Helm25DSurvey
    from zephyr_tpu_torch.parallel import multifreq_dpred_25d
    c = marmousi_c(n).astype(np.float64)
    freq = 1500.0 / 16
    problem, survey = middleware_pair(
        Helm25DProblem, Helm25DSurvey, n, c, [freq],
        remDists=[MiniZephyr25D], nky=nky, parallel=False,
        cmin=float(c.min()))
    cfg = problem.solverConfig
    out = {'n': n, 'nky': nky, 'nsrc': survey.nsrc, 'nrec': survey.nrec,
           'panels': cfg.strat_panels}
    walls = {}
    d = timed('dpred', survey.dpred, walls)
    if not (d.shape == (survey.nD,) and np.isfinite(d).all()
            and np.abs(d).max() > 0):
        fail('11d dpred %d^2: shape %s, finite %s'
             % (n, d.shape, np.isfinite(d).all()))
    # the distributor keeps every ky subproblem's operator (the
    # reference's cached factors); drop them before the forward map
    del problem.factors
    torch.cuda.empty_cache()

    def forward_map(p):
        with torch.no_grad():
            return p._dpred_fn()(p._baseTensor())
    d_fn = timed('forward map', lambda: forward_map(problem),
                 walls).cpu().numpy().ravel()
    out['forward_rel_diff'] = float(np.linalg.norm(d_fn - d)
                                    / np.linalg.norm(d))
    out['iters_by_ky'] = walls['forward map']['iters']
    p2, _ = middleware_pair(Helm25DProblem, Helm25DSurvey, n, c, [freq],
                            remDists=[MiniZephyr25D], nky=2,
                            parallel=False, cmin=float(c.min()))
    timed('forward map nky 2', lambda: forward_map(p2), walls)

    v = 10.0 * smooth_field(n, 13).ravel()
    rng = np.random.default_rng(14)
    w = rng.standard_normal(survey.nD) + 1j * rng.standard_normal(survey.nD)
    jv = timed('Jvec', lambda: problem.Jvec(v=v), walls)
    jtw = timed('Jtvec', lambda: problem.Jtvec(v=w), walls)
    if not (np.isfinite(jv).all() and np.isfinite(jtw).all()):
        fail('11d: non-finite Jvec or Jtvec')
    lhs = float(np.real(np.vdot(w, jv)))
    out['dot_test'] = abs(lhs - float(np.dot(jtw.astype(np.float64), v))) \
        / abs(lhs)

    q = np.stack([survey.getSources()[0].toarray().T.reshape(-1, n, n)])
    R = survey.rVec(0).toarray()
    d25 = timed('multifreq_dpred_25d', lambda: multifreq_dpred_25d(
        c.astype(np.float32), np.ones((n, n)), [freq],
        q.astype(np.complex64), R, nky, cmin=float(c.min()), config=cfg,
        device=DEV), walls)
    d25 = d25.cpu().numpy()[0].T.ravel()      # (nrec, nsrc) as dpred
    out['multifreq_25d_rel_diff'] = float(np.linalg.norm(d25 - d)
                                          / np.linalg.norm(d))
    out['walls'] = walls
    say('11d 2.5D %d^2 marmousi (%d panels), nky %d, %d src x %d rec x 1 '
        'freq: forward map vs dpred %.3e, multifreq_dpred_25d vs dpred %.3e, '
        'dot test %.3e (limits %.0e)' % (
            n, out['panels'], nky, survey.nsrc, survey.nrec,
            out['forward_rel_diff'], out['multifreq_25d_rel_diff'],
            out['dot_test'], limit))
    say('11d iterations per ky (ky_j = j f / (cmin (nky - 1)), ky = 0 first; '
        'a cell of velocity c is evanescent where ky > f / c): %s'
        % out['iters_by_ky'])
    for k, row in walls.items():
        say('11d   %s: wall %.3f s, peak %.2f GB (%.2f GB at its start), '
            'Krylov runs %d (%d iterations in all, worst relres %.3e) '
            '(card %s)' % (k, row['wall_s'], row['peak_gb'], row['base_gb'],
                           len(row['iters']), sum(row['iters']),
                           max(row['relres'] or [0.0]), card))
    for key in ('forward_rel_diff', 'multifreq_25d_rel_diff', 'dot_test'):
        if not out[key] <= limit:
            fail('11d: %s %.3e > %.0e' % (key, out[key], limit))
    return out


# --- phase 12 ------------------------------------------------------------

def tti_receivers(n, nrec):
    '''Phase 7a's receiver line at n^2: (row n/8, nrec columns).'''
    cols = np.linspace(n // 8, 7 * n // 8, nrec).round().astype(np.int64)
    return n // 8, cols


def tti_solve_backward(n, nsrc, nrec, card, opts=None, tag='12a'):
    '''
    Phase 12a: the backward of ``solve_batched`` on the bench's `eurus`
    row (n^2 hom, TTI_ANISO, TTI_OPTS, complex64, ``tti_sources``),
    prepared with_transpose=True, for the receiver misfit 0.5 sum |x|^2
    over ``tti_receivers`` (zero observed data): the forward (planes,
    preparation, one GMRES run) and the backward (the transposed block
    family's reduction, one adjoint GMRES run with the transpose
    preconditioner, the block plane products and the planes' backward)
    timed apart, each run's iterations and ms an iteration, the peak GB.
    The gradient w.r.t. c must be finite and non-zero. With ``opts`` (in
    place of TTI_OPTS; phase 13d) the GMRES runs need not reach tol: they
    must end finite and below their starting residual.
    '''
    import torch
    from zephyr_tpu_torch.ops.eurus_coeff import eurus_planes
    from zephyr_tpu_torch.solver.helmholtz import (
        SolverConfig, prepare_operator, shifted_velocity, solve_batched)
    cfg = SolverConfig(**(opts or TTI_OPTS))
    freq = 1500.0 / 16
    c = torch.full((n, n), 1500.0, dtype=torch.float32, device=DEV,
                   requires_grad=True)
    rho = torch.ones((n, n), dtype=torch.float32, device=DEV)
    aniso = {k: torch.full((n, n), v, dtype=torch.float32, device=DEV)
             for k, v in TTI_ANISO.items()}
    b = tti_sources(n, nsrc)
    rz, rx = tti_receivers(n, nrec)
    rx = torch.as_tensor(rx, device=DEV)
    reset_peak()
    with krylov_runs() as kr:
        t0 = time.perf_counter()
        cc = c.to(torch.complex64)
        planes = eurus_planes(cc, rho, freq, **aniso)
        pplanes = eurus_planes(shifted_velocity(cc.detach(), cfg.shift),
                               rho, freq, pml_cap=cfg.pml_cap, **aniso)
        op = prepare_operator(planes.detach(), pplanes, cfg,
                              with_transpose=True)
        x = solve_batched(op, b, cfg, planes=planes)
        loss = 0.5 * torch.sum(torch.abs(x[:, 0, rz, rx]) ** 2)
        torch.cuda.synchronize()
        t_fwd = time.perf_counter() - t0
        t0 = time.perf_counter()
        g, = torch.autograd.grad(loss, c)
        torch.cuda.synchronize()
        t_bwd = time.perf_counter() - t0
    if len(kr.iters) != 2:
        fail('%s: %d Krylov runs, not a forward and an adjoint'
             % (tag, len(kr.iters)))
    gnorm = float(torch.linalg.norm(g))
    runs = {label: {'iters': it, 'seconds': sec, 'relres': rr,
                    'ms_per_iter': 1e3 * sec / max(it, 1)}
            for label, it, sec, rr in zip(('forward', 'adjoint'), kr.iters,
                                          kr.seconds, kr.relres)}
    out = {'n': n, 'nsrc': nsrc, 'nrec': nrec, 'forward_s': t_fwd,
           'backward_s': t_bwd, 'loss': float(loss.detach()),
           'grad_norm': gnorm, 'runs': runs, 'peak_gb': peak_gb(),
           'backward_outside_gmres_s': t_bwd - kr.seconds[1]}
    say('%s TTI solve backward %d^2 eurus x %d src, %d receivers: forward '
        '(planes + prep + GMRES) %.3f s, backward %.3f s (%.3f s outside '
        'the adjoint GMRES); loss %.6e |grad| %.6e; peak %.2f GB (card %s)'
        % (tag, n, nsrc, nrec, t_fwd, t_bwd,
           out['backward_outside_gmres_s'], out['loss'], gnorm,
           out['peak_gb'], card))
    for label, row in runs.items():
        say('%s   %s GMRES(%d): %d iterations, %.3f s, %.2f ms an '
            'iteration, worst relres %.3e' % (
                tag, label, cfg.gmres_restart, row['iters'], row['seconds'],
                row['ms_per_iter'], row['relres']))
    if not (np.isfinite(gnorm) and gnorm > 0):
        fail('%s: |grad| %r' % (tag, gnorm))
    for label, row in runs.items():
        ok = (row['relres'] <= cfg.tol if opts is None
              else row['relres'] < 1.0)
        if not ok:
            fail('%s: the %s GMRES stopped at relres %.3e (tol %.0e)'
                 % (tag, label, row['relres'], cfg.tol))
    return out


def tti_pair(n, c, **kw):
    '''
    A paired Eurus Helm2DProblem and Helm2DSurvey on the card: the bench's
    `eurus` row's anisotropy and solver options (TTI_OPTS), one frequency
    1500/16, phase 7a's geometry.
    '''
    from zephyr_tpu_torch.backend import Eurus
    from zephyr_tpu_torch.middleware import Helm2DProblem, Helm2DSurvey
    aniso = {k: v * np.ones((n, n)) for k, v in TTI_ANISO.items()}
    return middleware_pair(Helm2DProblem, Helm2DSurvey, n, c,
                           [1500.0 / 16], Disc=Eurus, cPML=1e3,
                           solverOpts=dict(TTI_OPTS), **aniso, **kw)


def print_walls(tag, walls, card):
    for k, row in walls.items():
        say('%s   %s: wall %.3f s, peak %.2f GB (%.2f GB at its start), '
            'Krylov iterations %s, seconds %s, worst relres %.3e (card %s)'
            % (tag, k, row['wall_s'], row['peak_gb'], row['base_gb'],
               row['iters'], ['%.3f' % t for t in row['solve_s']],
               max(row['relres'] or [0.0]), card))


def tti_middleware(n, card, limit=1e-3):
    '''
    Phase 12b: the Eurus Helm2DProblem + Helm2DSurvey on the `eurus`
    row's model (n^2 hom, 16 sources, 64 receivers): survey.dpred(),
    Jvec, Jtvec (one adjoint GMRES run) and their dot test (within
    ``limit``), each call's wall, peak GB and Krylov iterations.
    '''
    problem, survey = tti_pair(n, 1500.0 * np.ones((n, n)))
    walls = {}
    d = timed('dpred', survey.dpred, walls)
    if not (d.shape == (survey.nD,) and np.isfinite(d).all()
            and np.abs(d).max() > 0):
        fail('12b dpred %d^2: shape %s, finite %s'
             % (n, d.shape, np.isfinite(d).all()))
    err = dot_test(problem, survey, n, 17, walls, 'eurus')
    out = {'n': n, 'nsrc': survey.nsrc, 'nrec': survey.nrec,
           'dot_test': err, 'walls': walls}
    say('12b Eurus problem %d^2, %d src x %d rec x 1 freq: dot test %.3e '
        '(limit %.0e)' % (n, survey.nsrc, survey.nrec, err, limit))
    print_walls('12b', walls, card)
    if not err <= limit:
        fail('12b: dot test %.3e > %.0e' % (err, limit))
    return out


def tti_misfit_gradient(n, card, limit=1e-3):
    '''
    Phase 12c: misfit_and_gradient of the Eurus problem at n^2 at a
    smoothed start model (Gaussian, 8 cells) against data dpred made at a
    perturbed model (1500 m/s plus a smooth seeded field of 60 m/s rms),
    held against Jtvec of the residual dpred(m0) - dobs (the same VJP).
    '''
    from scipy.ndimage import gaussian_filter
    c = 1500.0 + 60.0 * smooth_field(n, 21, width=32.0)
    problem, survey = tti_pair(n, c)
    walls = {}
    dobs = timed('dobs', survey.dpred, walls)
    m0 = gaussian_filter(c, 8.0)
    f, g = timed('misfit_and_gradient',
                 lambda: problem.misfit_and_gradient(m0, dobs), walls)
    r = timed('dpred(m0)', lambda: survey.dpred(m0), walls) - dobs
    jtr = timed('Jtvec(residual)', lambda: problem.Jtvec(m0, r), walls)
    gnorm = float(np.linalg.norm(g))
    diff = float(np.linalg.norm(g - jtr) / np.linalg.norm(jtr))
    out = {'n': n, 'misfit': f, 'grad_norm': gnorm,
           'rel_diff_vs_jtvec': diff, 'walls': walls}
    say('12c Eurus misfit_and_gradient at %d^2 (1 freq): misfit %.6e '
        '|grad| %.6e, against Jtvec(dpred(m0) - dobs) %.3e (limit %.0e)'
        % (n, f, gnorm, diff, limit))
    print_walls('12c', walls, card)
    if not (np.isfinite(f) and np.isfinite(g).all() and gnorm > 0):
        fail('12c: misfit %r, finite %s, |grad| %r'
             % (f, np.isfinite(g).all(), gnorm))
    if not diff <= limit:
        fail('12c: the gradient differs from Jtvec by %.3e' % diff)
    return out


def phase12(card):
    '''Phase 12's sub-phases at their sizes, by name, in order.'''
    return {'backward': lambda: tti_solve_backward(512, 16, 64, card),
            'middleware': lambda: tti_middleware(512, card),
            'misfit_gradient': lambda: tti_misfit_gradient(256, card)}


def phase11(card, nky=20):
    '''Phase 11's sub-phases at their sizes, by name, in order.'''
    return {'freqblock': lambda: freqblock(768, 16, 48, card),
            'gradient': lambda: multifreq_gradient(512, 4, 16, 64, card),
            'multiscale': lambda: multiscale(256, card),
            'oracle_25d': lambda: oracle_25d(card),
            'middleware_25d': lambda: middleware_25d(512, nky, card)}


# --- phase 13 ------------------------------------------------------------

#: phase 13a-b's solver options: the production config with one change
CONFIG_ROWS = {'2d': dict(PRODUCTION, fft_mode='2d'),
               'add': dict(PRODUCTION, hybrid_comp='add'),
               'iterative': dict(PRODUCTION, mg_coarse='iterative')}


def config_row(name, n, nsrc, card, phase5=None):
    '''
    Phase 13a-b: phase 5's homogeneous row (n^2 x nsrc point sources,
    warm-up then timed, relres <= 1e-5 and the oracle error < 1e-2) under
    ``CONFIG_ROWS[name]``. The iterative coarse solve's ms an iteration is
    printed beside phase 5's (``phase5``).
    '''
    row = headline(n, nsrc, 'hom', card, opts=CONFIG_ROWS[name],
                   label=name)[0]
    if name == 'iterative':
        base = None if phase5 is None else phase5['ms_per_iter']
        row['phase5_ms_per_iter'] = base
        say('13b iterative coarse solve: %.2f ms an iteration, phase 5 '
            '(dense inverse) %s (card %s)'
            % (row['ms_per_iter'], 'not run' if base is None
               else '%.2f ms' % base, card))
    return row


def slab_row(n, nsrc, card, overlap=16):
    '''
    Phase 13c: phase 5's n^2 hom row as one overlapped-Schwarz slab holds
    it (zephyr_tpu/parallel/spatial.py:290-319 for a single x-slab): the
    true and shifted planes grown by ``overlap`` mirrored columns a side
    (its ``_extend_overlap`` with edge='mirror'), prepared with the
    production config and the slab's closure mask (``slab_mask``: the
    mirror band and the global ring column) as interior_mask; phase 5's
    sources shifted by ``overlap``; a warm-up solve, then a timed one,
    which must reach tol.
    '''
    import torch
    from zephyr_tpu_torch.ops.minizephyr_coeff import minizephyr_planes
    from zephyr_tpu_torch.solver.helmholtz import (
        make_chunked_solver, prepare_operator, resolve_solver_config,
        shifted_velocity)
    cfg = resolve_solver_config(PRODUCTION, torch.complex64)
    freq = 1500.0 / 16

    def mirror(p):
        return torch.cat([p[..., :overlap].flip(-1), p,
                          p[..., -overlap:].flip(-1)], dim=-1).contiguous()

    reset_peak()
    t0 = time.perf_counter()
    c = torch.full((n, n), 1500.0, dtype=torch.complex64, device=DEV)
    rho = torch.ones((n, n), dtype=torch.float32, device=DEV)
    planes = mirror(minizephyr_planes(c, rho, freq)[None, None])
    pplanes = mirror(minizephyr_planes(shifted_velocity(c, cfg.shift), rho,
                                       freq, pml_cap=cfg.pml_cap)[None, None])
    nx = planes.shape[-1]
    mask = torch.as_tensor(slab_mask(n, nx, overlap), device=DEV)
    op = prepare_operator(planes, pplanes, cfg, with_transpose=False,
                          interior_mask=mask)
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    b = torch.nn.functional.pad(point_sources(n, nsrc),
                                (overlap, overlap)).contiguous()
    solver = make_chunked_solver(cfg, chunk=32)
    _, iters0, _ = solver(op, b)      # warm-up
    torch.cuda.synchronize()
    trace = []
    t0 = time.perf_counter()
    x, iters, relres = solver(op, b, trace=trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {'config': 'interior_mask', 'n': n, 'nx': nx, 'nsrc': nsrc,
           'overlap': overlap, 'iters': iters, 'relres': relres,
           'wall_s': wall, 'solves_per_s': nsrc / wall,
           'ms_per_iter': 1e3 * wall / max(iters, 1), 'prep_s': t_prep,
           'warmup_iters': iters0, 'peak_gb': peak_gb(),
           'trace': compact_trace(trace)}
    say('13c slab %dx%d (hom %d^2 + %d mirrored columns a side, closure '
        'mask) x %d src: iters %d  relres %.3e  wall %.3f s  %.3f solves/s'
        '  %.2f ms an iteration  (prep %.2f s; peak %.2f GB; card %s)'
        % (n, nx, n, overlap, nsrc, iters, relres, wall, nsrc / wall,
           out['ms_per_iter'], t_prep, out['peak_gb'], card))
    if not (np.isfinite(relres) and relres <= cfg.tol
            and bool(torch.isfinite(x).all())):
        fail('13c: relres %.3e > tol %.0e; chunk trace %s'
             % (relres, cfg.tol, trace))
    return out


def tti_2d(card, n=512, n_backward=256, max_chunks=8):
    '''
    Phase 13d: the `eurus` row (n^2 hom x 16, TTI_OPTS) with the 2x2
    block symbol solve (fft_mode='2d'), chunked and stopped after
    ``max_chunks`` chunks (finite and below its starting residual), then
    the backward of ``solve_batched`` at ``n_backward``^2 (GMRES capped
    at 200 iterations; a finite, non-zero gradient).
    '''
    opts = dict(TTI_OPTS, fft_mode='2d')
    row = tti_bench(n, 16, 'hom', card, warm=False, max_chunks=max_chunks,
                    opts=opts, label='2d')
    bwd = tti_solve_backward(n_backward, 16, 64, card,
                             opts=dict(opts, maxiter=200), tag='13d')
    return {'eurus_2d': row, 'backward_2d': bwd}


def write_mini_ini(path, nx, nz, freqs, srcs, recs):
    '''
    A minimal OMEGA-layout project ini (a copy of tests/test_io.py's
    ``_write_mini_ini``): grid, frequencies, sources and receivers as
    (x, z) pairs.
    '''

    def fmt_block(vals):
        lines = []
        for i in range(0, len(vals), 5):
            lines.append(' '.join('%0.6E' % v for v in vals[i:i + 5]))
        return lines

    lines = [
        '<comment><lessfiles>',
        '   0           F',
        '< nx >  < nz >  <    dx    >  <    dz    >  <  xorig   >  '
        '<  zorig   >',
        '   %d     %d      1.0000        1.0000        0.0000        0.0000'
        % (nx, nz),
        '<inv> <datain> <dataout> <waveout> <usescratch> <nom> <nsam> '
        '< tau > <nftout>',
        " F     'null '   'ftotl'        10  F              %d    100 "
        "999.999       0" % len(freqs),
        '<we> <param> <nky> <method> < vmin > <deltatt> <src> <wavscale> '
        '<aniso> < freqbase>',
        "'p '       2     1        1 2000.000    1.0000   1           F   "
        "0.0000  5.0000E+01",
        '<reduce>< redvel >< tbegin ><fst fsr fsb fsl><sponge><isufx>',
        ' F           0.000     0.000   F   F   F   F     F       0',
        '<   freq    >',
    ]
    lines += fmt_block(freqs)
    lines += ['<     ky    >'] + fmt_block([0.0])
    lines += ['<nslices>', '        0', '<slice> <source> <time>']
    lines += ['<ns> <isreg> <sspread> <useswt>',
              '  %d       4     0.500  F' % len(srcs),
              '<source>  <xs>         <zs>         <swght>']
    for i, (x, z) in enumerate(srcs):
        lines.append('  %d  %0.5E  %0.5E   1.000' % (i + 1, x, z))
    lines += ['<nr> <irreg> <rspread> <userwt>',
              '  %d       4     0.500  F' % len(recs),
              '<rec>  <xr>         <zr>         <rwght>']
    for i, (x, z) in enumerate(recs):
        lines.append('  %d  %0.5E  %0.5E   1.000' % (i + 1, x, z))
    lines += ['<ng> <igreg> <gspread> <usegwt>',
              '  0       4     0.500  F',
              '<geo>  <xg>         <zg>         <gwght>']
    lines += ['<sghost> <rghost> <gghost> <zgg>',
              ' F   F   F   0.0',
              '<zero1>',
              ' 0 0 0 0',
              ' 0 0 0 0']
    with open(path, 'w') as fp:
        fp.write('\n'.join(lines) + '\n')


def write_project(name, n, c_np, nsrc, nrec, freqs):
    '''
    An OMEGA project in the current directory: ``name``.ini (n x n cells
    of 1 m, ``freqs``, nsrc sources on the line z = n/16 and nrec
    receivers on z = 15n/16, both across the middle 3/4 in x), the
    velocity ``name``.vp and a unit density ``name``.rho (SEG-Y, one
    trace per x). Without a density file the datastore takes Gardner's
    310 c^0.25 (~1900), under which the default SolverConfig stalls in
    both packages (fault F9).
    '''
    from zephyr_tpu_torch.middleware.segy import writeSEGY
    xs = np.linspace(n / 8., 7. * n / 8., nsrc)
    xr = np.linspace(n / 8., 7. * n / 8., nrec)
    write_mini_ini('%s.ini' % name, n, n, freqs,
                   [(x, n / 16.) for x in xs],
                   [(x, 15. * n / 16.) for x in xr])
    writeSEGY('%s.vp' % name, np.ascontiguousarray(c_np.T), format=5)
    writeSEGY('%s.rho' % name, np.ones((n, n), np.float32), format=5)


class captured_data:
    '''
    Keep the data ForwardModelingJob.run returns inside the block (the
    method is replaced for the block's duration by one that calls
    through and keeps the result).
    '''

    def __enter__(self):
        from zephyr_tpu_torch.frontend import jobs
        self.saved = run = jobs.ForwardModelingJob.run
        self.data = []

        def keep(job):
            out = run(job)
            self.data.append(out)
            return out
        jobs.ForwardModelingJob.run = keep
        return self

    def __exit__(self, *exc):
        from zephyr_tpu_torch.frontend import jobs
        jobs.ForwardModelingJob.run = self.saved


def frontend_jobs(card, n=2048, n_small=256):
    '''
    Phase 13e: the port's CLI end to end on the card. An OMEGA project at
    n^2 (the 4-layer model, 2 frequencies at 16 and 8 cells per
    wavelength, 16 sources, 64 receivers) through ``cli.main(['model',
    ...])``, whose .utout file must read back equal to the data the job
    returned (1e-5 of the largest, its float32 storage); ``inspect``;
    then at n_small^2 observed data at a perturbed model, and
    ``migrate`` and ``invert --maxiter 1`` from the 4-layer start model,
    whose image must be finite and non-zero and whose model finite and
    moved from the start. Every Krylov run inside the jobs (the default
    SolverConfig: single BiCGStab runs to tol 1e-5, maxiter 500) must
    reach tol. The projects are written under build/ in the checkout.
    '''
    import torch
    from zephyr_tpu_torch.frontend import cli
    from zephyr_tpu_torch.middleware import SEGYFile, utoutRead
    from zephyr_tpu_torch.middleware.segy import writeSEGY
    freqs = [1500. / 16, 1500. / 8]
    where = os.path.join(HERE, 'build', 'chip_smoke_frontend')
    os.makedirs(where, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(where)
    out = {}
    try:
        write_project('big', n, layered_c(n), 16, 64, freqs)
        reset_peak()
        t0 = time.perf_counter()
        with captured_data() as cap, krylov_runs() as kr:
            rc = cli.main(['model', 'big', '--device', DEV])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_runs('model', kr)
        if rc != 0 or len(cap.data) != 1:
            fail('13e: model returned %r with %d data cubes'
                 % (rc, len(cap.data)))
        data = cap.data[0]
        _, back = utoutRead('big.utout', 64)
        scale = float(np.abs(data).max())
        err = float(np.abs(back - data).max()) / scale
        out['model'] = {'n': n, 'shape': list(data.shape), 'wall_s': wall,
                        'utout_err': err, 'peak_gb': peak_gb(),
                        'finite': bool(np.isfinite(data).all()),
                        'krylov_iters': kr.iters,
                        'krylov_relres': kr.relres}
        say('13e cli model %d^2 4-layer, 2 frequencies x 16 sources x 64 '
            'receivers: %.3f s, data %s, .utout read back within %.2e of '
            'the largest, peak %.2f GB (card %s)'
            % (n, wall, data.shape, err, out['model']['peak_gb'], card))
        if not (out['model']['finite'] and data.shape == (64, 16, 2)
                and err <= 1e-5 and scale > 0):
            fail('13e: model data %s finite %s, .utout error %.3e'
                 % (data.shape, out['model']['finite'], err))
        if cli.main(['inspect', 'big', '--device', DEV]) != 0:
            fail('13e: inspect failed')

        c_true = layered_c(n_small)
        c_true[n_small // 3:n_small // 2, n_small // 3:n_small // 2] -= 150.
        write_project('small', n_small, c_true, 8, 32, freqs)
        with captured_data() as cap, krylov_runs() as kr:
            cli.main(['model', 'small', '--device', DEV])
        check_runs('model (small)', kr)
        dobs = cap.data[0]
        for i, f in enumerate(freqs):
            panel = dobs[:, :, i]
            inter = np.empty((2 * panel.shape[1], panel.shape[0]))
            inter[0::2] = panel.T.real
            inter[1::2] = panel.T.imag
            writeSEGY('small.utobs%0.3f' % f, inter, format=5)
        writeSEGY('small.vp', np.ascontiguousarray(layered_c(n_small).T),
                  format=5)
        for cmd, fn in (('migrate', 'small1.gvp'), ('invert', 'small1.vp')):
            argv = [cmd, 'small', '--device', DEV]
            if cmd == 'invert':
                argv += ['--maxiter', '1']
            t0 = time.perf_counter()
            with krylov_runs() as kr:
                rc = cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check_runs(cmd, kr)
            arr = SEGYFile(fn)[:]
            amax = float(np.abs(arr).max())
            moved = float(np.abs(arr.T - layered_c(n_small)).max())
            out[cmd] = {'n': n_small, 'wall_s': wall, 'max_abs': amax,
                        'finite': bool(np.isfinite(arr).all()),
                        'krylov_runs': len(kr.iters),
                        'krylov_iters_max': max(kr.iters),
                        'moved_from_start': moved if cmd == 'invert'
                        else None}
            say('13e cli %s %d^2: %.3f s, %d Krylov runs (at most %d '
                'iterations), %s finite %s, max |.| %.6e%s (card %s)'
                % (cmd, n_small, wall, len(kr.iters), max(kr.iters), fn,
                   out[cmd]['finite'], amax,
                   ', moved %.3f m/s from the start' % moved
                   if cmd == 'invert' else '', card))
            if rc != 0 or not out[cmd]['finite'] or not amax > 0 \
                    or (cmd == 'invert' and not moved > 0):
                fail('13e: %s returned %r, %s finite %s max %r'
                     % (cmd, rc, fn, out[cmd]['finite'], amax))
    finally:
        os.chdir(cwd)
    return out


def check_runs(label, kr, tol=1e-5):
    '''13e: every Krylov run ``kr`` recorded reached ``tol``.'''
    worst = max(kr.relres) if kr.relres else float('nan')
    if not (kr.relres and worst <= tol):
        fail('13e %s: %d Krylov runs, worst relres %r > %.0e (iterations '
             '%s)' % (label, len(kr.relres), worst, tol, kr.iters))


def phase13(card, phase5=None):
    '''Phase 13's sub-phases at their sizes, by name, in order.'''
    rows = {name: (lambda name=name: config_row(name, 2048, 16, card,
                                                phase5))
            for name in CONFIG_ROWS}
    return dict(rows, interior_mask=lambda: slab_row(2048, 16, card),
                tti_2d=lambda: tti_2d(card),
                frontend=lambda: frontend_jobs(card))


# --- phase 14 ------------------------------------------------------------

#: the layered iteration count of phase 5 on the card (PERF.md section 6),
#: the base of 14a's bound when phase 5 did not run in the same process
PHASE5_LAYERED_ITERS = 71
#: phase 14's bounds: the sharded apply against the global one (relative
#: to the reference's largest magnitude), the DD solve's worst relres, its
#: distance from the global solve, its iterations against phase 5's, the
#: DD forward's data against the single-device forward, the sharded FWI
#: step's misfit and gradient against one device's (relative)
DD_APPLY_TOL = 1e-6
DD_RELRES = 1e-5
DD_SOLUTION_TOL = 1e-4
DD_ITERS_FACTOR = 2
#: the overlaps of 14a: 16 cells, one wavelength at 1500 m/s (the DD
#: solver's default), and 32, one wavelength in the 3000 m/s layer (the
#: JAX package's rule of ~1 wavelength, spatial.py:267); the iteration
#: bound is held at 32 (at 16 the 2048^2 layered row took 164 iterations,
#: 2.31x phase 5's, on an H100 80GB HBM3 at 700 W)
DD_OVERLAPS = (16, 32)
DD_ITERS_OVERLAP = 32
DD_DATA_TOL = 1e-4
STEP_MISFIT_TOL = 1e-4
STEP_GRAD_TOL = 1e-3
#: the kernels whose names the exported trace of 14d must hold (K1-K4)
TRACE_KERNELS = ('zt_apply_stencil_kernel', 'zt_presmooth_restrict_kernel',
                 'zt_pcr_sweep_kernel', 'zt_prolong_add_smooth_kernel')
#: the iterations of 14a's solve that 14d traces: a whole solve's trace is
#: ~600 MB of JSON (110 iterations, ~5 MB an iteration, CPU rehearsal)
TRACE_ITERS = 4


def virtual_mesh(kind):
    '''
    A virtual mesh of 4 coordinates on the card: '2x2' ('z', 'x') tiles
    or 'x4' x slabs, every coordinate ``cuda:0``.
    '''
    import torch
    from zephyr_tpu_torch.parallel.mesh import Mesh
    devs = np.empty(4, dtype=object)
    devs[:] = torch.device(DEV, 0)
    if kind == '2x2':
        return Mesh(devs.reshape(2, 2), ('z', 'x')), dict(axis_name='x',
                                                          axis_z='z')
    return Mesh(devs, ('x',)), dict(axis_name='x')


def layered_planes(n, cfg, freq=1500.0 / 16):
    '(true, CSLP-shifted) MiniZephyr planes of the n^2 4-layer model.'
    import torch
    from zephyr_tpu_torch.ops.minizephyr_coeff import minizephyr_planes
    from zephyr_tpu_torch.solver.helmholtz import shifted_velocity
    c = torch.as_tensor(layered_c(n), device=DEV).to(torch.complex64)
    rho = torch.ones((n, n), dtype=torch.float32, device=DEV)
    return (minizephyr_planes(c, rho, freq)[None, None].contiguous(),
            minizephyr_planes(shifted_velocity(c, cfg.shift), rho, freq,
                              pml_cap=cfg.pml_cap)[None, None].contiguous())


def sharded_apply_check(planes, nsrc, card):
    '''
    14a, first: ``make_sharded_apply`` (K1 on each halo-grown shard) on
    2x2 tiles and on 4 x slabs against the global ``apply_stencil_batched``
    (K1) and against the plain sharded apply (the JAX package's sum over
    the 9 offsets on the halo-grown blocks), at the phase's n^2 x nsrc.
    '''
    import torch
    from zephyr_tpu_torch.ops.stencil import apply_stencil_batched
    from zephyr_tpu_torch.parallel import spatial
    from zephyr_tpu_torch.parallel.mesh import Sharding
    n = planes.shape[-1]
    gen = torch.Generator(device=DEV)
    gen.manual_seed(14)
    u = torch.complex(torch.randn((nsrc, 1, n, n), generator=gen,
                                  device=DEV),
                      torch.randn((nsrc, 1, n, n), generator=gen,
                                  device=DEV))
    ref = apply_stencil_batched(planes[0, 0], u[:, 0])[:, None]
    out = {}
    for kind in ('2x2', 'x4'):
        mesh, kw = virtual_mesh(kind)
        az = kw.get('axis_z')
        got = spatial.make_sharded_apply(mesh, **kw)(planes, u)
        ps = Sharding(mesh, (None, None, None, az, 'x'))
        us = Sharding(mesh, (None, None, az, 'x'))
        plain = us.gather(spatial.apply_stencil_sharded(
            ps.split(planes), us.split(u), mesh, **kw))
        out[kind] = {'vs_global': rel_err(got, ref)[0],
                     'vs_plain': rel_err(got, plain)[0]}
        say('14a sharded apply %s %d^2 x %d: K1 on the halo-grown shards '
            'vs the global K1 %.3e, vs the plain sharded sum %.3e (limit '
            '%.0e of the reference max; card %s)'
            % (kind, n, nsrc, out[kind]['vs_global'], out[kind]['vs_plain'],
               DD_APPLY_TOL, card))
        if not (out[kind]['vs_global'] <= DD_APPLY_TOL
                and out[kind]['vs_plain'] <= DD_APPLY_TOL):
            fail('14a: the sharded apply on %s disagrees: %s'
                 % (kind, out[kind]))
        del got, plain
    del u, ref
    torch.cuda.empty_cache()
    return out


def dd_reference(n, nsrc, card):
    '''
    14a's reference: phase 5's production layered row on one device (the
    global operator, make_chunked_solver, chunk 32), its solution kept.
    Returns (planes, pplanes, b, x_ref, iterations, relres, config).
    '''
    import torch
    from zephyr_tpu_torch.solver.helmholtz import (
        make_chunked_solver, prepare_operator, resolve_solver_config)
    cfg = resolve_solver_config(PRODUCTION, torch.complex64)
    planes, pplanes = layered_planes(n, cfg)
    op = prepare_operator(planes, pplanes, cfg, with_transpose=False)
    b = point_sources(n, nsrc)
    x_ref, iters, relres = make_chunked_solver(cfg, chunk=32)(op, b)
    torch.cuda.synchronize()
    say('14a reference: global layered %d^2 x %d, chunked: iters %d  '
        'relres %.3e (card %s)' % (n, nsrc, iters, relres, card))
    del op
    return planes, pplanes, b, x_ref, iters, relres, cfg


def true_relres(planes, x, b):
    'max over the RHS of ||b - A x|| / ||b||, A applied globally (K1).'
    import torch
    from zephyr_tpu_torch.ops.stencil import apply_block_stencil_fast
    r = b - apply_block_stencil_fast(planes, x)
    num = torch.linalg.vector_norm(r.reshape(r.shape[0], -1), dim=1)
    den = torch.linalg.vector_norm(b.reshape(b.shape[0], -1), dim=1)
    return float(torch.max(num / den))


def dd_solve(ref, card, base_iters, overlap=16, trace=False):
    '''
    14a: ``make_dd_solver`` on a virtual 2x2 ('z', 'x') mesh over the
    card, 1024^2 shards grown by ``overlap`` a side, a warm-up call and a
    timed one (each splits the grid, prepares the shards' operators,
    solves and gathers); relres <= DD_RELRES, the solution within
    DD_SOLUTION_TOL of the global one, and at overlap DD_ITERS_OVERLAP
    iterations <= DD_ITERS_FACTOR x phase 5's layered count (printed at
    every overlap). The shards' operators (``DDOperator``) are then built
    once more alone and timed: the solve's ms an iteration is the timed
    call's wall less that preparation; on it the JAX package's single
    BiCGStab run (``restarts=0``) runs uncounted, to show what the
    true-residual restarts add. With ``trace`` (14d) the first
    TRACE_ITERS iterations of the solve run once more on that operator
    under ``utils.trace()`` and ``annotate('dd_solve')``, the sharded
    BiCGStab wrapped in ``timeIt``; the exported Chrome trace must name
    the annotation and K1-K4, and ``stats()`` the wrapped call. The
    global checks of the solution run uncounted.
    '''
    import tempfile
    import torch
    from zephyr_tpu_torch import utils
    from zephyr_tpu_torch.parallel.spatial import (DDOperator,
                                                   _grid_sharding,
                                                   make_dd_solver,
                                                   sharded_bicgstab)
    planes, pplanes, b, x_ref, _, _, cfg = ref
    n, nsrc = planes.shape[-1], b.shape[0]
    mesh, kw = virtual_mesh('2x2')
    solver = make_dd_solver(mesh, cfg, overlap=overlap, **kw)
    reset_peak()
    t0 = time.perf_counter()
    _, iters0, _ = solver(planes, pplanes, b)            # warm-up
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, iters, relres = solver(planes, pplanes, b)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = peak_gb()
    t0 = time.perf_counter()
    op = DDOperator(_grid_sharding(mesh, 5, 'x', 'z').split(planes),
                    _grid_sharding(mesh, 5, 'x', 'z').split(pplanes), cfg,
                    mesh, 'x', 'z', overlap)
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    b_sh = _grid_sharding(mesh, 4, 'x', 'z').split(b)
    with uncounted():
        rr_true = true_relres(planes, x, b)
        _, iters1, rr1 = op.solve(b_sh, restarts=0)
        sol = float(torch.linalg.vector_norm(x - x_ref)
                    / torch.linalg.vector_norm(x_ref))
    shard = tuple(op.apply.planes[(0, 0)].shape[-2:])
    grow = overlap if min(shard) >= 4 * overlap else 0
    solve_s = wall - t_prep
    out = {'n': n, 'nsrc': nsrc, 'mesh': mesh.shape, 'overlap': overlap,
           'shard': shard, 'grown': (shard[0] + 2 * grow,
                                     shard[1] + 2 * grow),
           'iters': iters, 'warmup_iters': iters0, 'relres': relres,
           'global_relres': rr_true, 'solution_rel': sol,
           'warmup_s': t_warm, 'wall_s': wall, 'prep_s': t_prep,
           'solve_s': solve_s, 'solves_per_s': nsrc / wall,
           'ms_per_iter': 1e3 * solve_s / max(iters, 1), 'peak_gb': peak,
           'phase5_iters': base_iters, 'single_run_iters': iters1,
           'single_run_relres': rr1}
    say('14a make_dd_solver layered %d^2 x %d on %s (overlap %d, shards %s '
        'grown to %s): iters %d (warm-up %d; phase 5 %d)  relres %.3e '
        '(globally %.3e)  vs global %.3e  wall %.3f s (warm-up %.3f s)  '
        '%.3f solves/s  prep alone %.3f s  %.2f ms an iteration  (peak '
        '%.2f GB; card %s)'
        % (n, nsrc, mesh.shape, overlap, shard, out['grown'], iters, iters0,
           base_iters, relres, rr_true, sol, wall, t_warm,
           out['solves_per_s'], t_prep, out['ms_per_iter'], peak, card))
    say('14a overlap %d: the JAX package\'s single BiCGStab run '
        '(restarts=0) %d iterations, true relres %.3e; the true-residual '
        'restarts %d iterations' % (overlap, iters1, rr1, iters - iters1))
    if not (np.isfinite(relres) and relres <= DD_RELRES
            and rr_true <= DD_RELRES):
        fail('14a: relres %.3e, global relres %.3e > %.0e'
             % (relres, rr_true, DD_RELRES))
    if not sol <= DD_SOLUTION_TOL:
        fail('14a: DD solution %.3e from the global one > %.0e'
             % (sol, DD_SOLUTION_TOL))
    out['iters_ratio'] = iters / base_iters
    say('14a overlap %d: %d iterations, %.2fx phase 5\'s %d (bound %dx %s)'
        % (overlap, iters, out['iters_ratio'], base_iters, DD_ITERS_FACTOR,
           'held here' if overlap == DD_ITERS_OVERLAP
           else 'held at overlap %d' % DD_ITERS_OVERLAP))
    if (overlap == DD_ITERS_OVERLAP
            and not iters <= DD_ITERS_FACTOR * base_iters):
        fail('14a: %d DD iterations > %d x phase 5\'s %d'
             % (iters, DD_ITERS_FACTOR, base_iters))
    del x
    if trace:
        solve = utils.timeIt(sharded_bicgstab)
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            with utils.trace(tmp):
                with utils.annotate('dd_solve'):
                    _, it_t, _ = solve(op.apply, b_sh, op.M, mesh,
                                       tol=cfg.tol, maxiter=TRACE_ITERS)
                    torch.cuda.synchronize()
            t_trace = time.perf_counter() - t0
            files = [os.path.join(tmp, f) for f in os.listdir(tmp)
                     if f.endswith('.pt.trace.json')]
            if len(files) != 1:
                fail('14d: trace() wrote %s' % os.listdir(tmp))
            size = os.path.getsize(files[0])
            with open(files[0]) as fh:
                names = {e.get('name', '') for e in
                         json.load(fh).get('traceEvents', [])}
        found = {k: any(k in nm for nm in names) for k in TRACE_KERNELS}
        st = [v for k, v in utils.stats().items()
              if k.endswith('sharded_bicgstab')]
        out['trace'] = {'seconds': t_trace, 'iters': it_t,
                        'bytes': size, 'annotation': 'dd_solve' in names,
                        'kernels': found,
                        'timeit_calls': st[0]['calls'] if st else 0}
        say('14d trace of the DD solve\'s first %d iterations: %.2f s '
            '(untraced %.2f ms an iteration), %d bytes; annotation %s; '
            'kernels %s; timeIt %s (card %s)'
            % (it_t, t_trace, out['ms_per_iter'], size, 'dd_solve' in names,
               found, st, card))
        if not ('dd_solve' in names and all(found.values()) and st):
            fail('14d: the trace lacks the annotation or a kernel, or '
                 'stats() the call: %s' % out['trace'])
    return out


def dd_dpred(n, nsrc, nrec, nfreq, card):
    '''
    14b: ``make_dd_dpred`` at n^2 layered on the 2x2 mesh (overlap 16),
    the top nfreq of phase 7a's eight frequencies (0.6-1.0 x 1500/16),
    phase 5's nsrc point sources, nrec Kaiser receivers on phase 7a's
    line, production config; against the single-device
    ``multifreq_dpred_chunked`` on the same inputs, run uncounted
    (relative data error <= DD_DATA_TOL, every relres of both <=
    DD_RELRES). Phase 7a runs
    each frequency on its own targetGPW grid; on the one 2048^2 grid its
    lowest frequency, 56.25 Hz (27 cells a wavelength), does not converge
    in complex64 on either path: the single-device chunked solve stops at
    8.8e-4 (fault F7) and the DD run stalls (F10;
    ``tools/probe_port_dd.py``), so the reference would not be one.
    '''
    import torch
    from zephyr_tpu_torch.parallel import multifreq_dpred_chunked
    from zephyr_tpu_torch.parallel.multifreq import _kaiser_stamps
    from zephyr_tpu_torch.parallel.spatial import make_dd_dpred
    from zephyr_tpu_torch.solver.helmholtz import resolve_solver_config
    cfg = resolve_solver_config(PRODUCTION, torch.complex64)
    freqs = np.linspace(0.6, 1.0, 8)[8 - nfreq:] * (1500.0 / 16)
    c = layered_c(n).astype(np.complex64)
    rho = np.ones((n, n), np.float32)
    q = np.repeat(point_sources(n, nsrc)[:, 0].cpu().numpy()[None],
                  nfreq, axis=0)
    rec_pos = np.stack([np.linspace(n // 8, 7 * n // 8, nrec),
                        np.full(nrec, float(n // 8))], axis=1)
    rcols, rvals = _kaiser_stamps((n, n), 1.0, 1.0, rec_pos, 4,
                                  receiver=True)
    R = np.zeros((nrec, n * n), np.complex64)
    np.add.at(R, (np.arange(nrec)[:, None], rcols), rvals)
    stats = {}
    t0 = time.perf_counter()
    with uncounted():
        d_ref = multifreq_dpred_chunked(c, rho, freqs, q, R, config=cfg,
                                        chunk=32, device=DEV, stats=stats)
        torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    ref = {'wall_s': t_ref, 'iters': stats['iters'],
           'relres': stats['relres']}
    mesh, kw = virtual_mesh('2x2')
    dpred = make_dd_dpred(mesh, freqs, cfg, overlap=16, **kw)
    reset_peak()
    t0 = time.perf_counter()
    d, info = dpred(c, rho, q, R.reshape(nrec, n, n))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    d = d.cpu().numpy()
    err = float(np.linalg.norm(d - d_ref) / np.linalg.norm(d_ref))
    out = {'n': n, 'freqs': list(freqs), 'nsrc': nsrc, 'nrec': nrec,
           'info': info, 'wall_s': wall, 'data_rel': err,
           'peak_gb': peak_gb(), 'reference': ref}
    say('14b DD dpred layered %d^2, %s Hz x %d src x %d rec on %s: '
        '(iters, relres) per freq %s  wall %.2f s  data vs single device '
        '%.3e (limit %.0e)  peak %.2f GB; single device %.2f s, iters %s, '
        'relres %s (card %s)'
        % (n, ['%.2f' % f for f in freqs], nsrc, nrec, mesh.shape, info,
           wall, err, DD_DATA_TOL, out['peak_gb'], t_ref, stats['iters'],
           ['%.3e' % r for r in stats['relres']], card))
    if not (np.isfinite(d).all() and d.shape == (nfreq, nsrc, nrec)):
        fail('14b: data of shape %s, finite %s' % (d.shape,
                                                   np.isfinite(d).all()))
    if not (err <= DD_DATA_TOL
            and all(rr <= DD_RELRES for _, rr in info)
            and all(rr <= DD_RELRES for rr in stats['relres'])):
        fail('14b: data error %.3e, relres %s, single device %s'
             % (err, info, stats['relres']))
    return out


def sharded_step_reference(n, nfreq, nsrc, nrec, card):
    '''
    14c's inputs and reference: the bench's ``gradient_marmousi`` size
    (n^2 Marmousi, nfreq frequencies, nsrc Kaiser sources, nrec receivers,
    phase 7a's geometry, zero observed data), the production config with
    the auto x-panel rule; the misfit and its gradient w.r.t. c by
    ``fwi_misfit`` and ``torch.autograd.grad`` on one device.
    '''
    import torch
    from zephyr_tpu_torch.parallel import fwi_misfit
    from zephyr_tpu_torch.solver.helmholtz import SolverConfig, resolve_panels
    c = marmousi_c(n).astype(np.float64)
    cfg = resolve_panels(SolverConfig(**PRODUCTION), c)
    freqs = np.linspace(0.6, 1.0, nfreq) * (1500.0 / 16)
    rng = np.random.default_rng(2)
    src_pos = rng.integers(n // 8, 7 * n // 8,
                           size=(nsrc, 2)).astype(np.float64)
    rec_pos = np.stack([np.linspace(n // 8, 7 * n // 8, nrec),
                        np.full(nrec, float(n // 8))], axis=1)
    q, R = kaiser_q_R(n, nfreq, src_pos, rec_pos)
    dobs = np.zeros((nfreq, nsrc, nrec), np.complex64)
    rho = np.ones((n, n), np.float32)
    inputs = dict(c=c, rho=rho, freqs=freqs, q=q, R=R, dobs=dobs, cfg=cfg)
    reset_peak()
    t0 = time.perf_counter()
    ct = torch.as_tensor(c, dtype=torch.float32, device=DEV)
    ct.requires_grad_(True)
    m = fwi_misfit(ct, dobs, rho, freqs, q, R, config=cfg, device=DEV)
    g, = torch.autograd.grad(m, ct)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ref = {'misfit': float(m.detach()), 'grad': g, 'wall_s': wall,
           'peak_gb': peak_gb(), 'panels': cfg.strat_panels}
    say('14c reference: fwi_misfit + autograd on one device, %d^2 '
        'marmousi (%d panels), %d freq x %d src x %d rec: misfit %.6e  '
        '|grad| %.6e  wall %.2f s  peak %.2f GB (card %s)'
        % (n, cfg.strat_panels, nfreq, nsrc, nrec, ref['misfit'],
           float(torch.linalg.vector_norm(g)), wall, ref['peak_gb'], card))
    return inputs, ref


def sharded_step(inputs, ref, card, freq=4, src=2):
    '''
    14c: ``make_sharded_fwi_step`` on a virtual (freq, src) mesh over the
    card, one step (lr 0), against the one-device reference: misfit
    within STEP_MISFIT_TOL, gradient within STEP_GRAD_TOL (relative
    2-norm). Returns (numbers, (c_next, misfit, grad)).
    '''
    import torch
    from zephyr_tpu_torch.parallel import make_mesh, make_sharded_fwi_step
    mesh = make_mesh(freq=freq, src=src,
                     devices=[torch.device(DEV, 0)] * (freq * src))
    step = make_sharded_fwi_step(mesh, inputs['rho'], inputs['freqs'],
                                 inputs['q'], inputs['R'], inputs['dobs'],
                                 lr=0.0, config=inputs['cfg'])
    c = torch.as_tensor(inputs['c'], dtype=torch.float32, device=DEV)
    reset_peak()
    t0 = time.perf_counter()
    c1, misfit, grad = step(c)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m_rel = abs(float(misfit) - ref['misfit']) / abs(ref['misfit'])
    g_rel = float(torch.linalg.vector_norm(grad - ref['grad'])
                  / torch.linalg.vector_norm(ref['grad']))
    n = c.shape[-1]
    out = {'n': n, 'mesh': mesh.shape, 'nfreq': len(inputs['freqs']),
           'nsrc': inputs['q'].shape[1], 'misfit': float(misfit),
           'misfit_rel': m_rel, 'grad_rel': g_rel, 'wall_s': wall,
           'peak_gb': peak_gb(), 'reference_wall_s': ref['wall_s']}
    say('14c sharded FWI step %d^2 marmousi on %s: misfit %.6e (rel %.3e, '
        'limit %.0e)  grad rel %.3e (limit %.0e)  wall %.2f s (one device '
        '%.2f s)  peak %.2f GB (card %s)'
        % (n, mesh.shape, float(misfit), m_rel, STEP_MISFIT_TOL, g_rel,
           STEP_GRAD_TOL, wall, ref['wall_s'], out['peak_gb'], card))
    if not (bool(torch.isfinite(grad).all()) and m_rel <= STEP_MISFIT_TOL
            and g_rel <= STEP_GRAD_TOL):
        fail('14c: misfit rel %.3e, gradient rel %.3e' % (m_rel, g_rel))
    return out, (c1, misfit, grad)


def checkpoint_roundtrip(state, card):
    '''
    14d: InversionCheckpointer saves 14c's (c_next, misfit, grad) to a
    temporary directory and restores them bit for bit (as CPU tensors).
    '''
    import tempfile
    import torch
    from zephyr_tpu_torch.utils import InversionCheckpointer
    names = ('c_next', 'misfit', 'grad')
    with tempfile.TemporaryDirectory() as tmp:
        ck = InversionCheckpointer(tmp)
        t0 = time.perf_counter()
        ck.save(1, dict(zip(names, state)))
        step, back = ck.restore()
        secs = time.perf_counter() - t0
    same = {k: bool(torch.equal(back[k], v.detach().cpu()))
            for k, v in zip(names, state)}
    say('14d checkpoint of 14c\'s state: step %s, bit for bit %s, %.2f s '
        '(card %s)' % (step, same, secs, card))
    if not (step == 1 and all(same.values())):
        fail('14d: the checkpoint did not restore bit for bit: %s' % same)
    return {'step': step, 'bit_for_bit': same, 'seconds': secs}


def entry_dryrun(card):
    '''
    14d: ``zephyr_tpu_torch.entry``: ``entry()``'s forward step on the
    card (finite data of shape (2, 2, 3)) and ``dryrun_multichip(4)`` on
    a virtual mesh of the card, within its bounds.
    '''
    import torch
    from zephyr_tpu_torch import entry
    t0 = time.perf_counter()
    fn, args = entry.entry()
    d = fn(*args)
    torch.cuda.synchronize()
    if not (tuple(d.shape) == (2, 2, 3) and bool(torch.isfinite(d).all())):
        fail('14d: entry() gave %s' % (d,))
    t_entry = time.perf_counter() - t0
    t0 = time.perf_counter()
    dry = entry.dryrun_multichip(4)
    t_dry = time.perf_counter() - t0
    say('14d entry() %.2f s; dryrun_multichip(4) %.2f s: %s (card %s)'
        % (t_entry, t_dry, json.dumps(dry), card))
    return {'entry_s': t_entry, 'dryrun_s': t_dry, 'dryrun': dry}


def phase14(card, layered_iters=None):
    '''
    Phase 14 (the scale-out layer) at its sizes: returns (results, the
    kernel launches over the spatial path: 14a-c and the traced solve;
    the references, the sharded-apply checks, 14a's global checks and
    its single-run comparison left out).
    '''
    import torch
    from zephyr_tpu_torch.ops import cuda_kernels as ck
    base = layered_iters or PHASE5_LAYERED_ITERS
    t14 = time.perf_counter()
    ref = dd_reference(2048, 16, card)
    out = {'reference_iters': ref[4], 'reference_relres': ref[5],
           'apply': sharded_apply_check(ref[0], 16, card)}
    step_in, step_ref = sharded_step_reference(512, 8, 16, 64, card)
    torch.cuda.synchronize()
    ck.reset_launches()
    out['dd_solve'] = {ov: dd_solve(ref, card, base, overlap=ov,
                                    trace=ov == DD_OVERLAPS[0])
                       for ov in DD_OVERLAPS}
    del ref
    torch.cuda.empty_cache()
    out['dd_dpred'] = dd_dpred(2048, 16, 64, 2, card)
    out['fwi_step'], state = sharded_step(step_in, step_ref, card)
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    out['k1_copies'] = ck.COPIES['apply_stencil']
    say('phase 14: K1 calls whose operands were copied: %d'
        % out['k1_copies'])
    if out['k1_copies']:
        fail('phase 14: %d K1 calls copied their operands'
             % out['k1_copies'])
    out['checkpoint'] = checkpoint_roundtrip(state, card)
    del state, step_in, step_ref
    torch.cuda.empty_cache()
    out['entry'] = entry_dryrun(card)
    out['seconds'] = time.perf_counter() - t14
    say('phase 14: %.1f s' % out['seconds'])
    return out, launches


#: the kernels each main path must launch (phase 6)
SCALAR_PATH = ('apply_stencil', 'presmooth_restrict', 'pcr_sweep',
               'prolong_add_smooth', 'jacobi_sweep', 'restrict', 'prolong')
TTI_PATH = ('apply_block_stencil', 'restrict', 'prolong')
MARMOUSI_PATH = ('apply_stencil', 'presmooth_restrict', 'pcr_sweep',
                 'prolong_add_smooth', 'jacobi_sweep', 'jacobi_sweep2',
                 'jacobi_sweep2_zero', 'restrict', 'prolong',
                 'presmooth_residual')
MIDDLEWARE_PATH = ('apply_stencil', 'presmooth_restrict', 'pcr_sweep',
                   'prolong_add_smooth', 'restrict', 'prolong')
MULTIFREQ_PATH = MIDDLEWARE_PATH
TTI_GRADIENT_PATH = TTI_PATH
CONFIGS_PATH = ('apply_stencil', 'presmooth_restrict', 'prolong_add_smooth',
                'restrict', 'prolong')
CONFIGS_TTI_PATH = ('apply_block_stencil',)
FRONTEND_PATH = ('apply_stencil', 'presmooth_restrict', 'pcr_sweep',
                 'prolong_add_smooth', 'jacobi_sweep')
SPATIAL_PATH = ('apply_stencil', 'presmooth_restrict', 'pcr_sweep',
                'prolong_add_smooth')


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
    for regs, st, ld in ptxas_of(so.with_suffix('.log').read_text(),
                                 'zt_presmooth_residual').values():
        say('K9 ptxas: %s registers, spill %d B stores / %d B loads'
            % (regs, st, ld))

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
    # the layered row stalls on the card (fault F4: at 3.78e-2 from its
    # sixth chunk on), so it runs once, after the hom row has warmed
    # every code path, and stops after 20 chunks (320 iterations; the
    # full 2000 took 88 s)
    tti = {'oracle': [eurus_oracle((0., 0.)), eurus_oracle((0.2, 0.2))],
           'eurus': tti_bench(512, 16, 'hom', card),
           'eurus_layered': tti_bench(256, 16, 'layered', card, warm=False,
                                      max_chunks=20),
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
    ck.reset_launches()
    mw = {'marmousi': middleware_marmousi(2048, card),
          'gradient': middleware_gradient(512, card),
          'visco': middleware_visco(512, card)}
    torch.cuda.synchronize()
    launches['middleware'] = dict(ck.LAUNCHES)
    ck.reset_launches()
    mf = {name: run() for name, run in phase11(card).items()}
    torch.cuda.synchronize()
    launches['multifreq'] = dict(ck.LAUNCHES)
    ck.reset_launches()
    tg = {name: run() for name, run in phase12(card).items()}
    torch.cuda.synchronize()
    launches['tti_gradient'] = dict(ck.LAUNCHES)
    tg['k8_copies'] = ck.COPIES['apply_block_stencil']
    say('phase 12: K8 calls whose operands were copied: %d'
        % tg['k8_copies'])
    if tg['k8_copies']:
        fail('phase 12: %d K8 calls copied their operands'
             % tg['k8_copies'])
    # phase 13: 13a-c, 13d and 13e, each with its own counts
    t13 = time.perf_counter()
    p13 = phase13(card, runs[0])
    ck.reset_launches()
    cf = {name: p13[name]() for name in list(CONFIG_ROWS)
          + ['interior_mask']}
    torch.cuda.synchronize()
    launches['configs'] = dict(ck.LAUNCHES)
    ck.reset_launches()
    cf['tti_2d'] = p13['tti_2d']()
    torch.cuda.synchronize()
    launches['configs_tti'] = dict(ck.LAUNCHES)
    ck.reset_launches()
    cf['frontend'] = p13['frontend']()
    torch.cuda.synchronize()
    launches['frontend'] = dict(ck.LAUNCHES)
    cf['seconds'] = time.perf_counter() - t13
    say('phase 13: %.1f s' % cf['seconds'])
    # phase 14: the scale-out layer, with its own counts
    sp, launches['spatial'] = phase14(card, runs[1]['iters'])

    # phase 6
    for path, names in (('scalar', SCALAR_PATH), ('tti', TTI_PATH),
                        ('marmousi', MARMOUSI_PATH),
                        ('middleware', MIDDLEWARE_PATH),
                        ('multifreq', MULTIFREQ_PATH),
                        ('tti_gradient', TTI_GRADIENT_PATH),
                        ('configs', CONFIGS_PATH),
                        ('configs_tti', CONFIGS_TTI_PATH),
                        ('frontend', FRONTEND_PATH),
                        ('spatial', SPATIAL_PATH)):
        say('launches over the %s path: %s'
            % (path, json.dumps(launches[path])))
        for name in names:
            if launches[path][name] == 0:
                fail('kernel %s was never launched on the %s path'
                     % (name, path))
    for key in sorted(k for k in kres if k not in KERNELS):
        say('%s: %s' % (key, json.dumps(kres[key])))
    # K6 per nu 3/3 iteration and K8 per eurus GMRES iteration: the
    # launches per iteration at each level times its phase-3 time
    for label, row in (('K6 per marmousi nu 3/3 iteration',
                        marm['marmousi_nu33']),
                       ('K8 per eurus GMRES iteration', tti['eurus'])):
        ms, untimed = per_iteration_ms(row['launches_by_level'], kres)
        row['kernel_ms_per_iter'] = ms
        say('%s: %s ms (of %.2f ms an iteration; levels not timed in phase '
            '3: %s)' % (label, json.dumps(ms), row['ms_per_iter'],
                        untimed or 'none'))
    say(json.dumps({'runs': runs, 'card': card}))
    say(json.dumps({'gradients': grads, 'card': card}))
    say(json.dumps({'tti': tti, 'card': card}))
    say(json.dumps({'marmousi': marm, 'card': card}))
    say(json.dumps({'middleware': mw, 'card': card}))
    say(json.dumps({'multifreq': mf, 'card': card}))
    say(json.dumps({'tti_gradient': tg, 'card': card}))
    say(json.dumps({'configs': cf, 'card': card}))
    say(json.dumps({'spatial': sp, 'card': card}))

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
