#!/usr/bin/env python3
'''
Where a TTI GMRES iteration of zephyr_tpu_torch spends its device time,
on one CUDA GPU:

    python3 tools/profile_port_tti.py [--n 512] [--medium hom|layered]

It prepares the operator and sources of chip_smoke.py phase 8b/8c
(imported from there: the bench's ``eurus`` row, n^2, 16 point sources,
theta 0.3, eps 0.2, delta 0.1, freq 1500/16, the production config with
gmres_restart=20, mg_nu1=mg_nu2=1; ``--medium layered`` for the 4-layer
model of ``eurus_layered``), runs one warm-up chunk, then

1. times the components of one preconditioner application with CUDA
   events (the block PCR sweeps of the line smoother and of the
   stratified solve, the whole V-cycle, the 'mult' preconditioner, one
   K8 apply, one GMRES cycle of 16 steps);
2. times one 16-step GMRES chunk (host clock, synchronised), profiles
   another with torch.profiler and prints the device time by kernel
   family and the idle share (1 - device time / unprofiled wall).

Prints the card's name and power limit first and one JSON line last.
'''

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import (TTI_OPTS, layered_c, tti_planes,  # noqa: E402
                        tti_sources)
from zephyr_tpu_torch.ops.stencil import apply_block_stencil_fast  # noqa
from zephyr_tpu_torch.solver import helmholtz as th  # noqa: E402
from zephyr_tpu_torch.solver import multigrid as tmg  # noqa: E402
from zephyr_tpu_torch.solver import stratified as tsr  # noqa: E402
from zephyr_tpu_torch.solver.krylov import gmres_cycle  # noqa: E402

FAMILIES = (('K1 apply_stencil', ('zt_apply_stencil',)),
            ('K2 presmooth_restrict', ('zt_presmooth_restrict',)),
            ('K3 pcr_sweep', ('zt_pcr_sweep',)),
            ('K4 prolong_add_smooth', ('zt_prolong_add_smooth',)),
            ('K5 jacobi_sweep', ('zt_jacobi_sweep_kernel',)),
            ('K6 jacobi_sweep2', ('zt_jacobi_sweep2',)),
            ('K8 apply_block_stencil', ('zt_apply_block_stencil',)),
            ('K9 presmooth_residual', ('zt_presmooth_residual',)),
            ('K7 restrict/prolong', ('zt_restrict', 'zt_prolong')),
            ('cuFFT', ('fft', 'FFT', 'regular_fft', 'vector_fft')),
            ('matmul (cuBLAS)', ('gemm', 'gemv', 'Gemm', 'dot_kernel')),
            ('reductions', ('reduce_kernel', 'Reduce')),
            ('copies/fills', ('copy', 'Memcpy', 'Memset', 'fill')),
            ('torch elementwise', ('elementwise', 'vectorized')))


def cuda_ms(fn, reps=5):
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


def family(name):
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return 'other'


def profile_chunk(run, what):
    '''
    Time ``run`` (host clock, synchronised), then profile another call
    with torch.profiler; print the device time by kernel family, the
    largest kernels and the idle share (1 - device time / unprofiled
    wall). Returns (wall, profiled wall, device ms, {family: ms}).
    '''
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_off = time.perf_counter() - t0

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fams = {}
    top = []
    for ev in prof.key_averages():
        # kernels only: an aten op's device time is that of its kernels
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(ev, 'self_device_time_total',
                    getattr(ev, 'self_cuda_time_total', 0)) / 1e3
        if t <= 0:
            continue
        fams[family(ev.key)] = fams.get(family(ev.key), 0.0) + t
        top.append((t, ev.key[:90], ev.count))
    device = sum(fams.values())
    print('%s: wall %.3f s (profiler off), %.3f s (profiler on); device '
          '%.3f s; idle %.1f%% of the unprofiled wall'
          % (what, wall_off, wall, device / 1e3,
             100 * (1 - device / 1e3 / wall_off)), flush=True)
    for fam, t in sorted(fams.items(), key=lambda kv: -kv[1]):
        print('  %-24s %9.3f ms  %5.1f%%' % (fam, t, 100 * t / device))
    for t, key, cnt in sorted(top, reverse=True)[:12]:
        print('    %9.3f ms  %6d x  %s' % (t, cnt, key))
    print('kernel launches in the run: %d' % sum(c for _, _, c in top))
    return wall_off, wall, device, fams


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--n', type=int, default=512)
    ap.add_argument('--medium', default='hom', choices=('hom', 'layered'))
    ap.add_argument('--nsrc', type=int, default=16)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('profile_port_tti: no CUDA device', file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    n = args.n
    cfg = th.SolverConfig(**TTI_OPTS)
    c_np = layered_c(n) if args.medium == 'layered' else None
    planes, pplanes = tti_planes(n, n, c_np, cfg.shift, cfg.pml_cap)
    op = th.prepare_operator(planes, pplanes, cfg, with_transpose=False)
    b = tti_sources(n, args.nsrc)
    solver = th.make_chunked_solver(cfg, chunk=16)
    solver(op, b, max_chunks=1)

    M = th._make_precond(op, cfg)
    lvl0 = op.hier.levels[0]
    r = b / torch.linalg.vector_norm(b)

    def v_cycle():
        return tmg.v_cycle(op.hier, r, omega=cfg.mg_omega, nu1=1, nu2=1)

    def mv(x):
        return apply_block_stencil_fast(op.planes, x)

    comps = {
        'block PCR sweep, z lines (level 0)':
            cuda_ms(lambda: tsr.pcr_apply_block(lvl0.linez, r)),
        'block PCR sweep, x lines (level 0, transposed view)':
            cuda_ms(lambda: tsr.pcr_apply_block(lvl0.linex,
                                                r.transpose(-1, -2))),
        'stratified block solve P (FFT + PCR + iFFT)':
            cuda_ms(lambda: tsr.stratified_apply_block(op.strat, r)),
        'V-cycle (4 smoothed levels)': cuda_ms(v_cycle),
        "preconditioner M ('mult': P, K8 residual, V-cycle)":
            cuda_ms(lambda: M(r)),
        'K8 apply (one matvec)': cuda_ms(lambda: mv(r)),
        'GMRES cycle, 16 steps (M, K8, Gram-Schmidt, Givens)':
            cuda_ms(lambda: gmres_cycle(mv, r, M=M, m=16), reps=2),
    }
    for k, v in comps.items():
        print('  %-55s %8.3f ms' % (k, v), flush=True)

    wall_off, wall, device, fams = profile_chunk(
        lambda: solver(op, b, max_chunks=1), 'one 16-step chunk')
    print(json.dumps({'n': n, 'medium': args.medium, 'nsrc': args.nsrc,
                      'components_ms': comps, 'chunk_wall_s': wall_off,
                      'chunk_wall_profiled_s': wall,
                      'chunk_device_ms': device, 'families_ms': fams,
                      'card': card}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
