#!/usr/bin/env python3
'''
Where a scalar BiCGStab iteration of zephyr_tpu_torch spends its device
time, on one CUDA GPU:

    python3 tools/profile_port_scalar.py [--n 2048] [--medium marmousi]
                                         [--config production|default]
                                         [--nu1 N] [--nu2 N]

It prepares the operator and sources of chip_smoke.py phase 5/5b/9a
(imported from there: n^2, 16 point sources, freq 1500/16, the production
config with the auto x-panel rule, which gives the bench's Marmousi model
8 panels at 2048^2, or with ``--config default`` the default SolverConfig,
whose stratified solve runs at full resolution; ``--nu1``/``--nu2``
change the smoother), runs one warm-up chunk, then

1. times the components of one preconditioner application with CUDA
   events (the stratified solve P on its grid, the half grid or at
   full resolution, panelled or global; its K3 sweep alone; the
   preconditioner M; one K1 apply);
2. times one 32-iteration chunk (host clock, synchronised), profiles
   another with torch.profiler and prints the device time by kernel
   family and the idle share (1 - device time / unprofiled wall).

Prints the card's name and power limit first and one JSON line last.
'''

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import (MEDIA, PRODUCTION, point_sources,  # noqa: E402
                        scalar_operator)
from profile_port_tti import cuda_ms, profile_chunk  # noqa: E402
from zephyr_tpu_torch.ops.stencil import apply_block_stencil_fast  # noqa
from zephyr_tpu_torch.solver import helmholtz as th  # noqa: E402
from zephyr_tpu_torch.solver import stratified as tsr  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--n', type=int, default=2048)
    ap.add_argument('--medium', default='marmousi', choices=sorted(MEDIA))
    ap.add_argument('--nsrc', type=int, default=16)
    ap.add_argument('--config', default='production',
                    choices=('production', 'default'))
    ap.add_argument('--nu1', type=int, default=None)
    ap.add_argument('--nu2', type=int, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('profile_port_scalar: no CUDA device', file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    n = args.n
    c_np = MEDIA[args.medium](n)
    opts = dict(PRODUCTION) if args.config == 'production' else {}
    for key, val in (('mg_nu1', args.nu1), ('mg_nu2', args.nu2)):
        if val is not None:
            opts[key] = val
    cfg = th.resolve_panels(th.resolve_solver_config(opts, torch.complex64),
                            c_np)
    op, _ = scalar_operator(c_np, cfg)
    b = point_sources(n, args.nsrc)
    solver = th.make_chunked_solver(cfg, chunk=32)
    solver(op, b, max_chunks=1)

    M = th._make_precond(op, cfg)
    r = b / torch.linalg.vector_norm(b)
    # the spectral grid: the half grid, or n at full resolution
    nzc = op.strat.ldu.shape[-2]
    nxc = n if nzc == n else (n + 1) // 2
    width = op.strat.ldu.shape[-1]      # P * W with panels
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)

    def field(*shape):
        return torch.complex(torch.randn(shape, generator=gen, device='cuda'),
                             torch.randn(shape, generator=gen, device='cuda'))
    rc = field(args.nsrc, 1, nzc, nxc)
    rhat = field(args.nsrc, nzc, width)
    if cfg.strat_panels > 1:
        P0 = tsr.panel_solver(op.strat, nxc, cfg.strat_panels,
                              cfg.strat_overlap, taper=cfg.strat_taper)
    else:
        def P0(v):
            return tsr.stratified_apply(op.strat, v)
    comps = {
        'stratified solve P, %dx%d (%d panels, width %d)'
        % (nzc, nxc, cfg.strat_panels, width): cuda_ms(lambda: P0(rc)),
        'its K3 sweep alone (nz=%d, width %d)' % (nzc, width):
            cuda_ms(lambda: tsr.pcr_apply(op.strat, rhat)),
        'preconditioner M (%s)' % ('fused cycle' if cfg.hybrid_comp ==
                                   'fused' else cfg.hybrid_comp):
            cuda_ms(lambda: M(r)),
        'K1 apply (one matvec)':
            cuda_ms(lambda: apply_block_stencil_fast(op.planes, r)),
    }
    for k, v in comps.items():
        print('  %-55s %8.3f ms' % (k, v), flush=True)

    wall_off, wall, device, fams = profile_chunk(
        lambda: solver(op, b, max_chunks=1), 'one 32-iteration chunk')
    print(json.dumps({'n': n, 'medium': args.medium, 'nsrc': args.nsrc,
                      'config': args.config,
                      'nu': [cfg.mg_nu1, cfg.mg_nu2],
                      'panels': cfg.strat_panels, 'components_ms': comps,
                      'chunk_wall_s': wall_off,
                      'chunk_wall_profiled_s': wall,
                      'chunk_device_ms': device, 'families_ms': fams,
                      'card': card}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
