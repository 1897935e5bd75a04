#!/usr/bin/env python3
'''
The DD solve's convergence on one CUDA GPU (zephyr_tpu_torch.parallel.
spatial): chip_smoke's 2048^2 4-layer model and 16 point sources, the
production config, complex64, a virtual 2x2 ('z', 'x') mesh of the card,
at the given frequencies, overlaps and restart lengths, beside the
single-device chunked solve.

    python3 tools/probe_port_dd.py [--n 2048] [--freqs 56.25 93.75]
        [--overlaps 16 32 64] [--chunks 0 128] [--maxiter 800]

A restart length of 0 is ``DDOperator.solve(restarts=0)``, the JAX
package's single BiCGStab run (to maxiter); N > 0 runs it again on the
true residual every N iterations (to 0.7 tol, as
``make_chunked_solver``), an experiment on fault F10: the port's DD
solver restarts only where a run ends above tol. Each variant prints
its iterations, its true relres at each restart and at the end, and its
wall. Prints
the card's name and power limit first and one JSON line last. Without a
CUDA device it exits non-zero.
'''

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def run_variant(planes, pplanes, b, cfg, overlap, chunk, maxiter):
    from zephyr_tpu_torch.parallel import spatial as sp
    mesh, _ = cs.virtual_mesh('2x2')
    ps = sp._grid_sharding(mesh, 5, 'x', 'z')
    bs = sp._grid_sharding(mesh, 4, 'x', 'z')
    op = sp.DDOperator(ps.split(planes), ps.split(pplanes), cfg, mesh, 'x',
                       'z', overlap)
    bsh = bs.split(b)
    coords = mesh.coords()
    dev = bsh[coords[0]].device
    bn = sp._norms(bsh, coords, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if not chunk:
        _, total, rr = op.solve(bsh, maxiter=maxiter, restarts=0)
        trace = [(total, rr)]
    else:
        x = {c: torch.zeros_like(bsh[c]) for c in coords}
        total, trace = 0, []
        while True:
            ax = op.apply(x)
            r = {c: bsh[c] - ax[c] for c in coords}
            rn = sp._norms(r, coords, dev)
            rr = float(torch.max(rn / bn))
            trace.append((total, rr))
            if rr <= cfg.tol or total >= maxiter or not np.isfinite(rr):
                break
            tol_r = 0.7 * cfg.tol * bn / torch.clamp(rn, min=1e-30)
            dx, it, _ = op.solve(r, tol=tol_r,
                                 maxiter=min(chunk, maxiter - total),
                                 restarts=0)
            x = {c: x[c] + dx[c] for c in coords}
            total += it
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {'overlap': overlap, 'chunk': chunk, 'iters': total,
            'relres': rr, 'wall_s': wall,
            'trace': [(i, float('%.3g' % v)) for i, v in trace]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--n', type=int, default=2048)
    ap.add_argument('--freqs', type=float, nargs='+',
                    default=[56.25, 93.75])
    ap.add_argument('--overlaps', type=int, nargs='+', default=[16, 32, 64])
    ap.add_argument('--chunks', type=int, nargs='+', default=[0, 128])
    ap.add_argument('--maxiter', type=int, default=800)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('probe_port_dd: no CUDA device', file=sys.stderr)
        return 2
    from zephyr_tpu_torch.ops import cuda_kernels as ck
    from zephyr_tpu_torch.solver.helmholtz import (
        make_chunked_solver, prepare_operator, resolve_solver_config)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    cs.say('card: %s; torch %s' % (card, torch.__version__))
    ck.build()
    ck._load()
    cfg = resolve_solver_config(cs.PRODUCTION, torch.complex64)
    b = cs.point_sources(args.n, 16)
    out = []
    for freq in args.freqs:
        planes, pplanes = cs.layered_planes(args.n, cfg, freq)
        op = prepare_operator(planes, pplanes, cfg, with_transpose=False)
        _, it_g, rr_g = make_chunked_solver(cfg, chunk=32)(op, b)
        del op
        cs.say('%.2f Hz %d^2: single device chunked %d iterations, relres '
               '%.3e' % (freq, args.n, it_g, rr_g))
        for ov in args.overlaps:
            for ch in args.chunks:
                r = run_variant(planes, pplanes, b, cfg, ov, ch, args.maxiter)
                r.update(freq=freq, global_iters=it_g)
                out.append(r)
                cs.say('%.2f Hz overlap %d chunk %d: %d iterations, relres '
                       '%.3e, %.2f s; %s' % (freq, ov, ch, r['iters'],
                                             r['relres'], r['wall_s'],
                                             r['trace'][-4:]))
                torch.cuda.empty_cache()
    cs.say(json.dumps({'dd_probe': out, 'card': card}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
