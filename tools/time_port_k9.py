#!/usr/bin/env python3
'''
Time K9 (presmooth_residual: two damped-Jacobi sweeps from zero and the
masked residual) of zephyr_tpu_torch on one CUDA GPU across the batch
size R, to tell the per-launch coefficient pass apart from the per-RHS
cost:

    python3 tools/time_port_k9.py [--reps 20] [--repeat 1]
                                  [--sizes 2048,1024,...] [--plans]

K9 runs on chip_smoke.level_inputs (the CSLP-shifted MiniZephyr planes,
the damped diagonal inverse and the ring mask) at every level size of the
2048^2 hierarchy (2048^2 down to 64^2), at R = 1, 4, 16, and is held
against its twin (stencil._ps2r_ref) at each. Each shape is timed twice,
the median of ``--repeat`` timings of ``--reps`` launches each: ``ms``
by CUDA events around back-to-back wrapper calls (chip_smoke.cuda_ms; at
256^2 and below that is the host's rate of wrapper calls) and
``queued_ms`` with the launches enqueued while the stream sleeps
(time_port_k6_k8.queued_ms: the card alone). For each size it prints the
time an extra RHS adds on the card, (t(16) - t(4)) / 12 of the queued
times, beside its byte share (24 B a point: b in, u2 and the residual
out), and the fixed cost t(1) - slope. ``--plans`` also times (queued)
the RHS groups the wrapper could have chosen
(time_port_k6_k8.groups over cuda_kernels._k9_group), each checked
against the twin. Prints the card's name and power limit and K9's ptxas
registers and spills first, and one JSON line last.
'''

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from chip_smoke import (bound, card_line, cuda_ms, level_inputs,  # noqa
                        ptxas_of, rel_err, work)
from time_port_k6_k8 import groups, queued_ms, scaling  # noqa: E402
from zephyr_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from zephyr_tpu_torch.ops import stencil  # noqa: E402

NAME = 'presmooth_residual'
RS = (1, 4, 16)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--repeat', type=int, default=1)
    ap.add_argument('--sizes', default='2048,1024,512,256,128,64')
    ap.add_argument('--plans', action='store_true')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('time_port_k9: no CUDA device', file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    log = ck.build().with_suffix('.log').read_text()
    ck._load()
    ptxas = ptxas_of(log, 'zt_presmooth_residual')
    for entry, (regs, st, ld) in ptxas.items():
        print('  ptxas: %s: %s registers, spill %d B stores / %d B loads'
              % (entry, regs, st, ld))
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    out = {'card': card, 'ptxas': ptxas, 'k9': {}, 'scaling': {}}

    def median(timer, fn):
        return sorted(timer(fn, reps=args.reps)
                      for _ in range(args.repeat))[args.repeat // 2]

    sizes = [int(v) for v in args.sizes.split(',')]
    for n in (m for m in (2048, 1024, 512, 256, 128, 64) if m in sizes):
        planes, D, mask, field = level_inputs(n, n, 16, gen)
        times = {}
        for R in RS:
            b = field(R, n, n)
            ref = stencil._ps2r_ref(planes, D, mask, b)

            def run():
                return ck.presmooth_residual(planes, D, mask, b)
            rel, abs_err = rel_err(run(), ref)
            ms, q_ms = median(cuda_ms, run), median(queued_ms, run)
            b_ms = bound(*work(NAME, n, n, R))[0]
            times[R] = q_ms
            out['k9']['%d^2 R=%d' % (n, R)] = {
                'ms': ms, 'queued_ms': q_ms, 'bound_ms': b_ms,
                'rel_err': rel, 'max_abs_err': abs_err}
            print('%4d^2 R=%-2d %8.4f ms  queued %8.4f ms  bound %.4f ms '
                  '(%.0f%% queued)  rel err %.1e'
                  % (n, R, ms, q_ms, b_ms, 100 * b_ms / q_ms, rel),
                  flush=True)
            if args.plans:
                for g in groups(ck._k9_group, n, n, R):
                    def plan():
                        return ck._presmooth_residual_launch(planes, D,
                                                             mask, b, g)
                    err = rel_err(plan(), ref)[0]
                    p_ms = median(queued_ms, plan)
                    out['k9']['%d^2 R=%d group %d' % (n, R, g)] = {
                        'queued_ms': p_ms, 'rel_err': err}
                    print('   group %-3d queued %8.4f ms  rel err %.1e'
                          % (g, p_ms, err), flush=True)
            del b, ref
        s = scaling(NAME, n, times)
        out['scaling']['%d^2' % n] = s
        print('   %d^2: %.4f ms an extra RHS (byte share %.4f, x%.1f), '
              'fixed %.4f ms' % (n, s['ms_per_rhs'],
                                 s['byte_share_ms_per_rhs'], s['ratio'],
                                 s['fixed_ms']), flush=True)
        del planes, D, mask
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
