#!/usr/bin/env python3
'''
Time K6 (jacobi_sweep2, from u and from zero) and K8 (apply_block_stencil)
of zephyr_tpu_torch on one CUDA GPU across the batch size R, to tell the
per-launch coefficient pass apart from the per-RHS cost:

    python3 tools/time_port_k6_k8.py [--reps 20] [--repeat 1]
                                     [--sizes 2048,1024,...] [--queued]
                                     [--plans]

K6 runs on chip_smoke.level_inputs (the CSLP-shifted MiniZephyr planes)
at every level size of the 2048^2 hierarchy (2048^2 down to 64^2), K8 on
chip_smoke.tti_planes (the shifted Eurus planes of the bench's TTI rows)
at 2048^2 and at every level of the 512^2 `eurus` hierarchy (512^2 down
to 64^2), each at R = 1, 4, 16. For each shape it prints the time an
extra RHS adds, (t(16) - t(4)) / 12, beside its share of the byte bound
(K6: 24 B a point from u, 16 B from zero; K8: 32 B), and the time left
at R = 1 once that per-RHS cost is taken off: the launch's fixed cost
(coefficients, latency, the host's call rate at small sizes).

Each time is CUDA events over ``--reps`` launches after a warm-up (the
median of ``--repeat`` such timings), beside the kernel's bound
(chip_smoke.work / chip_smoke.bound); ``--sizes`` keeps only the listed
level sizes (the slopes need R = 4 and 16). With ``--queued`` the stream
first sleeps on the card while the host enqueues the launches, so the
events time the card alone, not the host's rate of wrapper calls (which
sets the plain times at 256^2 and below). ``--plans``
also times, at every R, the RHS groups the wrappers could have
chosen (``groups``), each checked against the twin: the measurements
behind cuda_kernels._k6_group and _k8_group. Prints the
card's name and power limit first and one JSON line last.
'''

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import (PEAK_BYTES_S, bound, card_line, cuda_ms,  # noqa
                        level_inputs, tti_planes, work)
from zephyr_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from zephyr_tpu_torch.ops import stencil  # noqa: E402

RS = (1, 4, 16)


def groups(group_fn, nz, nx, R):
    '''
    The RHS groups --plans times: the wrapper's own (``group_fn``:
    cuda_kernels._k6_group or _k8_group), R, 8, 4, 2 and 1 (at most R).
    '''
    return sorted({group_fn(nz, nx, R)} | {min(R, g) for g in (R, 8, 4, 2, 1)},
                  reverse=True)

#: bytes an extra RHS must move per grid point
RHS_BYTES = {'jacobi_sweep2': 24, 'jacobi_sweep2_zero': 16,
             'apply_block_stencil': 32, 'presmooth_residual': 24}


def _err(out, ref):
    return float(torch.max(torch.abs(out - ref)) / torch.max(torch.abs(ref)))


def scaling(name, n, times):
    '''
    The per-RHS slope (t(16) - t(4)) / 12 in ms, its byte share, and the
    fixed cost t(1) - slope.
    '''
    slope = (times[16] - times[4]) / 12
    share = RHS_BYTES[name] * n * n / PEAK_BYTES_S * 1e3
    return {'ms_per_rhs': slope, 'byte_share_ms_per_rhs': share,
            'ratio': slope / share, 'fixed_ms': times[1] - slope}


def queued_ms(fn, reps):
    '''
    Milliseconds a launch of fn takes on the card alone: the launches are
    enqueued while the stream sleeps, so they run back to back.
    '''
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)      # ~25 ms: longer than the enqueueing
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--repeat', type=int, default=1)
    ap.add_argument('--sizes', default='2048,1024,512,256,128,64')
    ap.add_argument('--queued', action='store_true')
    ap.add_argument('--plans', action='store_true')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('time_port_k6_k8: no CUDA device', file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    log = ck.build().with_suffix('.log').read_text()
    ck._load()
    for line in log.splitlines():
        if 'Used' in line or 'spill' in line or 'Compiling' in line:
            print('  ptxas: ' + line.split('ptxas info    : ')[-1])
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    out = {'card': card, 'k6': {}, 'k8': {}, 'scaling': {}}

    def field(*shape):
        return torch.complex(torch.randn(shape, generator=gen, device='cuda'),
                             torch.randn(shape, generator=gen, device='cuda'))

    timer = queued_ms if args.queued else cuda_ms

    def timed(table, name, label, n, R, fn):
        ms = sorted(timer(fn, reps=args.reps)
                    for _ in range(args.repeat))[args.repeat // 2]
        b_ms = bound(*work(name, n, n, R))[0]
        table['%s %s R=%d' % (name, label, R)] = {'ms': ms, 'bound_ms': b_ms}
        print('%-20s %-6s R=%-2d %8.3f ms  bound %.3f ms (%.0f%%)'
              % (name, label, R, ms, b_ms, 100 * b_ms / ms), flush=True)
        return ms

    def report(table, name, label, n):
        times = {R: table['%s %s R=%d' % (name, label, R)]['ms'] for R in RS}
        s = scaling(name, n, times)
        out['scaling']['%s %s' % (name, label)] = s
        print('   %s %s: %.4f ms an extra RHS (byte share %.4f, x%.1f), '
              'fixed %.4f ms' % (name, label, s['ms_per_rhs'],
                                 s['byte_share_ms_per_rhs'], s['ratio'],
                                 s['fixed_ms']), flush=True)

    sizes = [int(v) for v in args.sizes.split(',')]
    for n in (m for m in (2048, 1024, 512, 256, 128, 64) if m in sizes):
        label = '%d^2' % n
        planes, D, _, _ = level_inputs(n, n, 16, gen)
        for R in RS:
            b, u = field(R, n, n), field(R, n, n)
            timed(out['k6'], 'jacobi_sweep2', label, n, R,
                  lambda: ck.jacobi_sweep2(planes, D, b, u))
            timed(out['k6'], 'jacobi_sweep2_zero', label, n, R,
                  lambda: ck.jacobi_sweep2(planes, D, b))
            if args.plans:
                refs = (stencil._jacobi2_ref(planes, D, b, u),
                        stencil._jacobi2z_ref(planes, D, b))
                for plan in groups(ck._k6_group, n, n, R):
                    for uu, ref, key in ((u, refs[0], 'jacobi_sweep2'),
                                         (None, refs[1],
                                          'jacobi_sweep2_zero')):
                        def run():
                            return ck._jacobi_sweep2_launch(planes, D, b, uu,
                                                            plan)
                        err = _err(run(), ref)
                        ms = timer(run, reps=args.reps)
                        out['k6']['%s %s R=%d plan %s'
                                  % (key, label, R, plan)] = {
                                      'ms': ms, 'rel_err': err}
                        print('   %-18s plan %-10s %8.3f ms  rel err %.1e'
                              % (key, str(plan), ms, err), flush=True)
            del b, u
        for name in ('jacobi_sweep2', 'jacobi_sweep2_zero'):
            report(out['k6'], name, label, n)
        del planes, D
        torch.cuda.empty_cache()

    for n in (m for m in (2048, 512, 256, 128, 64) if m in sizes):
        label = '%d^2' % n
        planes = tti_planes(n, n)[1]
        for R in RS:
            u = field(R, 2, n, n)
            timed(out['k8'], 'apply_block_stencil', label, n, R,
                  lambda: ck.apply_block_stencil(planes, u))
            if args.plans:
                ref = stencil.apply_block_stencil(planes, u)
                for plan in groups(ck._k8_group, n, n, R):
                    def run():
                        return ck._apply_block_stencil_launch(planes, u, plan)
                    err = _err(run(), ref)
                    ms = timer(run, reps=args.reps)
                    out['k8']['%s R=%d plan %s' % (label, R, plan)] = {
                        'ms': ms, 'rel_err': err}
                    print('   plan %-10s %8.3f ms  rel err %.1e'
                          % (str(plan), ms, err), flush=True)
            del u
        report(out['k8'], 'apply_block_stencil', label, n)
        del planes
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
