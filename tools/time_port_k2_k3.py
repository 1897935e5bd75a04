#!/usr/bin/env python3
'''
Time K3 (pcr_sweep) and K2 (presmooth_restrict) of zephyr_tpu_torch on
one CUDA GPU across the batch size R, to tell what paces them:

    python3 tools/time_port_k2_k3.py [--reps 20]

K3 runs on the homogeneous model's bf16 factors (chip_smoke.strat_factors)
at nz=1024 (the fused cycle's half grid, 1024 columns), at the 8-panel
width (nz=1024, 1536 columns: the half-grid factors tiled in x) and at
nz=2048 (the default config's full-resolution family), each at R = 1, 4,
16. K2 (two sweeps) runs on chip_smoke.level_inputs at every level size
of the 2048^2 hierarchy (2048^2 down to 64^2) at R = 1, 4, 16. Time that
grows about linearly in R says the per-RHS traffic (device memory or L2)
sets the pace; time that stays flat says latency does.

Each time is CUDA events over ``--reps`` launches after a warm-up, beside
the kernel's bound (chip_smoke.work / chip_smoke.bound). ``--plans``
also times, at R = 16, the launch plans the wrappers could have chosen
(K3: slots a lane, RHS a thread, warps a column, columns a block; K2: RHS
a block), each checked against the twin: the measurements
behind cuda_kernels._pcr_plan and _ps_group. Prints the card's name and
power limit first and one JSON line last.
'''

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import (bound, card_line, cuda_ms, level_inputs,  # noqa
                        strat_factors, work)
from zephyr_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from zephyr_tpu_torch.solver.stratified import pack_pcr_factors  # noqa

RS = (1, 4, 16)
#: K3 plans (k, g, w, cb) tried with --plans, by column depth
K3_PLANS = {1024: [(16, 2, 2, 4), (16, 2, 2, 8), (16, 2, 2, 2),
                   (16, 1, 2, 4), (8, 4, 4, 4), (4, 4, 8, 2)],
            2048: [(16, 2, 4, 4), (16, 2, 4, 2), (16, 1, 4, 4),
                   (8, 4, 8, 2), (4, 4, 16, 1)]}
#: K2 RHS groups tried with --plans at 2048^2 x 16
K2_GROUPS = [16, 8, 4]


def k3_cases():
    '''
    Yield (label, packed factors) of the three K3 shapes; the 8-panel
    width tiles the half grid's factors in x (the time depends on the
    shape only).
    '''
    half = strat_factors(2048)
    yield 'nz=1024 x 1024', half.packed
    wide = pack_pcr_factors(*(torch.cat([t, t[..., :512]], dim=-1)
                              for t in (half.alphas, half.gammas, half.dinv)))
    yield 'nz=1024 x 1536 (8 panels)', wide
    del half, wide
    yield 'nz=2048 x 2048', strat_factors(2048, full=True).packed


def _err(out, ref):
    return float(torch.max(torch.abs(out - ref)) / torch.max(torch.abs(ref)))


def _pcr_twin(packed, b):
    from zephyr_tpu_torch.solver.stratified import (_pcr_sweep_bf16_ref,
                                                    unpack_pcr_factors)
    return _pcr_sweep_bf16_ref(*unpack_pcr_factors(packed), b)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--plans', action='store_true')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('time_port_k2_k3: no CUDA device', file=sys.stderr)
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
    out = {'card': card, 'k3': {}, 'k2': {}}

    def field(*shape):
        return torch.complex(torch.randn(shape, generator=gen, device='cuda'),
                             torch.randn(shape, generator=gen, device='cuda'))

    for label, fac in k3_cases():
        nsteps, nx, nz = fac.shape[0] - 1, fac.shape[1], fac.shape[2]
        for R in RS:
            b = field(R, nz, nx)
            ms = cuda_ms(lambda: ck.pcr_sweep(fac, b), reps=args.reps)
            b_ms = bound(*work('pcr_sweep', nz, nx, R, nsteps))[0]
            out['k3']['%s R=%d' % (label, R)] = {'ms': ms, 'bound_ms': b_ms}
            print('K3 %-28s R=%-2d %8.3f ms  bound %.3f ms'
                  % (label, R, ms, b_ms), flush=True)
            if args.plans and R == 16 and nz in K3_PLANS:
                ref = _pcr_twin(fac, b)
                for plan in K3_PLANS[nz]:
                    err = _err(ck._pcr_sweep_launch(fac, b, plan), ref)
                    ms = cuda_ms(lambda: ck._pcr_sweep_launch(fac, b, plan),
                                 reps=args.reps)
                    out['k3']['%s R=16 plan %s' % (label, plan)] = {
                        'ms': ms, 'rel_err': err}
                    print('   plan %-16s %8.3f ms  rel err %.1e'
                          % (plan, ms, err), flush=True)
            del b
        torch.cuda.empty_cache()

    n = 2048
    while n >= 64:
        planes, D, mask, _ = level_inputs(n, n, 16, gen)
        for R in RS:
            b = field(R, n, n)
            ms = cuda_ms(lambda: ck.presmooth_restrict(planes, D, mask, b, 2),
                         reps=args.reps)
            b_ms = bound(*work('presmooth_restrict', n, n, R))[0]
            out['k2']['%d^2 R=%d' % (n, R)] = {'ms': ms, 'bound_ms': b_ms}
            print('K2 %4d^2 R=%-2d %8.3f ms  bound %.3f ms'
                  % (n, R, ms, b_ms), flush=True)
            if args.plans and R == 16 and n == 2048:
                from zephyr_tpu_torch.ops.stencil import _ps2rr_ref
                ref = _ps2rr_ref(planes, D, mask, b)
                for g in K2_GROUPS:
                    def run():
                        return ck._presmooth_restrict_launch(
                            planes, D, mask, b, 2, g)
                    err = max(_err(o, r) for o, r in zip(run(), ref))
                    ms = cuda_ms(run, reps=args.reps)
                    out['k2']['2048^2 R=16 g=%d' % g] = {'ms': ms,
                                                         'rel_err': err}
                    print('   g=%-2d %8.3f ms  rel err %.1e' % (g, ms, err),
                          flush=True)
            del b
        del planes, D, mask
        torch.cuda.empty_cache()
        n //= 2
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
