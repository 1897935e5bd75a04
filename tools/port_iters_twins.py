#!/usr/bin/env python3
'''
BiCGStab iteration counts of chip_smoke.py's 2048^2 headline rows on one
CUDA GPU with chosen kernels replaced by their plain torch twins, to tell
whether a change in the counts comes from a kernel's rounding:

    python3 tools/port_iters_twins.py [--twins k2,k3]
                                      [--media layered,marmousi,gradient_marmousi]

``--twins`` names the kernels whose wrapper is swapped for its twin on
the card (k2: presmooth_restrict -> stencil._ps2rr_ref / _ps1rr_ref; k3:
pcr_sweep -> stratified._pcr_sweep_bf16_ref on the unpacked factors; an
empty value keeps every kernel). Each row is chip_smoke.headline (a
warm-up solve, then a timed one; the production config, 16 sources), or
for ``gradient_marmousi`` chip_smoke.fwi_gradient at 512^2 (the forward
and adjoint counts of each of its 8 frequencies).
Prints the card's name and power limit first, one line a row, and one
JSON line last.
'''

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from zephyr_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from zephyr_tpu_torch.ops import stencil  # noqa: E402
from zephyr_tpu_torch.solver import stratified  # noqa: E402


def twin_k2(planes, dinv_eff, mask, b, nsweeps):
    ref = stencil._ps2rr_ref if nsweeps == 2 else stencil._ps1rr_ref
    return tuple(t.contiguous() for t in ref(planes, dinv_eff, mask, b))


def twin_k3(*args):
    '''
    K3's twin for either wrapper signature: (packed, b), or the planes
    (alphas, gammas, dinv, b) that the wrapper took before the packed
    layout (so the tool also runs in an older tree).
    '''
    if len(args) == 2:
        args = stratified.unpack_pcr_factors(args[0]) + (args[1],)
    return stratified._pcr_sweep_bf16_ref(*args).contiguous()


TWINS = {'k2': ('presmooth_restrict', twin_k2), 'k3': ('pcr_sweep', twin_k3)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--twins', default='k2,k3')
    ap.add_argument('--media', default='layered,marmousi')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('port_iters_twins: no CUDA device', file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    print(card, flush=True)
    twins = [t for t in args.twins.split(',') if t]
    for t in twins:
        name, fn = TWINS[t]
        setattr(ck, name, fn)
    rows = []
    for medium in args.media.split(','):
        if medium == 'gradient_marmousi':
            out = chip_smoke.fwi_gradient(512, 16, 8, card, medium='marmousi')
            row = {'medium': medium, 'twins': twins,
                   'iters': out['iters_fwd_adj'], 'misfit': out['misfit'],
                   'wall_s': out['wall_s']}
            print('twins %s %s: iters %s misfit %.6e'
                  % (twins or 'none', medium, row['iters'], row['misfit']),
                  flush=True)
        else:
            out = chip_smoke.headline(2048, 16, medium, card)[0]
            row = {'medium': medium, 'twins': twins, 'iters': out['iters'],
                   'relres': out['relres'], 'wall_s': out['wall_s']}
            print('twins %s %s: iters %d relres %.6e'
                  % (twins or 'none', medium, out['iters'], out['relres']),
                  flush=True)
        rows.append(row)
    print(json.dumps({'rows': rows, 'card': card}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
