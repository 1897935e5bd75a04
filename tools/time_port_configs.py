#!/usr/bin/env python3
'''
chip_smoke.py's phase-3 slab-mask checks and phase 13 alone on one CUDA
GPU: the solver configurations beside the production one and the CLI
(zephyr_tpu_torch).

    python3 tools/time_port_configs.py [2d add iterative interior_mask
        tti_2d frontend] [--no-masks] [--phase5]

It builds the kernels (chip_smoke's phase 2), holds K2, K4 and K9
against their twins under a slab's closure mask (phase 3; skipped with
``--no-masks``), optionally runs phase 5's production hom row for its ms
an iteration (``--phase5``, printed beside 13b's), then the named
sub-phases (default all, in that order: 13a the 2D symbol solve and the
additive hybrid, 13b the iterative coarse solve, 13c the interior mask,
13d the `eurus` row with the block symbol solve and its backward at
256^2, 13e the CLI's model, inspect, migrate and invert), with the kernel
launch counts set to 0 before each and printed after, at chip_smoke's
sizes and with its checks. Prints the card's name and power limit first
and one JSON line last. Without a CUDA device it exits non-zero.
'''

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    names = list(cs.phase13(None))
    ap.add_argument('parts', nargs='*', choices=names)
    ap.add_argument('--no-masks', action='store_true')
    ap.add_argument('--phase5', action='store_true')
    args = ap.parse_args()
    parts = args.parts or names
    if not torch.cuda.is_available():
        print('time_port_configs: no CUDA device', file=sys.stderr)
        return 2
    from zephyr_tpu_torch.ops import cuda_kernels as ck
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    cs.say('card: %s; torch %s, CUDA %s' % (card, torch.__version__,
                                             torch.version.cuda))
    t0 = time.perf_counter()
    ck.build()
    ck._load()
    cs.say('kernels built in %.1f s' % (time.perf_counter() - t0))
    out = {}
    if not args.no_masks:
        gen = torch.Generator(device=cs.DEV)
        gen.manual_seed(0)
        out['slab_mask_worst_rel'] = cs.check_slab_masks(gen)
    phase5 = None
    if args.phase5:
        phase5 = out['phase5'] = cs.headline(2048, 16, 'hom', card)[0]
    runs = cs.phase13(card, phase5)
    for part in parts:
        ck.reset_launches()
        t0 = time.perf_counter()
        out[part] = runs[part]()
        torch.cuda.synchronize()
        out[part + '_wall_s'] = time.perf_counter() - t0
        out[part + '_launches'] = dict(ck.LAUNCHES)
        cs.say('%s: %.1f s; launches %s'
               % (part, out[part + '_wall_s'],
                  json.dumps(out[part + '_launches'])))
    cs.say(json.dumps({'phases': out, 'card': card}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
