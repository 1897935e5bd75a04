#!/usr/bin/env python3
'''
chip_smoke.py's phase 11 or 12 alone on one CUDA GPU: multi-frequency
block modelling, multiscale inversion and 2.5D (11), and TTI gradients
(12) through zephyr_tpu_torch.

    python3 tools/time_port_multifreq.py [freqblock gradient multiscale
        oracle_25d middleware_25d backward middleware misfit_gradient]
        [--nky N]

It builds the kernels (chip_smoke's phase 2), then runs the named
sub-phases (default all of phase 11, in that order: 11a freqblock, 11b
multifreq_dpred and the autograd fwi_misfit against the chunked gradient,
11c multiscale, 11d the 2.5D oracle and the 2.5D problem on the 512^2
Marmousi model, with nky 20 unless ``--nky`` says otherwise; phase 12:
12a the backward of the TTI solve, 12b the Eurus problem's dpred, Jvec,
Jtvec and dot test, 12c its misfit_and_gradient), with the kernel launch
counts (and K8's operand copies) set to 0 before each and printed after,
at chip_smoke's sizes and with its checks. Prints the card's name and power limit first and one JSON line
last. Without a CUDA device it exits non-zero.
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
    names = list(cs.phase11(None)) + list(cs.phase12(None))
    ap.add_argument('parts', nargs='*', choices=names)
    ap.add_argument('--nky', type=int, default=20)
    args = ap.parse_args()
    parts = args.parts or list(cs.phase11(None))
    if not torch.cuda.is_available():
        print('time_port_multifreq: no CUDA device', file=sys.stderr)
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
    runs = dict(cs.phase11(card, args.nky), **cs.phase12(card))
    out = {}
    for part in parts:
        ck.reset_launches()
        t0 = time.perf_counter()
        out[part] = runs[part]()
        torch.cuda.synchronize()
        out[part + '_wall_s'] = time.perf_counter() - t0
        out[part + '_launches'] = dict(ck.LAUNCHES)
        cs.say('%s: %.1f s; launches %s; K8 operand copies %d'
               % (part, out[part + '_wall_s'],
                  json.dumps(out[part + '_launches']),
                  ck.COPIES['apply_block_stencil']))
    cs.say(json.dumps({'phases': out, 'card': card}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
