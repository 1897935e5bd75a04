#!/usr/bin/env python3
'''
chip_smoke.py's phase 14 alone on one CUDA GPU: the scale-out layer of
zephyr_tpu_torch (the DD solve, the DD forward, the sharded FWI step,
profiling, checkpoints and the dry-run).

    python3 tools/time_port_spatial.py [--phase5]

It builds the kernels (chip_smoke's phase 2), optionally runs phase 5's
production layered row for the DD iteration bound's base (``--phase5``;
else chip_smoke's recorded count), then phase 14 at chip_smoke's sizes
and with its checks: 14a the DD solve on a virtual 2x2 mesh of the card
(2048^2 layered x 16, overlap 16) after the sharded apply's checks, 14b
``make_dd_dpred`` at 2048^2 (2 frequencies x 16 sources x 64 receivers),
14c ``make_sharded_fwi_step`` at 512^2 Marmousi on a (freq=4, src=2)
mesh, 14d the traced DD solve, the checkpoint of 14c's state, ``entry()``
and ``dryrun_multichip(4)``. Prints the card's name and power limit
first, the launches over the spatial path, and one JSON line last.
Without a CUDA device it exits non-zero.
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
    ap.add_argument('--phase5', action='store_true')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('time_port_spatial: no CUDA device', file=sys.stderr)
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
    base = None
    if args.phase5:
        out['phase5'] = cs.headline(2048, 16, 'layered', card)[0]
        base = out['phase5']['iters']
    out['phase14'], launches = cs.phase14(card, base)
    out['launches'] = launches
    cs.say('launches over the spatial path: %s' % json.dumps(launches))
    for name in cs.SPATIAL_PATH:
        if launches[name] == 0:
            cs.fail('kernel %s was never launched on the spatial path'
                    % name)
    cs.say(json.dumps({'phases': out, 'card': card}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
