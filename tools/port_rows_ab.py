#!/usr/bin/env python3
'''
Run chip_smoke's solver rows of two or more source trees of the port on
one CUDA GPU in turns, each tree in a process of its own, to compare them
in one call:

    python3 tools/port_rows_ab.py PARENT_DIR . . PARENT_DIR

Each directory must hold a checkout of the repo (chip_smoke.py and
zephyr_tpu_torch/ at its root; a `git archive` of another commit unpacked
into a git-ignored directory will do); its kernels are built into its own
build/ on first use. For each tree in the order given, one process
imports that tree's chip_smoke and runs, with chip_smoke's set-ups: the
2048^2 x 16 headline rows hom, layered, hom with the default config and
marmousi (8 panels; warm-up, then timed), the marmousi row at nu 3/3
(phase 9b, stopped at the marmousi row's count) and the `eurus` TTI row
at 512^2 x 16 (phase 8b; warm-up, then timed). It prints per tree the
iterations, relres and wall seconds of each row, the milliseconds per
iteration of nu 3/3 and per GMRES iteration of `eurus`, and the card's
name and power limit; the last line is one JSON object of all trees.
'''

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one(tree):
    'Run the rows of one tree in this process; return their numbers.'
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch
    import chip_smoke as cs
    if not os.path.samefile(os.path.dirname(cs.__file__), tree):
        raise RuntimeError('chip_smoke imported from %s, not %s'
                           % (cs.__file__, tree))
    from zephyr_tpu_torch.ops import cuda_kernels as ck
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    t0 = time.perf_counter()
    ck.build()
    ck._load()
    out = {'tree': tree, 'card': card, 'build_s': time.perf_counter() - t0}
    for name, medium, opts in (('hom', 'hom', cs.PRODUCTION),
                               ('layered', 'layered', cs.PRODUCTION),
                               ('default', 'hom', None),
                               ('marmousi', 'marmousi', cs.PRODUCTION)):
        r = cs.headline(2048, 16, medium, card, opts=opts)[0]
        out[name] = {k: r[k] for k in ('iters', 'relres', 'wall_s',
                                       'solves_per_s')}
    r = cs.marmousi_nu33(2048, 16, card, out['marmousi']['iters'])
    out['marmousi_nu33'] = {k: r[k] for k in ('iters', 'relres', 'wall_s',
                                              'ms_per_iter')}
    r = cs.tti_bench(512, 16, 'hom', card)
    out['eurus'] = {'iters': r['iters'], 'relres': r['relres'],
                    'wall_s': r['wall_s'],
                    'ms_per_iter': 1e3 * r['wall_s'] / max(r['iters'], 1)}
    return out


def main():
    if len(sys.argv) == 3 and sys.argv[1] == '--one':
        print(json.dumps(one(sys.argv[2])), flush=True)
        return 0
    trees = sys.argv[1:]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for tree in trees:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               '--one', tree], capture_output=True,
                              text=True, cwd=HERE)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            print('port_rows_ab: %s failed (%d)' % (tree, proc.returncode),
                  file=sys.stderr)
            return 1
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(r)
        print('%s (%s; build %.1f s):' % (tree, r['card'], r['build_s']),
              flush=True)
        for row in ('hom', 'layered', 'default', 'marmousi'):
            x = r[row]
            print('  %-9s iters %4d  relres %.3e  wall %.3f s  %.3f solves/s'
                  % (row, x['iters'], x['relres'], x['wall_s'],
                     x['solves_per_s']), flush=True)
        for row in ('marmousi_nu33', 'eurus'):
            x = r[row]
            print('  %-13s iters %4d  relres %.3e  wall %.3f s  %.3f ms an '
                  'iteration' % (row, x['iters'], x['relres'], x['wall_s'],
                                 x['ms_per_iter']), flush=True)
    print(json.dumps({'runs': runs}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
