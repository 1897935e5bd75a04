#!/usr/bin/env python3
'''
Where a call of the 2D problem layer (zephyr_tpu_torch.middleware) spends
its wall time, on one CUDA GPU:

    python3 tools/profile_port_middleware.py [--n 2048] [--profile]

It builds chip_smoke.py phase 10a's problem (imported from there: the
bench's Marmousi model at n^2, Helm2DProblem + Helm2DSurvey, one
frequency 1500/16, phase 7a's 16 sources and 64 receivers, the production
config), runs the forward map once to warm up, then for the forward map,
Jvec and Jtvec in turn, each called twice (the first call of a mode pays
its first-use costs):

1. each call's wall (host clock, synchronised) split into segments: each
   of the functions below is wrapped, for the call, by one that
   synchronises the card before and after it and adds its seconds to its
   name (a segment's time includes the segments it calls):
   the plane builder, prepare_operator, solve_batched (the forward solve
   and, under forward mode, the tangent solve), each Krylov run, the
   receiver projection, and autograd's backward (reverse mode: the
   transpose solve);
2. with ``--profile``, a torch.profiler trace of another call: device
   time by kernel family, the largest kernels and the idle share.

Prints the card's name and power limit first and one JSON line last.
'''

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import (marmousi_c, middleware_pair,  # noqa: E402
                        smooth_field)
from profile_port_tti import profile_chunk  # noqa: E402
from zephyr_tpu_torch.middleware import problem as mp  # noqa: E402
from zephyr_tpu_torch.middleware import (Helm2DProblem,  # noqa: E402
                                         Helm2DSurvey)
from zephyr_tpu_torch.solver import helmholtz as th  # noqa: E402


class segments:
    '''
    Wrap ``targets`` ((owner, attribute name, label)) for the block: each
    call synchronises, runs, synchronises and adds its seconds to
    ``self.seconds[label]`` (and one to ``self.calls[label]``).
    '''

    def __init__(self, targets):
        self.targets = targets
        self.seconds, self.calls = {}, {}

    def __enter__(self):
        self.saved = []
        for owner, name, label in self.targets:
            fn = getattr(owner, name)
            self.saved.append((owner, name, fn))

            def timed(*args, _fn=fn, _label=label, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(*args, **kwargs)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                self.seconds[_label] = self.seconds.get(_label, 0.) + dt
                self.calls[_label] = self.calls.get(_label, 0) + 1
                return out
            setattr(owner, name, timed)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self.saved):
            setattr(owner, name, fn)


TARGETS = ((mp, 'minizephyr_planes', 'plane builder'),
           (mp, 'prepare_operator', 'prepare_operator'),
           (mp, 'solve_batched', 'solve_batched'),
           (th, '_krylov_solve', 'Krylov runs'),
           (mp._Receivers, 'project', 'receiver projection'),
           (torch.autograd, 'grad', 'autograd.grad'))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--n', type=int, default=2048)
    ap.add_argument('--profile', action='store_true')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('profile_port_middleware: no CUDA device', file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    n = args.n
    problem, survey = middleware_pair(Helm2DProblem, Helm2DSurvey, n,
                                      marmousi_c(n).astype(np.float64),
                                      [1500.0 / 16])
    v = 10.0 * smooth_field(n, 7).ravel()
    rng = np.random.default_rng(8)
    w = rng.standard_normal(survey.nD) + 1j * rng.standard_normal(survey.nD)

    def forward_map():
        with torch.no_grad():
            return problem._dpred_fn()(problem._baseTensor())

    calls = {'forward map': forward_map,
             'Jvec': lambda: problem.Jvec(v=v),
             'Jtvec': lambda: problem.Jtvec(v=w)}
    forward_map()
    out = {'n': n, 'panels': problem.solverConfig.strat_panels, 'calls': {},
           'card': card}
    for label, fn in calls.items():
        row = {'wall_s': [], 'segments_s': []}
        for rep in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with segments(TARGETS) as seg:
                fn()
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            row['wall_s'].append(wall)
            row['segments_s'].append(seg.seconds)
            row['segment_calls'] = seg.calls
            print('%s (call %d): wall %.3f s; %s' % (
                label, rep + 1, wall, ', '.join(
                    '%s %.3f s (%d)' % (k, t, seg.calls[k])
                    for k, t in seg.seconds.items())), flush=True)
        if args.profile:
            wall_off, wall_on, device, fams = profile_chunk(fn, label)
            row.update(profiled_wall_s=wall_on, device_ms=device,
                       families_ms=fams)
        out['calls'][label] = row
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
