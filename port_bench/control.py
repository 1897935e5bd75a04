#!/usr/bin/env python3
'''
The lower-precision control of a cell's comparison, at the cell's own
size: for each seed, a window of the program at the cell's load, then
the numbers compared for the program and for the control, the plain
reference computed in bfloat16 storage (float32 arithmetic) and put in
the program's place. The control has to come out above the limits.

    python3 port_bench/control.py --workload <name> --seeds 1,2,3 \\
        --seconds <s>

One process; the program is set up once per seed (a seed only orders the
work). Prints one JSON line per seed, then a summary line.
'''

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))


def main(argv=None, device='cuda'):
    import argparse

    import torch

    import harness

    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--seconds', type=float, required=True)
    args = ap.parse_args(argv)
    if device == 'cuda' and not torch.cuda.is_available():
        print('control: no CUDA device', file=sys.stderr)
        return 2
    _, config, traffic = harness.cell(harness.benchmark(), args.workload)
    driver = harness.load_module('drivers', traffic['driver'])
    limits = traffic['limits']
    rows = []
    for seed in [int(s) for s in args.seeds.split(',')]:
        cell = driver.Cell(config, traffic, seed, device)
        record = cell.window(args.seconds)
        cell.release()
        t0 = time.perf_counter()
        program = cell.check(record)
        t1 = time.perf_counter()
        control = cell.check(record, *driver.control_quantize())
        t2 = time.perf_counter()
        row = {'seed': seed, 'units': len(record['units']),
               'program': program, 'control': control,
               'reference_s': t1 - t0, 'control_s': t2 - t1,
               'control_fails': any(not (control[k] <= limits[k])
                                    for k in limits)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({
        'workload': args.workload,
        'program_max': {k: max(r['program'][k] for r in rows)
                        for k in rows[0]['program']},
        'control_min': {k: min(r['control'][k] for r in rows)
                        for k in rows[0]['control']},
        'control_fails_every_seed': all(r['control_fails'] for r in rows)}),
        flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
