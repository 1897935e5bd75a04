#!/usr/bin/env python3
'''
The benchmark of zephyr_tpu_torch on NVIDIA GPUs: one run of one cell.

    python3 port_bench/run.py --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json and the port. The
cell's configuration, traffic mix, window driver and metrics are found
by the names in BENCHMARK.json (see harness.py). A run:

1. sets up: the kernel library (built into the checkout's build/ on the
   first run there), the medium from the seed, the operators and a
   warm-up of every shape the window uses (``setup_s``, from the start
   of this process);
2. runs the window: whole batches or steps back to back until --seconds
   have passed, ended by a device synchronise (--trace 1: under
   torch.profiler, for at most the traffic's ``trace_seconds``);
3. reads the device's peak memory, frees the program's state, and
   compares what the window produced with the plain reference
   (``reference/``): ``correct`` holds when every number compared is
   within its limit (the traffic file's ``limits``);
4. prints the metrics (end-to-end untraced, per-layer traced) as one
   JSON line, last on stdout, with the numbers compared last of all.

It exits with a non-zero code and prints no result when there is no
CUDA device, fewer than the cell asks for, or when jax, jaxlib, flax or
the JAX package zephyr_tpu was loaded.
'''

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run(args, device='cuda', t_start=T_START):
    '''
    One run; returns the exit code. ``device='cpu'`` is for the tests:
    it skips the look for a card, and the device readings are left out.
    '''
    import torch
    import harness
    import tracing

    bench = harness.benchmark()
    entry, config, traffic = harness.cell(bench, args.workload)
    if device != 'cpu':
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from zephyr_tpu_torch.ops import cuda_kernels
        cuda_kernels.build()
    driver = harness.load_module('drivers', traffic['driver'])
    cell = driver.Cell(config, traffic, args.seed, device)
    on_card = device != 'cpu'
    harness.sync(device)
    setup_s = time.perf_counter() - t_start

    breakdown = None
    if args.trace:
        seconds = min(args.seconds, traffic['trace_seconds'])
        if on_card:
            record, prof = tracing.traced(lambda: cell.window(seconds))
            record['profile'] = prof
            breakdown = tracing.breakdown(prof)
        else:
            record = cell.window(seconds)
    else:
        record = cell.window(args.seconds)
    record['setup_s'] = setup_s
    dev = {'platform': 'gpu' if on_card else 'cpu',
           'kind': torch.cuda.get_device_name() if on_card else 'cpu',
           'count': int(entry['chips'])}
    if on_card:
        dev['memory_peak_bytes'] = int(torch.cuda.max_memory_allocated())
        if args.trace:
            dev['busy_s'] = record['profile']['busy_s']
            dev['window_s'] = record['profile']['window_s']

    cell.release()
    t0 = time.perf_counter()
    values = cell.check(record)
    check_s = time.perf_counter() - t0
    limits = traffic['limits']
    checks = {k: (values[k], limits[k]) for k in limits}
    correct = all(harness.finite(v) and v <= lim
                  for v, lim in checks.values())

    metrics = {}
    for m in harness.metrics_of(bench, args.workload, bool(args.trace)):
        v = harness.load_module('metrics', m['name']).read(record)
        if v is not None:
            metrics[m['name']] = {'value': v, 'unit': m['unit']}

    found = harness.forbidden_modules()
    if found:
        print('port_bench: loaded in this process: %s' % ', '.join(found),
              file=sys.stderr)
        return 3
    if on_card:
        print('card: %s; peaks: %s' % (harness.card_line(),
                                      harness.load_json(os.path.join(
                                          HERE, 'peaks.json'))['source']),
              file=sys.stderr)
    print('window: %s; reference %.3f s%s'
          % (_window_line(record), check_s,
             _trace_line(record['profile']) if 'profile' in record else ''),
          file=sys.stderr)
    harness.result_line(correct, record['attempted'], record['failed'],
                        metrics, dev, checks, breakdown)
    return 0


def _trace_line(prof):
    return ('; trace read %.3f s: %d device events, %d of the port\'s '
            'kernels, %d launches recorded (trace %d)'
            % (prof['read_s'], prof['device_events'],
               prof['port_kernel_events'], len(prof['launches']),
               prof['attempts']))


def _window_line(record):
    units = record['units']
    its = [u['iters'] for u in units]
    worst = [u['relres'] for u in units if u['failed']]
    parts = ', '.join('%s %.3f s' % kv
                      for kv in record.get('setup_parts', {}).items())
    return ('%d units in %.3f s (set-up %.3f s%s); iterations %s; relres of '
            'the failed units %s'
            % (len(units), record['window_s'], record['setup_s'],
               ': ' + parts if parts else '', its, worst))


def main(argv=None):
    args = parse(argv)
    import torch
    if not torch.cuda.is_available():
        print('port_bench: no CUDA device; the benchmark runs only on the '
              'card', file=sys.stderr)
        return 2
    import harness
    entry = harness.cell(harness.benchmark(), args.workload)[0]
    if torch.cuda.device_count() < int(entry['chips']):
        print('port_bench: %s needs %d devices, %d found'
              % (args.workload, entry['chips'], torch.cuda.device_count()),
              file=sys.stderr)
        return 2
    return run(args)


if __name__ == '__main__':
    sys.exit(main())
