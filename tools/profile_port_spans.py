#!/usr/bin/env python3
'''
Where the device time and the idle time of a modelling window go, by the
port's program spans (``zephyr_tpu_torch.utils.profiling``), on one CUDA
GPU:

    python3 tools/profile_port_spans.py [--workload marmousi-model-20hz]
        [--seed N] [--seconds 5] [--pairs 2] [--out PATH]

It sets up a cell of the benchmark as ``port_bench/run.py`` does (the
configuration, traffic mix, medium, operator and warm-up of
``port_bench``), with the program's tracing on from before the cell is
built, so the set-up spans are kept. Then it runs ``--pairs`` pairs of
windows over the same batches, each under ``torch.profiler``, one with
the program's tracing off and one with it on, in turns (off, on, on,
off, ...), after a window that is not counted (a process's first
profiled window runs slower). Of each window with tracing on it

1. pairs every span with the profiler's range event of its name, in
   order (complete when the counts by name agree), and gives the spread
   of the offset between the span's ``perf_counter_ns`` start and its
   event's;
2. puts each device event down to the innermost span that encloses the
   runtime call that launched it (by correlation id), or to "outside",
   and counts the device time it cannot link;
3. puts each idle gap of the device down to the innermost span that
   spans the gap's midpoint on the host, or to "outside";

and reads, per outer Krylov iteration: the device ms launched in
``krylov.step``'s own time (outside ``krylov.matvec`` and
``precond.apply``; ``krylov.sync`` counts as its own), the device ms
under ``precond.apply``, the idle ms put down to ``krylov.step`` /
``krylov.sync`` and to ``precond.*``, ``solver.syncs``; the share of
the iterations whose BiCGStab step ran fused (``krylov.fused_steps``,
K11, over the window's iterations: 100 where every step took it, a
little more with the overrun steps); the share of fused steps issued
after every lane of their loop had stopped (``krylov.overrun_steps``
over the iterations: the cost of reading the stop flags a step late);
the share of lane-iterations spent on right-hand sides that had
stopped (from the chunks' ``lane_iters``); and
``helmholtz.prepare_operator``'s seconds.
Of every window: ms an iteration (host clock), the device's idle share
(device-side annotations are no activity), and each batch's iterations
and worst relres, which tracing must leave as they are.

``--device cpu --tiny`` rehearses it on the CPU at 48 x 144 (no device
events there). Prints the card's name and power limit first and one
JSON line last, which ``--out`` also gets.
'''

import argparse
import bisect
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, 'port_bench'), ROOT]

import harness  # noqa: E402
from tracing import is_fft, is_port_kernel  # noqa: E402
from zephyr_tpu_torch.utils import profiling  # noqa: E402

WINDOW = 'profile_port_spans.window'


def tiny(config, traffic):
    'The CPU rehearsal size of port_bench/tests/tiny.py.'
    config = dict(config, grid={'nz': 48, 'nx': 144})
    config['shots'] = {'x0_cells': 20.0, 'dx_cells': 3.25, 'count': 32,
                       'z_cells': 16}
    config['receivers'] = {'x0_cells': 14.0, 'dx_cells': 4.0, 'count': 30,
                           'z_cells': 16}
    traffic = dict(traffic, freq_hz=150.0 / config['spacing_m'])
    return config, traffic


def profiled_window(cell, start, seconds, traced, device):
    '''
    One window from batch ``start`` under the profiler, the program's
    tracing on or off: (window record, kineto events, spans opened in the
    window, counters' increments over it).
    '''
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device != 'cpu':
        acts.append(ProfilerActivity.CUDA)
    harness.sync(device)
    cell.next = start
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            if traced:
                with profiling.recording() as rec:
                    mark, before = len(rec.spans), dict(rec.counters)
                    record = cell.window(seconds)
                    harness.sync(device)
            else:
                record = cell.window(seconds)
                harness.sync(device)
    events = list(prof.profiler.kineto_results.events())
    if not traced:
        return record, events, [], {}
    counters = {k: v - before.get(k, 0) for k, v in rec.counters.items()}
    return record, events, rec.spans[mark:], counters


def analyse(events, spans, names):
    '''
    Pair the window's spans with the profiler's range events, and put the
    device time and the idle gaps down to spans. Returns a dict.
    '''
    host, dev, runtime = [], [], {}
    w0 = w1 = None
    for e in events:
        name = e.name()
        t0, t1 = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # the profiler mirrors every record_function range onto the
            # device's timeline: that is no activity
            annot = getattr(e, 'is_user_annotation', None)
            if (annot is not None and annot()) or name in names \
                    or name == WINDOW:
                continue
            dev.append((t0, t1, name, e.correlation_id()))
        elif name == WINDOW:
            w0, w1 = t0, t1
        elif name in names:
            host.append((t0, t1, name))
        elif name.startswith('cu'):
            runtime[e.correlation_id()] = t0
    if w0 is None:
        raise RuntimeError('no %s event in the trace' % WINDOW)
    dev = sorted(d for d in dev if d[1] > w0 and d[0] < w1)
    host.sort()

    # 1. pairing by name, in order
    by_name = {}
    for t0, t1, name in host:
        by_name.setdefault(name, []).append((t0, t1))
    counts_span, counts_event = {}, {}
    for s in spans:
        counts_span[s.name] = counts_span.get(s.name, 0) + 1
    for name, v in by_name.items():
        counts_event[name] = len(v)
    complete = counts_span == counts_event
    rank, ev = {}, [None] * len(spans)
    offsets = []
    for i, s in enumerate(spans):
        k = rank[s.name] = rank.get(s.name, -1) + 1
        if k < len(by_name.get(s.name, ())):
            ev[i] = by_name[s.name][k]
            offsets.append(s.start - ev[i][0])
    idx = {s.id: i for i, s in enumerate(spans)}
    starts = [e[0] if e else -1 for e in ev]
    order = sorted(range(len(spans)), key=lambda i: starts[i])
    sorted_starts = [starts[i] for i in order]

    def innermost(t):
        'The innermost paired span that spans host time t, or None.'
        j = bisect.bisect_right(sorted_starts, t) - 1
        i = order[j] if j >= 0 else None
        while i is not None:
            if ev[i] is not None and ev[i][0] <= t <= ev[i][1]:
                return i
            p = spans[i].parent
            i = idx.get(p) if p is not None else None
        return None

    def label(i):
        return 'outside' if i is None else spans[i].name

    def ancestors(i):
        out = set()
        while i is not None:
            out.add(spans[i].name)
            p = spans[i].parent
            i = idx.get(p) if p is not None else None
        return out

    # 2. device time by the span that launched it (self time)
    dev_by_span, algebra_by_span = {}, {}
    dev_total = unlinked = under_precond = 0
    for t0, t1, name, corr in dev:
        d = min(t1, w1) - max(t0, w0)
        dev_total += d
        t = runtime.get(corr)
        if t is None:
            unlinked += d
            lab = 'unlinked'
            i = None
        else:
            i = innermost(t)
            lab = label(i)
        dev_by_span[lab] = dev_by_span.get(lab, 0) + d
        if not is_port_kernel(name) and not is_fft(name):
            algebra_by_span[lab] = algebra_by_span.get(lab, 0) + d
        if i is not None and 'precond.apply' in ancestors(i):
            under_precond += d

    # 3. idle gaps by the span around their midpoint
    busy, gaps, cur1, last = 0, [], None, w0
    cur0 = None
    for t0, t1, _, _ in dev:
        t0, t1 = max(t0, w0), min(t1, w1)
        if cur1 is None or t0 > cur1:
            if cur1 is not None:
                busy += cur1 - cur0
            if t0 > last:
                gaps.append((last, t0))
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
        last = max(last, cur1)
    if cur1 is not None:
        busy += cur1 - cur0
    if w1 > last:
        gaps.append((last, w1))
    idle_by_span = {}
    for g0, g1 in gaps:
        lab = label(innermost((g0 + g1) // 2))
        idle_by_span[lab] = idle_by_span.get(lab, 0) + (g1 - g0)
    idle = sum(g1 - g0 for g0, g1 in gaps)
    s = 1e-9
    return {'complete': complete, 'spans': len(spans),
            'events_missing': {k: counts_span.get(k, 0)
                               - counts_event.get(k, 0)
                               for k in set(counts_span) | set(counts_event)
                               if counts_span.get(k, 0)
                               != counts_event.get(k, 0)},
            'offset_us': _spread(offsets),
            'window_s': (w1 - w0) * s, 'device_s': dev_total * s,
            'busy_s': busy * s, 'idle_s': idle * s,
            'idle_split_s': sum(idle_by_span.values()) * s,
            'unlinked_share': unlinked / dev_total if dev_total else None,
            'device_events': len(dev),
            'device_by_span': {k: v * s for k, v in dev_by_span.items()},
            'algebra_by_span': {k: v * s for k, v in algebra_by_span.items()},
            'idle_by_span': {k: v * s for k, v in idle_by_span.items()},
            'under_precond_s': under_precond * s}


def _spread(offsets):
    '''
    The offsets' spread in us: the whole range, and the range from the
    1st to the 99th percentile (a thread put off the core between the two
    clock readings makes a single outlier).
    '''
    if not offsets:
        return None
    o = sorted(offsets)
    lo, hi = o[len(o) // 100], o[-1 - len(o) // 100]
    return {'range': (o[-1] - o[0]) * 1e-3, 'p1_p99': (hi - lo) * 1e-3,
            'outliers_above_50us': sum(1 for v in o if v - o[0] > 50000),
            'n': len(o)}


def lane_waste(spans):
    '''
    Percent of lane-iterations spent on right-hand sides that had
    stopped: 1 - sum of every lane's iterations over R x the chunks'
    maxima, over the window's chunks.
    '''
    done = full = 0
    for s in spans:
        if s.name == 'helmholtz.chunk':
            lanes = s.attrs['lane_iters']
            done += sum(lanes)
            full += len(lanes) * max(lanes)
    return 100.0 * (1.0 - done / full) if full else None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', default='marmousi-model-20hz')
    ap.add_argument('--seed', type=int, default=2 ** 31 + 7)
    ap.add_argument('--seconds', type=float, default=5.0)
    ap.add_argument('--pairs', type=int, default=2)
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--tiny', action='store_true')
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    device = args.device
    if device != 'cpu' and not torch.cuda.is_available():
        print('profile_port_spans: no CUDA device', file=sys.stderr)
        return 2
    card = harness.card_line() if device != 'cpu' else 'cpu'
    print('card: %s' % card, flush=True)
    t_start = time.perf_counter()
    bench = harness.benchmark()
    _, config, traffic = harness.cell(bench, args.workload)
    if args.tiny:
        config, traffic = tiny(config, traffic)
    driver = harness.load_module('drivers', traffic['driver'])
    with profiling.recording() as rec:
        if device != 'cpu':
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            from zephyr_tpu_torch.ops import cuda_kernels
            cuda_kernels.build()
        cell = driver.Cell(config, traffic, args.seed, device)
        harness.sync(device)
        setup_spans = list(rec.spans)
    setup_s = time.perf_counter() - t_start
    setup = {}
    for s in setup_spans:
        if s.parent is None or s.name == 'kernels.load':
            setup[s.name] = setup.get(s.name, 0.0) + (s.end - s.start) * 1e-9
    print('set-up %.3f s; spans at the top of it: %s'
          % (setup_s, ', '.join('%s %.3f s' % kv for kv in setup.items())),
          flush=True)

    names = set()
    windows = []
    start = cell.next
    # the profiler's first window in a process runs slower: not counted
    profiled_window(cell, start, args.seconds, False, device)
    for k in range(2 * args.pairs):
        traced = (k % 4) in (1, 2)
        record, events, spans, counters = profiled_window(
            cell, start, args.seconds, traced, device)
        names |= {s.name for s in spans}
        iters = sum(u['iters'] for u in record['units'])
        w = {'traced': traced, 'batches': [(u['iters'], u['relres'])
                                           for u in record['units']],
             'iters': iters, 'window_s': record['window_s'],
             'ms_per_iter': 1e3 * record['window_s'] / iters}
        if traced:
            a = analyse(events, spans, names)
            per = 1e3 / iters
            dbs, ibs = a['device_by_span'], a['idle_by_span']
            w.update(analysis=a, readings={
                'krylov_algebra_ms_per_iter': per * (
                    dbs.get('krylov.step', 0) + dbs.get('krylov.sync', 0)),
                'precond_ms_per_iter': per * a['under_precond_s'],
                'krylov_idle_ms_per_iter': per * (
                    ibs.get('krylov.step', 0) + ibs.get('krylov.sync', 0)),
                'precond_idle_ms_per_iter': per * sum(
                    v for n, v in ibs.items() if n.startswith('precond.')),
                'lane_waste': lane_waste(spans),
                'syncs_per_iter': counters.get('solver.syncs', 0) / iters,
                'fused_step_share': 100.0 * counters.get(
                    'krylov.fused_steps', 0) / iters,
                'overrun_step_share': 100.0 * counters.get(
                    'krylov.overrun_steps', 0) / iters,
                'algebra_ms_per_iter': per * sum(
                    a['algebra_by_span'].values())})
        if device != 'cpu':
            a = w.get('analysis') or analyse(events, [], names)
            w['device_idle'] = 100.0 * (1.0 - a['busy_s'] / a['window_s'])
        windows.append(w)
        print('window %d (tracing %s): %s' % (k, 'on' if traced else 'off',
                                              json.dumps(w)), flush=True)
        del events
    # only the number of batches may differ, at the window's edge
    n = min(len(w['batches']) for w in windows)
    out = {'card': card, 'workload': args.workload, 'seed': args.seed,
           'setup_s': setup_s, 'setup_spans_s': setup,
           'prepare_operator_s': setup.get('helmholtz.prepare_operator'),
           'same_answers': all(w['batches'][:n] == windows[0]['batches'][:n]
                               for w in windows),
           'windows': windows}
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, 'w') as f:
            f.write(line + '\n')
    print(line)
    return 0


if __name__ == '__main__':
    sys.exit(main())
