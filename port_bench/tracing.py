'''
The traced window: ``torch.profiler`` over whole batches or steps, and
a record of every launch of the port's CUDA kernels (the wrapper of
``zephyr_tpu_torch.ops.cuda_kernels._launch``, through which each of
them goes, keeps the kernel's name and its integer arguments, which hold
its shapes). The trace is read from the profiler's raw events, in
memory; nothing is written to disk.

``summary`` gives the readers in ``metrics/``: the device's busy time
(the union of its activity) and the window, device seconds by kernel
name, the port's kernels' seconds and launches, and the host's activity
during each idle gap.
'''

import bisect
import sys
import time

import torch

WINDOW = 'port_bench.window'
#: the port's kernels are named zt_<name>_kernel; cuFFT's carry "fft"
PORT_KERNEL = ('zt_', '_kernel')
FFT_KEYS = ('fft', 'FFT')


class LaunchLog:
    'Records (name, int args) of every port kernel launch while active.'

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from zephyr_tpu_torch.ops import cuda_kernels as ck
        self._ck, self._orig = ck, ck._launch
        calls, orig = self.calls, self._orig

        def launch(name, fn, *args):
            calls.append((name, tuple(int(a) if a is not None else 0
                                      for a in args)))
            return orig(name, fn, *args)

        ck._launch = launch
        return self

    def __exit__(self, *exc):
        self._ck._launch = self._orig
        return False


def traced(run, attempts=2):
    '''
    Run ``run()`` under the profiler and the launch log; returns
    (run's value, summary dict). A trace that lacks some of the window's
    launches of the port's kernels (the profiler dropped device records,
    as it may when the host stalls while its buffers fill) cannot be
    read soundly: the window is run and traced again, up to ``attempts``
    times in all, and the last trace is returned as it is.
    '''
    for attempt in range(1, attempts + 1):
        value, out = _traced_once(run)
        if out['complete']:
            break
        print('port_bench: trace %d of at most %d holds %d of the window\'s '
              '%d launches of the port\'s kernels%s'
              % (attempt, attempts, out['port_kernel_events'],
                 len(out['launches']),
                 '; tracing the window again' if attempt < attempts else ''),
              file=sys.stderr)
    out['attempts'] = attempt
    return value, out


def _traced_once(run):
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with LaunchLog() as log:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with torch.profiler.record_function(WINDOW):
                value = run()
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = summary(prof.profiler.kineto_results.events(), wall)
    del prof
    out['launches'] = log.calls
    out['complete'] = out['port_kernel_events'] == len(log.calls)
    out['read_s'] = time.perf_counter() - t0
    return value, out


def is_port_kernel(name):
    return all(k in name for k in PORT_KERNEL)


def is_fft(name):
    return any(k in name for k in FFT_KEYS)


def summary(events, wall):
    dev, host = [], []
    w0 = w1 = None
    for e in events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # the window's own annotation is mirrored on the device's
            # timeline: it is no activity
            if name == WINDOW:
                continue
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
        else:
            if name == WINDOW:
                w0, w1 = e.start_ns(), e.start_ns() + e.duration_ns()
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
    if w0 is None:
        raise RuntimeError('port_bench: the traced window has no %s event'
                           % WINDOW)
    dev = [d for d in dev if d[1] > w0 and d[0] < w1]
    dev.sort()
    by_name = {}
    port_s = algebra_s = 0.0
    port_n = 0
    for s, e, name in dev:
        t = (e - s) * 1e-9
        by_name[name] = by_name.get(name, 0.0) + t
        if is_port_kernel(name):
            port_s += t
            port_n += 1
        elif not is_fft(name):
            algebra_s += t
    # the union of device activity, and the gaps between
    busy, gaps = 0.0, []
    cur0 = cur1 = None
    last = w0
    for s, e, _ in dev:
        s, e = max(s, w0), min(e, w1)
        if cur1 is None or s > cur1:
            if cur1 is not None:
                busy += cur1 - cur0
            if s > last:
                gaps.append((last, s))
            cur0, cur1 = s, e
        else:
            cur1 = max(cur1, e)
        last = max(last, cur1)
    if cur1 is not None:
        busy += cur1 - cur0
    if w1 > last:
        gaps.append((last, w1))
    return {'window_s': wall, 'trace_window_s': (w1 - w0) * 1e-9,
            'device_events': len(dev), 'busy_s': busy * 1e-9, 'device_by_name': by_name,
            'port_kernel_s': port_s, 'port_kernel_events': port_n,
            'algebra_s': algebra_s,
            'idle_by_host': _label_gaps(gaps, host)}


def _label_gaps(gaps, host):
    '''
    {host activity: idle seconds}: each gap is put to the innermost host
    event (the latest begun) that spans its midpoint, or "none".
    '''
    host = sorted(h for h in host if h[2] != WINDOW)
    starts = [h[0] for h in host]
    out = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        i = bisect.bisect_right(starts, mid) - 1
        label = 'none'
        for j in range(i, max(i - 2000, -1), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        out[label] = out.get(label, 0.0) + (g1 - g0) * 1e-9
    return out


def breakdown(summ, top=10):
    'The ``breakdown`` of the result line: ten of each, largest first.'
    ops = sorted(summ['device_by_name'].items(), key=lambda kv: -kv[1])
    gaps = sorted(summ['idle_by_host'].items(), key=lambda kv: -kv[1])
    return {'device_ops': [[k[:120], v] for k, v in ops[:top]],
            'idle_gaps': [[k[:120], v] for k, v in gaps[:top]]}
