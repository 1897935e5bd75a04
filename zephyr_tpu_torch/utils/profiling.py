'''
Tracing and profiling for zephyr_tpu_torch: the port of
``zephyr_tpu.utils.profiling``.

- ``timeIt`` / ``count``: drop-in decorators with aggregated reporting
  (a plain wall clock, as in the JAX package: a timed call that only
  enqueues work on the card measures the enqueue)
- ``trace``: context manager around ``torch.profiler`` (CPU activity,
  and the card's when there is one), writing a Chrome trace into
  ``logdir`` that TensorBoard and Perfetto read
- ``annotate``: named regions that show up in those traces (and as NVTX
  ranges on the card)
'''

import atexit
import contextlib
import functools
import os
import tempfile
import time
from collections import defaultdict

import torch

_STATS = defaultdict(lambda: {'calls': 0, 'total': 0.0, 'max': 0.0})
_REPORT_AT_EXIT = False


def timeIt(fn):
    'Decorator: accumulate wall-clock stats per function.'

    key = getattr(fn, '__qualname__', fn.__name__)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            dt = time.perf_counter() - t0
            st = _STATS[key]
            st['calls'] += 1
            st['total'] += dt
            st['max'] = max(st['max'], dt)

    return wrapper


def count(fn):
    'Decorator: count invocations.'

    key = getattr(fn, '__qualname__', fn.__name__)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        _STATS[key]['calls'] += 1
        return fn(*args, **kwargs)

    return wrapper


def stats():
    'A copy of the accumulated timing statistics.'
    return {k: dict(v) for k, v in _STATS.items()}


def report():
    'Print the accumulated timing statistics.'
    if not _STATS:
        return
    width = max(len(k) for k in _STATS)
    print('%-*s %8s %12s %12s' % (width, 'function', 'calls',
                                  'total (s)', 'max (s)'))
    for key in sorted(_STATS, key=lambda k: -_STATS[k]['total']):
        st = _STATS[key]
        print('%-*s %8d %12.4f %12.4f'
              % (width, key, st['calls'], st['total'], st['max']))


def report_at_exit():
    global _REPORT_AT_EXIT
    if not _REPORT_AT_EXIT:
        atexit.register(report)
        _REPORT_AT_EXIT = True


@contextlib.contextmanager
def trace(logdir=None):
    '''
    Capture a ``torch.profiler`` trace around a code block: host activity
    and, when a CUDA device is present, the card's kernels and copies.
    On exit the trace is written into ``logdir`` (default
    ``zephyr_tpu_torch_trace`` in the temporary directory, ``/tmp``
    unless TMPDIR says otherwise) as a Chrome trace,
    ``<worker>.<time>.pt.trace.json``
    (``torch.profiler.tensorboard_trace_handler``). Yields ``logdir``.
    '''
    logdir = logdir or os.path.join(tempfile.gettempdir(),
                                    'zephyr_tpu_torch_trace')
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield logdir


@contextlib.contextmanager
def annotate(name):
    '''
    Named region visible in traces (``torch.profiler.record_function``)
    and, on a machine with a CUDA device, an NVTX range of the same name.
    '''
    nvtx = (torch.cuda.nvtx.range(name) if torch.cuda.is_available()
            else contextlib.nullcontext())
    with nvtx, torch.profiler.record_function(name):
        yield
