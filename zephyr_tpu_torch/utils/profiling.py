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
- ``span`` / ``add`` / ``recording``: the program's spans and counters.
  Off (the default) a ``span`` or ``add`` reads one module flag and
  returns; inside a ``recording()`` block each span is kept in memory
  (id, parent id, name, start and end on ``time.perf_counter_ns``,
  attributes), is a ``record_function`` range (under an active profiler,
  a host range event on the profiler's clock that encloses the launches
  it made) and an NVTX range on the card; each counter is summed.
  ``annotate`` is a span that is always on.
'''

import contextlib
import functools
import os
import tempfile
import threading
import time
from collections import defaultdict

import torch

_STATS = defaultdict(lambda: {'calls': 0, 'total': 0.0, 'max': 0.0})
#: the active Record, or None: tracing is off
_REC = None
#: whether spans push NVTX ranges (a card is present); found at first use
_NVTX = None


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


class Record:
    '''
    What a ``recording()`` block saw: ``spans``, every Span in the order
    it was opened (a span's ``id`` is its index here), and ``counters``,
    {name: sum of what ``add`` gave}. A span's ``parent`` is the id of
    the innermost span open in the same thread when it opened, or None.
    '''

    def __init__(self):
        self.spans = []
        self.counters = {}
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self):
        stack = getattr(self._local, 'stack', None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def seconds(self, prefix='', since=0):
        '''
        {name without ``prefix``: summed seconds} of the closed spans from
        ``spans[since]`` on whose names start with ``prefix``: by their
        CUDA events where they recorded some (see ``span``), else by the
        host clock. Waits for those events.
        '''
        out = {}
        for s in self.spans[since:]:
            if s.end is None or not s.name.startswith(prefix):
                continue
            if s.events is not None:
                s.events[1].synchronize()
                t = s.events[0].elapsed_time(s.events[1]) * 1e-3
            else:
                t = (s.end - s.start) * 1e-9
            key = s.name[len(prefix):]
            out[key] = out.get(key, 0.0) + t
        return out


class Span:
    '''
    One named region: a ``record_function`` range, an NVTX range on a
    machine with a card, and, inside a ``recording()`` block, an entry of
    its Record. ``set(**attrs)`` adds attributes before it closes.
    '''

    __slots__ = ('name', 'attrs', 'id', 'parent', 'start', 'end', 'events',
                 '_rec', '_rf', '_cuda')

    def __init__(self, name, attrs, rec, cuda=None):
        self.name, self.attrs, self._rec, self._cuda = name, attrs, rec, cuda
        self.id = self.parent = self.start = self.end = self.events = None

    def set(self, **attrs):
        self.attrs.update(attrs)

    def __enter__(self):
        global _NVTX
        rec = self._rec
        if rec is not None:
            stack = rec._stack()
            self.parent = stack[-1] if stack else None
            with rec._lock:
                self.id = len(rec.spans)
                rec.spans.append(self)
            stack.append(self.id)
        if _NVTX is None:
            _NVTX = torch.cuda.is_available()
        if _NVTX:
            torch.cuda.nvtx.range_push(self.name)
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        if self._cuda is not None:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(torch.cuda.current_stream(self._cuda))
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self._cuda))
        self._rf.__exit__(*exc)
        if _NVTX:
            torch.cuda.nvtx.range_pop()
        if self._rec is not None:
            self._rec._stack().pop()
        return False


class _Off:
    'The shared span of a run with tracing off: it does nothing.'

    __slots__ = ()

    def set(self, **attrs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name, cuda=None, **attrs):
    '''
    A span named ``name`` with attributes ``attrs``, as a context manager
    (see the module's docstring). Off, the shared no-op. ``cuda``, a CUDA
    device: the span is also timed by two CUDA events on that device's
    current stream (``Record.seconds`` reads them), with no synchronise.
    '''
    rec = _REC
    if rec is None:
        return _OFF
    return Span(name, attrs, rec, cuda)


def add(counter, n=1):
    'Add ``n`` to the counter ``counter`` of the active Record (off: nothing).'
    rec = _REC
    if rec is None:
        return
    with rec._lock:
        rec.counters[counter] = rec.counters.get(counter, 0) + n


def enabled():
    'Whether a ``recording()`` block is active.'
    return _REC is not None


@contextlib.contextmanager
def recording():
    '''
    Turn tracing on for the block and yield its Record. Inside another
    recording block it yields the active Record and leaves tracing on.
    '''
    global _REC
    if _REC is not None:
        yield _REC
        return
    _REC = Record()
    try:
        yield _REC
    finally:
        _REC = None


def annotate(name):
    '''
    Named region visible in traces (``torch.profiler.record_function``)
    and, on a machine with a CUDA device, an NVTX range of the same name:
    a span that is always on (kept in the Record while one is active).
    '''
    return Span(name, {}, _REC)
