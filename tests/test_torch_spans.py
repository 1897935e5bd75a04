'''
The port's spans and counters (``zephyr_tpu_torch.utils.profiling``:
``span``, ``add``, ``recording``) at the solve's layer boundaries, on the
CPU with the kernels' torch twins, production solver config cut to a
48 x 40 two-layer model.

- Off: nothing is recorded, and a profiler over a solve sees no program
  range.
- On: spans nest as the solver's layers do (the preparation's parts under
  ``helmholtz.prepare_operator``; chunk, Krylov step, host sync, matvec,
  preconditioner and its parts down from ``helmholtz.solve``), and each
  span is exactly one profiler range event of its name, in order, inside
  its parent's event.
- Tracing changes no answer: x, iters, relres and the ``trace=`` list are
  bit for bit the same on and off.
- A chunk's span holds every right-hand side's iterations and true
  relres; their maximum is the chunk's.
- ``solver.syncs`` equals the device-to-host reads the solve made,
  counted on a tensor subclass that stands for the device.

Nothing here depends on timing: the suite runs beside other workers.
'''

import sys

import pytest
import torch

from zephyr_tpu_torch.ops.minizephyr_coeff import minizephyr_planes
from zephyr_tpu_torch.solver import helmholtz as th
from zephyr_tpu_torch.utils import profiling as pf

NZ, NX, FREQ = 48, 40, 150.
PRODUCTION = dict(tol=1e-5, maxiter=2000, mg_coarse='inv', mg_min_size=10,
                  fft_mode='strat', fft_scale=2, hybrid_comp='fused',
                  mg_nu1=2, mg_nu2=1)
SOURCES = ((16, 28), (30, 10), (10, 10))

#: span -> the span it opens under (None: at the top)
PARENT = {'helmholtz.prepare_operator': None,
          'multigrid.build_hierarchy': 'helmholtz.prepare_operator',
          'helmholtz.coarsen_true': 'helmholtz.prepare_operator',
          'stratified.precompute': 'helmholtz.prepare_operator',
          'helmholtz.solve': None,
          'helmholtz.chunk': 'helmholtz.solve',
          'helmholtz.true_residual': 'helmholtz.chunk',
          'krylov.step': 'helmholtz.chunk',
          'krylov.sync': 'krylov.step',
          'krylov.matvec': 'krylov.step',
          'precond.apply': 'krylov.step',
          'precond.fine': 'precond.apply',
          'precond.spectral': 'precond.apply',
          'precond.coarse': 'precond.apply'}


def _config(**kw):
    return th.SolverConfig(**dict(PRODUCTION, **kw))


def _operator(cfg):
    c = torch.full((NZ, NX), 1500., dtype=torch.complex64)
    c[NZ // 2:] = 2400.
    rho = torch.ones((NZ, NX))
    p = minizephyr_planes(c, rho, FREQ)[None, None]
    pp = minizephyr_planes(th.shifted_velocity(c, cfg.shift), rho, FREQ,
                           pml_cap=cfg.pml_cap)[None, None]
    return th.prepare_operator(p, pp, cfg, with_transpose=False)


def _rhs():
    b = torch.zeros((len(SOURCES), 1, NZ, NX), dtype=torch.complex64)
    for i, (z, x) in enumerate(SOURCES):
        b[i, 0, z, x] = 1.0
    return b


def _solve(b=None, cfg=None):
    'Prepare the operator, run the chunked solve: (x, iters, relres, trace).'
    cfg = cfg or _config()
    trace = []
    x, iters, relres = th.make_chunked_solver(cfg, chunk=8)(
        _operator(cfg), _rhs() if b is None else b, trace=trace)
    return x, iters, relres, trace


def _profiled(fn):
    'fn() under torch.profiler: (its value, [(name, start_ns, end_ns)]).'
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        value = fn()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    return value, events


def test_off_records_nothing():
    assert not pf.enabled()
    assert pf.span('krylov.step') is pf.span('precond.apply', R=3)
    pf.add('solver.syncs')
    _, events = _profiled(_solve)
    assert not {name for name, _, _ in events} & set(PARENT)
    with pf.recording() as rec:
        pass
    assert rec.spans == [] and rec.counters == {}


def test_spans_nest_and_pair_with_profiler_ranges():
    with pf.recording() as rec:
        _, events = _profiled(_solve)
    names = {s.name for s in rec.spans}
    assert names == set(PARENT)
    for i, s in enumerate(rec.spans):
        assert s.id == i and s.end is not None
        parent = None if s.parent is None else rec.spans[s.parent].name
        assert parent == PARENT[s.name], (s.name, parent)
    # each span is the one range event of its name at its rank, inside
    # its parent's event
    ranges = {}
    for name, t0, t1 in sorted(events, key=lambda e: e[1]):
        if name in PARENT:
            ranges.setdefault(name, []).append((t0, t1))
    paired, rank = {}, {}
    for s in rec.spans:
        assert len(ranges[s.name]) == sum(1 for t in rec.spans
                                          if t.name == s.name)
        k = rank[s.name] = rank.get(s.name, -1) + 1
        paired[s.id] = ranges[s.name][k]
        if s.parent is not None:
            p0, p1 = paired[s.parent]
            t0, t1 = paired[s.id]
            assert p0 <= t0 and t1 <= p1, s.name


def test_tracing_changes_no_answer():
    off = _solve()
    with pf.recording():
        on = _solve()
    assert torch.equal(on[0], off[0])
    assert on[1:] == off[1:]
    assert len(off[3]) > 1


def test_chunk_spans_hold_every_lane():
    with pf.recording() as rec:
        _, iters, relres, trace = _solve()
    chunks = [s for s in rec.spans if s.name == 'helmholtz.chunk']
    assert [(s.attrs['iterations'], s.attrs['relres'])
            for s in chunks] == trace
    for s in chunks:
        assert len(s.attrs['lane_iters']) == len(SOURCES)
        assert max(s.attrs['lane_iters']) == s.attrs['iterations']
        assert max(s.attrs['lane_relres']) == s.attrs['relres']
    assert sum(s.attrs['iterations'] for s in chunks) == iters
    assert chunks[-1].attrs['relres'] == relres
    solve = [s for s in rec.spans if s.name == 'helmholtz.solve']
    assert [s.attrs for s in solve] == [{'R': len(SOURCES), 'chunk': 8}]


#: the tensor methods that read a tensor's values to the host
READS = (torch.Tensor.cpu, torch.Tensor.__float__, torch.Tensor.__int__,
         torch.Tensor.__bool__, torch.Tensor.item, torch.Tensor.tolist)


class _OnDevice(torch.Tensor):
    '''
    A tensor that stands for one on the device: what is computed from it
    stays one, a read of its values (READS) is counted by the file and
    line that made it, and ``cpu()`` gives a plain (host) tensor.
    '''

    reads = []

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func not in READS:
            return super().__torch_function__(func, types, args, kwargs)
        caller = sys._getframe(1)
        cls.reads.append((caller.f_code.co_filename, caller.f_lineno))
        with torch._C.DisableTorchFunctionSubclass():
            out = func(*args, **(kwargs or {}))
        return (out.as_subclass(torch.Tensor) if func is torch.Tensor.cpu
                else out)


def _reads(fn, traced):
    'fn() with tracing on or off: (its Record or None, the reads it made).'
    _OnDevice.reads = []
    if not traced:
        fn()
        return None, _OnDevice.reads
    with pf.recording() as rec:
        fn()
    return rec, _OnDevice.reads


@pytest.mark.parametrize('krylov', ['bicgstab', 'gmres'])
def test_syncs_count_every_host_read(krylov):
    b = _rhs().as_subclass(_OnDevice)
    if krylov == 'gmres':
        # restarted GMRES: one read a cycle
        cfg = _config(krylov='gmres', gmres_restart=8, maxiter=64)
        op = _operator(cfg)

        def fn():
            th.solve_info(op, b, cfg)
    else:
        def fn():
            _solve(b)
    _, off = _reads(fn, False)
    rec, on = _reads(fn, True)
    assert off and {f.rsplit('/', 1)[-1] for f, _ in off} <= {
        'krylov.py', 'helmholtz.py'}
    # on, the lanes ride with a read that is made off too
    assert len(on) == len(off)
    assert rec.counters == {'solver.syncs': len(on)}
