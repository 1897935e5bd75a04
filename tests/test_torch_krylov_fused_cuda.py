'''
K11 (``csrc/k11_bicgstab.cu``, the fused BiCGStab recurrence) on the
card, complex64. Marked ``cuda``: without an NVIDIA GPU and nvcc they
skip. On a machine with one (where jax is not installed, add
``--noconftest``):

    python -m pytest tests/test_torch_krylov_fused_cuda.py -q

- Each kernel against its plain twin (``krylov_kernels.*_ref``) from the
  same fields and the same state, at R = 16 on 2304 x 768 (the
  benchmark's batch) and at a ragged R = 3 on 37 x 61. Fields within
  1e-5 of the twin's largest magnitude (float32 arithmetic, which the
  compiler may contract to FMA). A lane's dot, the sum of its block
  partials, within 2e-5 of the sum of its terms' magnitudes: both sides
  sum float32 products, the kernel in runs of at most ~110 a thread and
  the twin by torch's cascade, whose error is bounded by that many ulps of
  the magnitudes' sum (cancellation makes it large against the dot
  itself). The scalars a kernel derives (alpha', omega', rho', ||r||)
  equal, within 1e-5 relative, what its own finished dots give on the
  host; flags equal.
- Two runs of the kernels on one input are bit for bit the same.
- On chip_smoke's homogeneous and Marmousi-class media at 512^2, 8
  point sources, production config: one unrestarted solve to 1e-4, and
  the chunked solve to tol, which takes the fused path on every step
  (``krylov.fused_steps`` and ``KRYLOV_LAUNCHES``), reaches true relres
  <= tol and gives the same iterations and x bit for bit in two runs.
  Every lane's iterations against the eager path's (``fused=False``):
  within 2 on the homogeneous medium; on the Marmousi-class one, where
  float32 counts move with rounding, just above the most that the eager
  path's own lane counts moved on the card under 1-ulp changes of b and
  under another summation order of its dots (``LANE_BAND``).
- The same chunked solves with the driver's lagged stop check (the
  flags of the step before last, read through pinned memory and an
  event) against a loop that reads every lane's flags before each step
  (written here): x, iterations, relres and every chunk's reading bit
  for bit equal, and each BiCGStab loop issues exactly one step more than
  its iterations when every lane stopped before maxiter, none when it
  ran to maxiter. Once on the default stream and once on another.
'''

import functools

import numpy as np
import pytest
import torch

from zephyr_tpu_torch.ops import krylov_kernels as kk
from zephyr_tpu_torch.utils import profiling as pf

pytestmark = pytest.mark.cuda
SHAPES = [(16, 768, 2304), (3, 37, 61)]
FIELD_TOL = 1e-5
DOT_TOL = 2e-5
MAXITER = 50
#: the most a lane's iterations may differ between the fused and the
#: eager path (``_counts_agree``), by medium and solve. Marmousi-class:
#: just above the most the eager recurrence's own lane counts moved on
#: the card (NVIDIA H100, these solves) when b moved by one ulp (8 draws)
#: or its dots were summed in another order (in float64; reversed), 11
#: unrestarted and 23 chunked; the fused path read 10 and 18 there
LANE_BAND = {'hom': {'unrestarted': 2, 'chunked': 2},
             'marmousi': {'unrestarted': 12, 'chunked': 24}}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels run on the card)')
    return torch.device('cuda', 0)


def _fields(dev, R, nz, nx, n):
    gen = torch.Generator().manual_seed(R * 7 + nz)
    return [torch.complex(torch.randn((R, 1, nz, nx), generator=gen),
                          torch.randn((R, 1, nz, nx), generator=gen)).to(dev)
            for _ in range(n)]


def _copy_state(dst, src):
    dst.sc.copy_(src.sc)
    dst.fl.copy_(src.fl)
    dst.part.copy_(src.part)


def _close(out, ref):
    scale = float(torch.max(torch.abs(ref)))
    return float(torch.max(torch.abs(out - ref))) <= FIELD_TOL * scale


def _c(st, row):
    return torch.complex(st.sc[row], st.sc[row + 1]).to(torch.complex128)


def _lane_dots(st, k, n):
    'The first n lane sums of a state\'s partials, from k: (n, R) float64.'
    return st.part[k:k + n].sum(-1)


def _terms(*pairs):
    'Sum of |conj(a) b| a lane, float64, for each (a, b).'
    return [torch.sum(torch.abs(a.conj() * b).double().reshape(
        a.shape[0], -1), 1) for a, b in pairs]


def _dots_close(st_k, st_t, k, mags):
    got = _lane_dots(st_k, k, len(mags))
    ref = _lane_dots(st_t, k, len(mags))
    for i, m in enumerate(mags):
        assert torch.all(torch.abs(got[i] - ref[i]) <= DOT_TOL * m), i


def _safe_div(num, den):
    bad = torch.abs(den) < torch.finfo(torch.float32).tiny
    return torch.where(bad, torch.zeros_like(num),
                       num / torch.where(bad, torch.ones_like(den), den))


def _rel_close(got, ref, tol=1e-5):
    return bool(torch.all(torch.abs(got - ref) <= tol * torch.abs(ref)))


def _run(st, b, r, p, v, s, t, phat, shat, x):
    'Every kernel once from the given fields (updated in place): rhat.'
    rhat = kk.prologue(b, r, st, MAXITER)
    kk.update_p(r, p, v, st)
    kk.dot_rv(rhat, v, st)
    kk.update_s(r, v, s, st)
    kk.dots_ts(t, s, st)
    kk.update_xr(rhat, x, r, s, t, phat, shat, st, MAXITER)
    return rhat


@pytest.mark.parametrize('R,nz,nx', SHAPES)
def test_kernels_match_twins(dev, R, nz, nx):
    b, r, p, v, s, t, phat, shat, x = _fields(dev, R, nz, nx, 9)
    tol = torch.full((R,), 1e-3, device=dev)
    st_k, st_t = kk.State(b, tol), kk.State(b, tol)
    kk.reset_launches()

    rhat = kk.prologue(b, r, st_k, MAXITER)
    rhat_t = torch.empty_like(r)
    kk.prologue_ref(b, r, rhat_t, st_t, MAXITER)
    assert torch.equal(rhat, r) and torch.equal(rhat_t, r)
    bb, rr = _terms((b, b), (r, r))
    _dots_close(st_k, st_t, 0, [bb, rr])
    bk, rk = _lane_dots(st_k, 0, 2)
    assert _rel_close(st_k.sc[kk.BNORM].double(), torch.sqrt(bk))
    assert _rel_close(st_k.sc[kk.RNORM].double(), torch.sqrt(rk))
    assert _rel_close(st_k.sc[kk.RHON].double(), rk)
    assert torch.equal(st_k.fl, st_t.fl) and bool(st_k.fl[kk.ACT].all())

    # p: same state on both sides
    _copy_state(st_t, st_k)
    p_t = p.clone()
    kk.update_p(r, p, v, st_k)
    kk.update_p_ref(r, p_t, v, st_t)
    assert _close(p, p_t)

    _copy_state(st_t, st_k)
    kk.dot_rv(rhat, v, st_k)
    kk.dot_rv_ref(rhat, v, st_t)
    _dots_close(st_k, st_t, 0, _terms((rhat, v)) * 2)
    re, im = _lane_dots(st_k, 0, 2)
    assert _rel_close(_c(st_k, kk.ALPHAN),
                      _safe_div(_c(st_k, kk.RHON), torch.complex(re, im)))
    assert torch.equal(st_k.fl, st_t.fl)

    _copy_state(st_t, st_k)
    s_t = s.clone()
    kk.update_s(r, v, s, st_k)
    kk.update_s_ref(r, v, s_t, st_t)
    assert _close(s, s_t)

    _copy_state(st_t, st_k)
    kk.dots_ts(t, s, st_k)
    kk.dots_ts_ref(t, s, st_t)
    tt, ts = _terms((t, t), (t, s))
    _dots_close(st_k, st_t, 0, [tt, ts, ts])
    tk, re, im = _lane_dots(st_k, 0, 3)
    assert _rel_close(_c(st_k, kk.OMEGAN),
                      _safe_div(torch.complex(re, im),
                                torch.complex(tk, torch.zeros_like(tk))))

    _copy_state(st_t, st_k)
    x_t, r_t = x.clone(), r.clone()
    rhon = _c(st_k, kk.RHON)
    kk.update_xr(rhat, x, r, s, t, phat, shat, st_k, MAXITER)
    kk.update_xr_ref(rhat, x_t, r_t, s, t, phat, shat, st_t, MAXITER)
    assert _close(x, x_t) and _close(r, r_t)
    hr, rr = _terms((rhat, r_t), (r_t, r_t))
    _dots_close(st_k, st_t, 0, [hr, hr, rr])
    re, im, rk = _lane_dots(st_k, 0, 3)
    assert _rel_close(_c(st_k, kk.RHON), torch.complex(re, im))
    assert _rel_close(st_k.sc[kk.RNORM].double(), torch.sqrt(rk))
    assert torch.equal(_c(st_k, kk.RHO), rhon)
    assert torch.equal(st_k.fl, st_t.fl)
    assert st_k.fl[kk.KIT].tolist() == [1] * R
    assert kk.KRYLOV_LAUNCHES == {k: 1 for k in kk.KRYLOV_LAUNCHES}


def test_frozen_lanes_untouched(dev):
    'A lane with act 0 keeps its fields and its state.'
    R, nz, nx = 3, 37, 61
    b, r, p, v, s, t, phat, shat, x = _fields(dev, R, nz, nx, 9)
    st = kk.State(b, 1e-3)
    rhat = kk.prologue(b, r, st, MAXITER)
    st.fl[kk.ACT, 1] = 0
    before = [f[1].clone() for f in (p, s, x, r)]
    sc, fl = st.sc[:, 1].clone(), st.fl[:, 1].clone()
    kk.update_p(r, p, v, st)
    kk.dot_rv(rhat, v, st)
    kk.update_s(r, v, s, st)
    kk.dots_ts(t, s, st)
    kk.update_xr(rhat, x, r, s, t, phat, shat, st, MAXITER)
    for f, keep in zip((p, s, x, r), before):
        assert torch.equal(f[1], keep)
    assert torch.equal(st.sc[:, 1], sc) and torch.equal(st.fl[:, 1], fl)
    assert st.fl[kk.KIT].tolist() == [1, 0, 1]


@pytest.mark.parametrize('R,nz,nx', SHAPES)
def test_two_runs_bit_identical(dev, R, nz, nx):
    fields = _fields(dev, R, nz, nx, 9)
    outs = []
    for _ in range(2):
        f = [a.clone() for a in fields]
        st = kk.State(f[0], 1e-3)
        rhat = _run(st, *f)
        outs.append((st.sc.clone(), st.fl.clone(), st.part.clone(), rhat,
                     *f))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.fixture(scope='module', params=['hom', 'marmousi'])
def medium(request):
    '''(name, cfg, op, M, b): chip_smoke's homogeneous or Marmousi-class
    medium at 512^2, the production config, 8 point sources, on the
    card.'''
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels run on the card)')
    import chip_smoke as cs
    from zephyr_tpu_torch.solver.helmholtz import (
        _make_precond, resolve_panels, resolve_solver_config)
    c_np = cs.MEDIA[request.param](512)
    cfg = resolve_panels(resolve_solver_config(cs.PRODUCTION,
                                               torch.complex64), c_np)
    op, _ = cs.scalar_operator(c_np, cfg)
    return (request.param, cfg, op, _make_precond(op, cfg),
            cs.point_sources(512, 8))


def _lane_iters(rec):
    '''Every lane's iterations over a chunked solve's chunks (the
    ``lane_iters`` of its ``helmholtz.chunk`` spans).'''
    spans = [s for s in rec.spans if s.name == 'helmholtz.chunk']
    return torch.tensor([s.attrs['lane_iters'] for s in spans]).sum(0)


def _counts_agree(name, kind, fused, eager):
    '''
    Every lane's iterations on the fused and on the eager path within
    LANE_BAND[name][kind]: 2 on the homogeneous medium (where both read
    the same counts, or 1 apart); on the Marmousi-class one float32
    counts move with rounding, and the band is set just above the most
    that the eager path's own lane counts moved under rounding alone.
    '''
    diff = torch.abs(torch.as_tensor(fused) - torch.as_tensor(eager))
    return int(torch.max(diff)) <= LANE_BAND[name][kind]


def test_unrestarted_solve(medium):
    '''
    One BiCGStab solve to 1e-4 (no restart): the fused path's counts,
    lane for lane, against the eager recurrence's (``_counts_agree``).
    '''
    from zephyr_tpu_torch.ops.stencil import apply_block_stencil_fast
    from zephyr_tpu_torch.solver.krylov import bicgstab
    name, cfg, op, M, b = medium

    def solve(fused):
        return bicgstab(lambda u: apply_block_stencil_fast(op.planes, u),
                        b, M=M, tol=1e-4, maxiter=300, fused=fused)
    kk.reset_launches()
    fused = solve(True)
    # every lane converges: one overrun step after the last
    steps = int(torch.max(fused.iters)) + 1
    assert kk.KRYLOV_LAUNCHES['bicgstab_xr'] == steps
    eager = solve(False)
    assert kk.KRYLOV_LAUNCHES['bicgstab_xr'] == steps
    assert bool(torch.all(fused.relres <= 1e-4))
    assert bool(torch.all(eager.relres <= 1e-4))
    assert _counts_agree(name, 'unrestarted', fused.iters.cpu(),
                         eager.iters.cpu()), (fused.iters, eager.iters)


def _chunked(medium, fused, monkeypatch):
    from zephyr_tpu_torch.solver import helmholtz
    _, cfg, op, _, b = medium
    if not fused:
        monkeypatch.setattr(helmholtz, 'bicgstab', functools.partial(
            helmholtz.bicgstab, fused=False))
    kk.reset_launches()
    trace = []
    try:
        with pf.recording() as rec:
            x, iters, relres = helmholtz.make_chunked_solver(
                cfg, chunk=32)(op, b, trace=trace)
    finally:
        monkeypatch.undo()
    return (x, iters, relres, trace, rec.counters, dict(kk.KRYLOV_LAUNCHES),
            _lane_iters(rec))


def test_chunked_solve(medium, monkeypatch):
    '''
    The chunked solve to tol 1e-5 (restarts every 32): the fused path
    takes every step, reaches tol (relres is the worst TRUE relres, b - A
    x, after the last chunk), repeats bit for bit, and every lane's
    iterations agree with the eager path's (``_counts_agree``).
    '''
    name, tol = medium[0], medium[1].tol
    x, iters, relres, trace, counters, launches, lanes = _chunked(
        medium, True, monkeypatch)
    assert np.isfinite(relres) and relres <= tol
    # each loop that every lane left before maxiter runs one step more
    overruns = counters['krylov.overrun_steps']
    assert counters['krylov.fused_steps'] == iters + overruns
    assert launches['bicgstab_xr'] == launches['bicgstab_p'] == (
        iters + overruns)
    assert launches['bicgstab_prologue'] == len(trace)
    x2, iters2, _, trace2, _, _, lanes2 = _chunked(medium, True, monkeypatch)
    assert trace2 == trace and iters2 == iters and torch.equal(x2, x)
    assert torch.equal(lanes2, lanes)
    _, iters_e, relres_e, _, counters_e, launches_e, lanes_e = _chunked(
        medium, False, monkeypatch)
    assert 'krylov.fused_steps' not in counters_e
    assert not any(launches_e.values())
    assert relres_e <= tol
    assert _counts_agree(name, 'chunked', lanes, lanes_e), (lanes, lanes_e)


def _one_read_a_step(matvec, b, M=None, tol=1e-6, maxiter=1000):
    '''
    The fused driver as it was before the lagged read: a blocking read
    of every lane's act before each step (``bicgstab``'s arguments, as
    the chunked solver passes them).
    '''
    from zephyr_tpu_torch.solver import krylov
    b = krylov._dense(b)
    x = torch.zeros_like(b)
    r = krylov._dense(b - matvec(x))
    st = kk.State(b, tol)
    rhat = kk.prologue(b, r, st, maxiter)
    p, v, s = (torch.zeros_like(b) for _ in range(3))
    for _ in range(maxiter):
        if not bool(st.act().cpu().any()):
            break
        kk.update_p(r, p, v, st)
        phat = krylov._dense(M(p))
        v = krylov._dense(matvec(phat))
        kk.dot_rv(rhat, v, st)
        kk.update_s(r, v, s, st)
        shat = krylov._dense(M(s))
        t = krylov._dense(matvec(shat))
        kk.dots_ts(t, s, st)
        kk.update_xr(rhat, x, r, s, t, phat, shat, st, maxiter)
    return krylov.BicgstabResult(x, st.iters(), st.relres())


def _chunked_loops(medium, solver, monkeypatch, stream=None):
    '''
    The chunked solve to tol with ``solver`` as its BiCGStab, on
    ``stream`` (default: the current one): (x, iters, relres, trace,
    counters, [(K11 steps issued, the loop's iterations, its maxiter)]
    for each BiCGStab loop).
    '''
    from zephyr_tpu_torch.solver import helmholtz
    _, cfg, op, _, b = medium
    loops = []

    def counted(matvec, r, M=None, tol=1e-6, maxiter=1000):
        before = kk.KRYLOV_LAUNCHES['bicgstab_xr']
        res = solver(matvec, r, M=M, tol=tol, maxiter=maxiter)
        loops.append((kk.KRYLOV_LAUNCHES['bicgstab_xr'] - before,
                      int(torch.max(res.iters)), maxiter))
        return res
    monkeypatch.setattr(helmholtz, 'bicgstab', counted)
    trace = []
    torch.cuda.synchronize()
    try:
        with pf.recording() as rec, torch.cuda.stream(
                stream or torch.cuda.current_stream()):
            x, iters, relres = helmholtz.make_chunked_solver(
                cfg, chunk=32)(op, b, trace=trace)
        torch.cuda.synchronize()
    finally:
        monkeypatch.undo()
    return x, iters, relres, trace, rec.counters, loops


@pytest.mark.parametrize('on', ['default_stream', 'other_stream'])
def test_lagged_read_bit_for_bit(medium, monkeypatch, on):
    '''
    The driver's lagged stop check against the one-read-a-step loop on
    the chunked solve: the same answers bit for bit, and each loop's
    overrun (K11 steps issued over its iterations) is 1 where every lane
    stopped before maxiter and 0 where the loop ran to maxiter.
    '''
    from zephyr_tpu_torch.solver.krylov import bicgstab
    stream = torch.cuda.Stream() if on == 'other_stream' else None
    x, iters, relres, trace, counters, loops = _chunked_loops(
        medium, bicgstab, monkeypatch, stream)
    x_r, iters_r, relres_r, trace_r, _, loops_r = _chunked_loops(
        medium, _one_read_a_step, monkeypatch)
    assert torch.equal(x, x_r)
    assert iters == iters_r and relres == relres_r and trace == trace_r
    assert relres <= medium[1].tol
    assert [its for _, its, _ in loops] == [its for _, its, _ in loops_r]
    for (steps, its, maxiter), (steps_r, _, _) in zip(loops, loops_r):
        assert steps_r == its
        assert steps - its == (0 if its == maxiter else 1)
    overruns = sum(steps - its for steps, its, _ in loops)
    assert overruns >= 1            # the last loop converges
    assert counters['krylov.overrun_steps'] == overruns
    assert counters['krylov.fused_steps'] == iters + overruns
