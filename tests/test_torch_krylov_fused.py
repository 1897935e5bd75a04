'''
The fused BiCGStab recurrence (``solver.krylov._bicgstab_fused`` over
``ops.krylov_kernels``) driven by the kernels' plain torch twins on the
CPU, held against the eager recurrence (``krylov._bicgstab``) in
complex128: every lane's iterations equal, x within 1e-12 relative and
relres within 1e-10 relative. The two sum their dots in another order
(block partials, and ||r||^2 as a sum of |r|^2), so they may differ by
rounding only: x by 3e-16 here, relres (about 1e-10, a residual left
after cancellation) by up to 3e-13.

Cases: every lane active; per-lane tolerances as the chunked solver
passes them (lanes stop at different steps); a lane with b = 0; a lane
whose operator breaks the recurrence down at its first step; the
fixed-step solve of ``bicgstab_fixed``; a solve that ends on maxiter
with every lane active; each lane's dots summed from the plan's two
block partials (48 x 40).

The driver reads the lanes' stop flags one step late; over the same
cases (and at the loop's edges: maxiter 0, every lane stopped before the
first step, the last lane stopping on the last step or the one before)
it gives x, iters and relres bit for bit equal to the loop that reads
them before every step (written here from the twins), with at most one
overrun step, none when the loop ends on maxiter.

Also: the CUDA-only conditions of the path and what it refuses, dense
copies of strided and conjugate inputs, the unrestarted solve's eager
recurrence, the chunked solver's restart from its best iterate, the
block plan, and the kernels' names and state rows in the source.
'''

import re
from pathlib import Path

import pytest
import torch

from zephyr_tpu_torch.ops import krylov_kernels as kk
from zephyr_tpu_torch.ops import stencil
from zephyr_tpu_torch.solver import krylov
from zephyr_tpu_torch.utils import profiling as pf

R, NZ, NX = 4, 48, 40
SOURCE = (Path(kk.__file__).resolve().parent.parent / 'csrc'
          / 'k11_bicgstab.cu')


def _operator(breakdown_lane=None):
    '''
    (matvec, M) on (R, 1, NZ, NX) complex128: a random 9-point stencil
    with a dominant centre (so BiCGStab takes 15-30 steps) and Jacobi. On
    ``breakdown_lane`` the operator is a half-grid roll of the columns,
    which moves a field held in the left half into the right half:
    <rhat, A M r> is then exactly 0 at the first step.
    '''
    gen = torch.Generator().manual_seed(11)
    planes = torch.complex(torch.randn((9, NZ, NX), generator=gen,
                                       dtype=torch.float64),
                           torch.randn((9, NZ, NX), generator=gen,
                                       dtype=torch.float64))
    planes[4] += 8 + 2j
    dinv = 1.0 / planes[4]

    def matvec(u):
        out = stencil.apply_stencil(planes, u[:, 0])[:, None]
        if breakdown_lane is not None:
            rolled = torch.roll(u, NX // 2, dims=-1)
            lane = torch.zeros((u.shape[0], 1, 1, 1), dtype=torch.bool)
            lane[breakdown_lane] = True
            out = torch.where(lane, rolled, out)
        return out

    return matvec, lambda r: dinv * r


def _rhs(zero_lane=None, left_lane=None):
    gen = torch.Generator().manual_seed(5)
    b = torch.complex(torch.randn((R, 1, NZ, NX), generator=gen,
                                  dtype=torch.float64),
                      torch.randn((R, 1, NZ, NX), generator=gen,
                                  dtype=torch.float64))
    if zero_lane is not None:
        b[zero_lane] = 0
    if left_lane is not None:
        b[left_lane, ..., NX // 2:] = 0
    return b


def _lane_tol(matvec, b, tol=1e-10):
    'The chunked solver\'s per-lane tolerance, from a rough first iterate.'
    x = 0.01 * b
    r = b - matvec(x)
    rnorm = krylov._norm(r)
    return 0.7 * tol * krylov._norm(b) / torch.clamp(
        rnorm, min=torch.finfo(rnorm.dtype).tiny) * torch.tensor(
        [1.0, 1e2, 1e4, 1e-1], dtype=torch.float64), r


CASES = ['all_active', 'lane_tol', 'zero_rhs', 'breakdown', 'fixed',
         'ends_on_maxiter']


def _case(name):
    'matvec, M, b, tol, maxiter, fixed of a case.'
    if name == 'breakdown':
        matvec, M = _operator(breakdown_lane=2)
        return matvec, M, _rhs(left_lane=2), 1e-10, 200, False
    matvec, M = _operator()
    if name == 'lane_tol':
        tol, r = _lane_tol(matvec, _rhs())
        return matvec, M, r, tol, 200, False
    if name == 'zero_rhs':
        return matvec, M, _rhs(zero_lane=1), 1e-10, 200, False
    if name == 'fixed':
        tol = torch.tensor([1e-4, 1e-12, 1e-5, 1e-12], dtype=torch.float64)
        return matvec, M, _rhs(), tol, 12, True
    if name == 'ends_on_maxiter':
        return matvec, M, _rhs(), 1e-10, 8, False
    return matvec, M, _rhs(), 1e-10, 200, False


def _rel(a, b):
    'Per-lane ||a - b|| / ||b|| (0 where both vanish).'
    d = krylov._norm(a - b)
    n = krylov._norm(b)
    return torch.where(n > 0, d / torch.where(n > 0, n, 1.0), d)


@pytest.mark.parametrize('case', CASES)
def test_fused_twins_match_eager(case):
    matvec, M, b, tol, maxiter, fixed = _case(case)
    eager = krylov._bicgstab(matvec, b, M, None, tol, maxiter, fixed)
    before = dict(kk.KRYLOV_LAUNCHES)
    fused = krylov._bicgstab_fused(matvec, b, M, None, tol, maxiter, fixed)
    assert kk.KRYLOV_LAUNCHES == before     # CPU tensors: the twins
    assert fused.iters.dtype == eager.iters.dtype == torch.int32
    assert torch.equal(fused.iters, eager.iters), (fused.iters, eager.iters)
    assert float(torch.max(_rel(fused.x, eager.x))) <= 1e-12
    assert torch.allclose(fused.relres, eager.relres, rtol=1e-10, atol=0)
    its = fused.iters.tolist()
    if case == 'all_active':
        assert min(its) >= 10 and max(fused.relres) <= 1e-10
    elif case == 'lane_tol':
        assert len(set(its)) == R           # every lane stops on its own
    elif case == 'zero_rhs':
        assert its[1] == 0 and not torch.any(fused.x[1])
    elif case == 'breakdown':
        assert its[2] == 1 and not torch.any(fused.x[2])
        assert min(its[:2] + its[3:]) >= 10
    elif case == 'fixed':
        assert max(its) == 12 and min(its) < 12     # a lane froze early
    elif case == 'ends_on_maxiter':
        assert its == [8] * R


def _one_read_a_step(matvec, b, M, tol, maxiter, fixed):
    '''
    The fused driver as it was before the lagged read, on the twins: a
    blocking read of every lane's act before each step (none when
    ``fixed``), and the loop ends on the first that finds none active.
    (BicgstabResult, the steps it ran).
    '''
    b = krylov._dense(b)
    x = torch.zeros_like(b)
    r = krylov._dense(b - matvec(x))
    st = kk.State(b, tol)
    rhat = kk.prologue(b, r, st, maxiter)
    p, v, s = (torch.zeros_like(b) for _ in range(3))
    steps = 0
    for _ in range(maxiter):
        if not fixed and not bool(st.act().cpu().any()):
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
        steps += 1
    return krylov.BicgstabResult(x, st.iters(), st.relres()), steps


def _lagged_against_one_read(matvec, M, b, tol, maxiter, fixed):
    '''
    The lagged driver and ``_one_read_a_step`` on one solve: x, iters and
    relres bit for bit equal, and the lagged driver's steps those of the
    other plus its overruns. (the lagged result, its counters, the other
    loop's steps).
    '''
    ref, steps = _one_read_a_step(matvec, b, M, tol, maxiter, fixed)
    with pf.recording() as rec:
        got = krylov._bicgstab_fused(matvec, b, M, None, tol, maxiter,
                                     fixed)
    assert torch.equal(got.x, ref.x)
    assert torch.equal(got.iters, ref.iters)
    assert torch.equal(got.relres, ref.relres)
    if fixed:
        assert rec.counters == {} and steps == maxiter
    else:
        assert rec.counters.get('krylov.fused_steps', 0) == (
            steps + rec.counters['krylov.overrun_steps'])
    return got, rec.counters, steps


@pytest.mark.parametrize('case', CASES)
def test_lagged_read_matches_one_read_a_step(case):
    '''
    The lagged stop check changes no answer: x, iters and relres equal
    the one-read-a-step loop's bit for bit. At most one overrun step when
    every lane stops before maxiter, none when the loop ends on it.
    '''
    matvec, M, b, tol, maxiter, fixed = _case(case)
    got, counters, steps = _lagged_against_one_read(matvec, M, b, tol,
                                                    maxiter, fixed)
    if fixed:
        return
    if int(torch.max(got.iters)) == maxiter:
        assert counters['krylov.overrun_steps'] == 0
    else:
        assert steps < maxiter
        assert counters['krylov.overrun_steps'] == 1


@pytest.mark.parametrize('edge,overrun', [
    ('no_step', 0),             # maxiter 0: nothing issued, nothing read
    ('none_active', 1),         # b = 0: the first step finds every lane done
    ('stops_before_last', 1),   # the overrun is the loop's last step
    ('stops_on_last', 0),       # the last lane's k reaches maxiter
    ('stops_two_before', 1)])
def test_lagged_read_at_the_loops_edges(edge, overrun):
    '''
    Where the loop ends next to its edges, the lagged driver still equals
    the one-read-a-step loop bit for bit and counts its overrun exactly;
    its host reads are as many as that loop's.
    '''
    matvec, M, b, tol, _, _ = _case('all_active')
    last = int(torch.max(krylov._bicgstab_fused(matvec, b, M, None, tol,
                                                200, False).iters))
    maxiter = {'no_step': 0, 'none_active': 200, 'stops_before_last':
               last + 1, 'stops_on_last': last, 'stops_two_before':
               last + 2}[edge]
    if edge == 'none_active':
        b = torch.zeros_like(b)
    got, counters, steps = _lagged_against_one_read(matvec, M, b, tol,
                                                    maxiter, False)
    assert counters['krylov.overrun_steps'] == overrun
    assert counters.get('solver.syncs', 0) == min(steps + 1, maxiter)
    if edge == 'none_active':
        assert steps == 0 and not torch.any(got.x)


def test_fused_counts_steps_and_syncs():
    '''
    Tracing on (the twins): a solve that converges after ``steps`` steps
    issues one more, the overrun, which the host learns of at the next
    check; one sync a step issued, one span a step and one for that check.
    '''
    matvec, M, b, tol, maxiter, fixed = _case('all_active')
    with pf.recording() as rec:
        fused = krylov._bicgstab_fused(matvec, b, M, None, tol, maxiter,
                                       fixed)
    steps = int(torch.max(fused.iters))
    assert rec.counters == {'krylov.fused_steps': steps + 1,
                            'krylov.overrun_steps': 1,
                            'solver.syncs': steps + 1}
    names = [s.name for s in rec.spans]
    assert names.count('krylov.step') == steps + 2
    assert names.count('krylov.sync') == steps + 1
    assert names.count('krylov.matvec') == 2 * (steps + 1)


def test_fused_x0_left_as_it_was():
    matvec, M, b, tol, maxiter, fixed = _case('all_active')
    x0 = 0.5 * b
    keep = x0.clone()
    eager = krylov._bicgstab(matvec, b, M, x0, tol, maxiter, fixed)
    fused = krylov._bicgstab_fused(matvec, b, M, x0, tol, maxiter, fixed)
    assert torch.equal(x0, keep)
    assert torch.equal(fused.iters, eager.iters)
    assert float(torch.max(_rel(fused.x, eager.x))) <= 1e-12


def test_engages_only_on_cuda_complex64():
    '''
    K11 serves CUDA complex64 batches; State refuses a batch it cannot
    serve rather than leave it to the eager recurrence.
    '''
    b = torch.zeros((2, 1, 4, 4), dtype=torch.complex64)
    assert not kk.on_card(b)                        # on the CPU
    assert not kk.on_card(b.to(torch.complex128))
    assert kk.State(b[:, 0], 1e-3).N == 16          # any lane shape
    with pytest.raises(ValueError):
        kk.State(b[:0], 1e-3)
    with pytest.raises(ValueError):
        kk.State(torch.zeros((kk.MAX_LANES + 1, 1), dtype=torch.complex64),
                 1e-3)


def test_fused_reads_dense_copies():
    '''
    A conjugate-view b and a strided complex64 x0: the fused driver
    solves what they hold (as the eager recurrence does from dense
    complex128 copies) and leaves x0 as it was.
    '''
    matvec, M, b, tol, maxiter, fixed = _case('all_active')
    b_view = b.conj_physical().conj()
    assert b_view.is_conj()
    x0 = (0.5 * b).to(torch.complex64).transpose(-1, -2).contiguous()
    x0 = x0.transpose(-1, -2)
    assert not x0.is_contiguous()
    keep = x0.clone()
    eager = krylov._bicgstab(matvec, b, M, x0.to(torch.complex128), tol,
                             maxiter, fixed)
    fused = krylov._bicgstab_fused(matvec, b_view, M, x0, tol, maxiter,
                                   fixed)
    assert torch.equal(x0, keep)
    assert torch.equal(fused.iters, eager.iters)
    assert float(torch.max(_rel(fused.x, eager.x))) <= 1e-12


def test_fused_refuses_what_it_cannot_serve():
    '''A b that autograd would differentiate through, an x0 of another
    shape: errors, not a silent eager solve.'''
    matvec, M, b, tol, maxiter, fixed = _case('all_active')
    with pytest.raises(ValueError, match='differentiable'):
        krylov._bicgstab_fused(matvec, b.clone().requires_grad_(), M, None,
                               tol, maxiter, fixed)
    with pytest.raises(ValueError, match='x0'):
        krylov._bicgstab_fused(matvec, b, M, b[:, :, :-1], tol, maxiter,
                               fixed)


def test_unrestarted_solve_keeps_eager(monkeypatch):
    '''
    With the CPU batch standing for a card's (``on_card`` forced),
    ``bicgstab`` takes the fused driver and ``_krylov_solve`` (the
    unrestarted solve of ``solve_info`` / ``solve_batched``, which checks
    no true residual) the eager recurrence.
    '''
    from zephyr_tpu_torch.solver import helmholtz as th
    matvec, M, b, tol, maxiter, fixed = _case('all_active')
    monkeypatch.setattr(kk, 'on_card', lambda b: True)
    with pf.recording() as rec:
        fused = krylov.bicgstab(matvec, b, M=M, tol=tol, maxiter=maxiter)
    # every lane converges: one overrun step after the last
    assert rec.counters['krylov.fused_steps'] == int(
        torch.max(fused.iters)) + 1
    cfg = th.SolverConfig(tol=tol, maxiter=maxiter)
    with pf.recording() as rec:
        eager = th._krylov_solve(matvec, b, M, cfg, 1)
    assert 'krylov.fused_steps' not in rec.counters
    assert torch.equal(fused.iters, eager.iters)


def _chunked_case():
    '''(cfg, op, b): a 48 x 40 two-layer medium, the production config,
    two point sources, complex128 on the CPU.'''
    from zephyr_tpu_torch.ops.minizephyr_coeff import minizephyr_planes
    from zephyr_tpu_torch.solver import helmholtz as th
    cfg = th.SolverConfig(tol=1e-5, maxiter=2000, mg_coarse='inv',
                          mg_min_size=10, fft_mode='strat', fft_scale=2,
                          hybrid_comp='fused', mg_nu1=2, mg_nu2=1)
    c = torch.full((NZ, NX), 1500.0, dtype=torch.complex128)
    c[NZ // 2:] = 2400.0
    rho = torch.ones((NZ, NX), dtype=torch.float64)
    p = minizephyr_planes(c, rho, 150.0)[None, None]
    pp = minizephyr_planes(th.shifted_velocity(c, cfg.shift), rho, 150.0,
                           pml_cap=cfg.pml_cap)[None, None]
    b = torch.zeros((2, 1, NZ, NX), dtype=torch.complex128)
    b[0, 0, 16, 28] = b[1, 0, 30, 10] = 1.0
    return cfg, th.prepare_operator(p, pp, cfg), b


def test_chunked_guard_goes_back_and_doubles(monkeypatch):
    '''
    A BiCGStab chunk that leaves the true residual more than 4x worse than
    the best (forced: the second chunk's update is spoiled): the chunked
    solver goes back to the best iterate, runs the chunks after it twice
    as long, and still reaches tol within its iteration budget.
    '''
    from zephyr_tpu_torch.solver import helmholtz as th
    cfg, op, b = _chunked_case()
    real, lengths = th.bicgstab, []

    def spoiled(matvec, r, M=None, tol=1e-6, maxiter=1000):
        res = real(matvec, r, M=M, tol=tol, maxiter=maxiter)
        lengths.append(maxiter)
        return res._replace(x=100 * res.x) if len(lengths) == 2 else res
    monkeypatch.setattr(th, 'bicgstab', spoiled)
    trace = []
    x, iters, relres = th.make_chunked_solver(cfg, chunk=8)(op, b,
                                                           trace=trace)
    assert trace[1][1] > 4 * trace[0][1]
    assert lengths[:3] == [8, 8, 16] and set(lengths[2:]) == {16}
    assert len(trace) == len(lengths) and sum(lengths) <= cfg.maxiter
    assert relres <= cfg.tol and bool(torch.isfinite(x).all())
    true = krylov._norm(b - th.apply_block_stencil_fast(op.planes, x))
    assert float(torch.max(true / krylov._norm(b))) == pytest.approx(
        relres, rel=1e-9)


@pytest.mark.parametrize('R_,N,expect', [
    (16, 2304 * 768, (66, 26880)),      # the benchmark's batch
    (16, 64 * 64, (4, 1024)),           # a coarse level
    (1, 2304 * 768, (988, 1792)),       # one lane: the most blocks
    (3, 37 * 61, (3, 768)),
    (R, NZ * NX, (2, 1024)),            # the cases above
    (1, 5, (1, 256))])
def test_plan(R_, N, expect):
    G, C = kk.plan(R_, N)
    assert (G, C) == expect
    assert C % kk.THREADS == 0 and (G - 1) * C < N <= G * C


def test_kernel_source_names_and_rows():
    '''
    The kernels are named zk_...: the benchmark counts a kernel with
    "zt_" in its name as one of K1-K9, and one with "fft" as cuFFT's. The
    source numbers the state's rows as the module does.
    '''
    src = SOURCE.read_text()
    kernels = re.findall(r'__global__ void __launch_bounds__\(\w+\) (\w+)\(',
                         src)
    assert len(kernels) == 6
    for name in kernels + re.findall(r'struct (\w+)', src):
        assert name.startswith(('zk_', 'Zk')), name
        assert 'zt_' not in name and 'fft' not in name.lower()
    sc = dict(re.findall(r'(\w+) = (\d+)', re.search(
        r'enum \{ RHO = .*?\};', src, re.S).group(0)))
    fl = dict(re.findall(r'(\w+) = (\d+)', re.search(
        r'enum \{ ACT = .*?\};', src, re.S).group(0)))
    for name, row in list(sc.items()) + list(fl.items()):
        assert getattr(kk, name) == int(row), name
