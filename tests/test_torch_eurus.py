'''
Port parity of the Eurus TTI forward path: zephyr_tpu_torch against
zephyr_tpu on the CPU, complex128 unless stated, on a 41x56 grid cut to
three multigrid levels by mg_min_size=16, two right-hand sides.

Tolerances (each test states its own):
- plane builder: rel 1e-12 (the same arithmetic, rounding order only);
- block apply, block PCR, line states, V-cycles, GMRES cycles: rel 1e-10
  (the block PCR's clamped inverses amplify complex128 rounding; the
  dense coarsest-level inverse goes through two LAPACK builds);
- the 2x2 block apply against the JAX package's Pallas kernel in
  interpret mode, complex64: rel 1e-5 (float32 rounding);
- bf16 block PCR factors (complex64): every factor within one bf16 ulp of
  the JAX package's and over 99% bit-identical, because XLA's CPU complex
  product contracts into fused multiply-adds (re = fma(ar, br, -ai bi))
  and torch's does not, which moves some float32 factors across a bf16
  rounding boundary;
- solves: equal GMRES iteration counts and rel 1e-6 between the
  solutions (both stop below tol; the trajectories differ by rounding).
'''

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import zephyr_tpu.backend as jb
from zephyr_tpu.ops.eurus_coeff import eurus_planes as jplanes
from zephyr_tpu.ops import stencil as jst
from zephyr_tpu.solver import helmholtz as jh
from zephyr_tpu.solver import krylov as jk
from zephyr_tpu.solver import multigrid as jmg
from zephyr_tpu.solver import stratified as jsr
from zephyr_tpu_torch import convert
import zephyr_tpu_torch.backend as tb
from zephyr_tpu_torch.ops import cuda_kernels
from zephyr_tpu_torch.ops.eurus_coeff import eurus_planes as tplanes
from zephyr_tpu_torch.ops import stencil as tst
from zephyr_tpu_torch.solver import helmholtz as th
from zephyr_tpu_torch.solver import krylov as tk
from zephyr_tpu_torch.solver import multigrid as tmg
from zephyr_tpu_torch.solver import stratified as tsr

NZ, NX, FREQ = 41, 56, 90.
ANISO = dict(theta=0.3, eps=0.2, delta=0.1)
OPTS = dict(tol=1e-8, maxiter=400, mg_coarse='inv', mg_min_size=16,
            mg_nu1=1, mg_nu2=1, gmres_restart=20)
SOURCES = ((20, 28), (9, 12))
TOL = 1e-10


def _rel(a, b):
    a, b = (np.asarray(v.detach() if torch.is_tensor(v) else v)
            for v in (a, b))
    return np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel())


def _model(medium='layered'):
    c = np.full((NZ, NX), 1500.)
    if medium == 'layered':
        c[NZ // 2:] = 2000.
    return c


def _aniso():
    rng = np.random.default_rng(5)
    return {k: v * (1 + 0.2 * rng.random((NZ, NX)))
            for k, v in ANISO.items()}


def _rand(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _rhs():
    q = np.zeros((len(SOURCES), 2, NZ, NX), complex)
    for i, (z, x) in enumerate(SOURCES):
        q[i, 0, z, x] = 1.0
    return q


def _configs(**kw):
    opts = dict(OPTS, **kw)
    return jh.SolverConfig(**opts), th.SolverConfig(**opts)


@functools.lru_cache(maxsize=None)
def _plane_pair(medium='layered'):
    '(true, shifted) Eurus planes as numpy complex128, from the JAX package.'
    c = jnp.asarray(_model(medium) + 0j)
    rho = jnp.ones((NZ, NX))
    p = jplanes(c, rho, FREQ, **_aniso())
    pp = jplanes(jh.shifted_velocity(c, 0.5j), rho, FREQ, pml_cap=1.0,
                 **_aniso())
    return np.array(p), np.array(pp)


def _torch_op(cfg, medium='layered'):
    c, rho = convert.model_from_numpy(_model(medium), np.ones((NZ, NX)),
                                      device='cpu')
    p = tplanes(c, rho, FREQ, **_aniso())
    pp = tplanes(th.shifted_velocity(c, cfg.shift), rho, FREQ,
                 pml_cap=cfg.pml_cap, **_aniso())
    return th.prepare_operator(p, pp, cfg, with_transpose=False)


# --- plane builder -------------------------------------------------------

@pytest.mark.parametrize('kw', [dict(), dict(pml_cap=1.0),
                                dict(tau=0.4, nPML=7, cPML=600., dx=1.5,
                                     dz=2.0)])
def test_eurus_planes_parity(kw):
    rng = np.random.default_rng(0)
    c = 2000. + 300. * rng.random((NZ, NX))
    rho = 1. + 0.3 * rng.random((NZ, NX))
    p_j = jplanes(jnp.asarray(c + 0j), jnp.asarray(rho), 93.7, **_aniso(),
                  **kw)
    p_t = tplanes(torch.from_numpy(c + 0j), torch.from_numpy(rho), 93.7,
                  **_aniso(), **kw)
    assert p_t.shape == (2, 2, 9, NZ, NX) and p_t.dtype == torch.complex128
    assert _rel(p_t, p_j) < 1e-12
    # complex64 in, complex64 out
    p64 = tplanes(torch.from_numpy(c + 0j).to(torch.complex64),
                  torch.from_numpy(rho).float(), 93.7, **kw)
    assert p64.dtype == torch.complex64


def test_eurus_planes_vjp_matches_jax():
    'd Re<w, planes(c)> / dc through autograd against jax.vjp, rel 1e-12.'
    rng = np.random.default_rng(1)
    c = 2000. + 300. * rng.random((NZ, NX))
    w = _rand(rng, 2, 2, 9, NZ, NX)
    g_j = jax.grad(lambda cc: jnp.real(jnp.sum(
        jnp.asarray(w) * jplanes(cc + 0j, jnp.ones((NZ, NX)), FREQ,
                                 **_aniso()))))(jnp.asarray(c))
    ct = torch.from_numpy(c).requires_grad_(True)
    loss = torch.real(torch.sum(torch.from_numpy(w) * tplanes(
        ct.to(torch.complex128), torch.ones((NZ, NX), dtype=torch.float64),
        FREQ, **_aniso())))
    g_t, = torch.autograd.grad(loss, ct)
    assert _rel(g_t, g_j) < 1e-12


# --- block apply (twin of K8) ----------------------------------------------

def test_block_apply_twin_matches_jax():
    p, _ = _plane_pair()
    u = _rand(np.random.default_rng(2), 2, 2, NZ, NX)
    ref = jax.vmap(lambda x: jst.apply_block_stencil_fast(
        jnp.asarray(p), x))(jnp.asarray(u))
    before = dict(cuda_kernels.LAUNCHES)
    out = tst.apply_block_stencil_batched(torch.from_numpy(p),
                                          torch.from_numpy(u))
    assert cuda_kernels.LAUNCHES == before      # CPU tensors: the twin
    assert _rel(out, ref) < TOL
    assert torch.equal(tst.apply_block_stencil_fast(torch.from_numpy(p),
                                                    torch.from_numpy(u)),
                       out)


def test_block_apply_twin_matches_pallas_interpret():
    'The JAX package\'s K8 in interpret mode, aligned 16x128, complex64.'
    from zephyr_tpu.ops.pallas_stencil import (
        apply_block_stencil_pallas_batched, pallas_block_applicable)
    rng = np.random.default_rng(3)
    R, nz, nx = 3, 16, 128
    planes = _rand(rng, 2, 2, 9, nz, nx).astype(np.complex64)
    u = _rand(rng, R, 2, nz, nx).astype(np.complex64)
    assert pallas_block_applicable(jnp.asarray(planes), jnp.asarray(u))
    ref = np.asarray(apply_block_stencil_pallas_batched(
        jnp.asarray(planes), jnp.asarray(u), interpret=True))
    out = tst.apply_block_stencil_batched(torch.from_numpy(planes),
                                          torch.from_numpy(u)).numpy()
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-5


# --- block stratified PCR ------------------------------------------------

def _block_bands(seed=4):
    rng = np.random.default_rng(seed)
    eye = np.eye(2)[:, :, None, None]
    return (_rand(rng, 2, 2, NZ, NX), _rand(rng, 2, 2, NZ, NX) + 4 * eye,
            _rand(rng, 2, 2, NZ, NX))


def test_block_pcr_matches_jax_complex128():
    L, D, U = _block_bands()
    b = _rand(np.random.default_rng(5), 2, 2, NZ, NX)
    p_j = jsr.pcr_precompute_block(*map(jnp.asarray, (L, D, U)))
    p_t = tsr.pcr_precompute_block(*map(torch.from_numpy, (L, D, U)))
    for a_t, a_j in zip(p_t, p_j):
        assert _rel(a_t, a_j) < TOL
    x_t = tsr.pcr_apply_block(p_t, torch.from_numpy(b))
    assert _rel(x_t, jsr.pcr_apply_block(p_j, jnp.asarray(b))) < TOL
    # the reduction solves the block-tridiagonal systems
    x = x_t.numpy()
    sz = lambda a, s: tsr._shift_z(torch.from_numpy(a), s).numpy()
    Tx = (np.einsum('ijzx,rjzx->rizx', L, sz(x, -1))
          + np.einsum('ijzx,rjzx->rizx', D, x)
          + np.einsum('ijzx,rjzx->rizx', U, sz(x, +1)))
    assert _rel(Tx, b) < 1e-10
    assert _rel(tsr.block_tridiag_pcr_solve(
        *map(torch.from_numpy, (L, D, U)), torch.from_numpy(b)), x) < 1e-13
    # the optional per-level factor cap (off by default, as in the JAX
    # package)
    capped_j = jsr._pcr_levels_block(*map(jnp.asarray, (L, D, U)), 1e-6,
                                     cap=0.5)
    capped_t = tsr._pcr_levels_block(*map(torch.from_numpy, (L, D, U)),
                                     1e-6, cap=0.5)
    for a_t, a_j in zip(capped_t[0] + capped_t[1], capped_j[0] + capped_j[1]):
        assert _rel(a_t, a_j) < TOL


def test_block_pcr_bf16_factors_complex64():
    L, D, U = (a.astype(np.complex64) for a in _block_bands())
    p_j = jsr.pcr_precompute_block(*map(jnp.asarray, (L, D, U)))
    p_t = tsr.pcr_precompute_block(*map(torch.from_numpy, (L, D, U)))
    same = total = 0
    for name in ('alphas', 'gammas', 'dinv'):
        a_j, a_t = np.asarray(getattr(p_j, name)), getattr(p_t, name)
        assert a_t.dtype == torch.bfloat16 and a_t.shape == a_j.shape
        bits_j = a_j.view(np.uint16)
        bits_t = a_t.view(torch.int16).numpy().view(np.uint16)
        same += int(np.sum(bits_j == bits_t))
        total += bits_j.size
        f_j = a_j.astype(np.float32)
        f_t = a_t.float().numpy()
        assert np.all(np.abs(f_t - f_j)
                      <= 2. ** -7 * np.maximum(np.abs(f_j), np.abs(f_t)))
    assert same >= 0.99 * total
    b = _rand(np.random.default_rng(6), 2, 2, NZ, NX).astype(np.complex64)
    x_j = np.asarray(jsr.pcr_apply_block(p_j, jnp.asarray(b)))
    x_t = tsr.pcr_apply_block(p_t, torch.from_numpy(b)).numpy()
    assert np.abs(x_t - x_j).max() / np.abs(x_j).max() < 1e-4


@pytest.mark.parametrize('medium', ['hom', 'layered'])
def test_block_stratified_apply_matches_jax(medium):
    p, pp = _plane_pair(medium)
    ldu_j = jsr.stratified_coeffs_block(jnp.asarray(p), jnp.asarray(pp),
                                        0.5j, 'auto')
    ldu_t = tsr.stratified_coeffs_block(torch.from_numpy(p),
                                        torch.from_numpy(pp), 0.5j, 'auto')
    for a_t, a_j in zip(ldu_t, ldu_j):
        assert _rel(a_t, a_j) < 1e-12
    r = _rand(np.random.default_rng(7), 2, 2, NZ, NX)
    x_j = jsr.stratified_apply_block(jsr.pcr_precompute_block(*ldu_j),
                                     jnp.asarray(r))
    x_t = tsr.stratified_apply_block(tsr.pcr_precompute_block(*ldu_t),
                                     torch.from_numpy(r))
    assert _rel(x_t, x_j) < TOL
    # the transposed family (TTI gradients): reduced once from ldu here,
    # on every application in the JAX package
    xT_j = jsr.stratified_apply_block(jsr.pcr_precompute_block(*ldu_j),
                                      jnp.asarray(r), transpose=True)
    xT_t = tsr.stratified_apply_block(
        tsr.transpose_pcr_block(tsr.pcr_precompute_block(*ldu_t)),
        torch.from_numpy(r), transpose=True)
    assert _rel(xT_t, xT_j) < TOL


# --- the prepared JAX reference ------------------------------------------

@pytest.fixture(scope='module')
def jax_tti():
    '''
    The JAX package's prepared TTI operator (one compiled preparation:
    line-smoothed hierarchy, block stratified state) and its solve_info
    of the two point sources.
    '''
    jcfg, _ = _configs()
    p, pp = _plane_pair()
    op = jax.jit(lambda a, b: jh.prepare_operator(
        a, b, jcfg, with_transpose=False))(jnp.asarray(p), jnp.asarray(pp))
    x, it, rr = jax.jit(jax.vmap(lambda b: jh.solve_info(op, b, jcfg)))(
        jnp.asarray(_rhs()))
    return op, np.asarray(x), np.asarray(it), np.asarray(rr)


# --- line smoother and V-cycle -------------------------------------------

@pytest.fixture(scope='module')
def line_hiers(jax_tti):
    '''
    Line-smoothed hierarchies of both packages, 'inv' and 'lu' coarse
    solves (JAX's: the prepared operator's, and its levels with the
    coarsest LU factors).
    '''
    hj = jax_tti[0].hier
    lu, piv = jax.scipy.linalg.lu_factor(
        jst.planes_to_dense_jax(hj.levels[-1].planes))
    hj_lu = hj._replace(coarse_lu=lu, coarse_piv=piv, coarse_inv=None)
    _, pp = _plane_pair()
    return {coarse: (h, tmg.build_hierarchy(torch.from_numpy(pp),
                                            min_size=OPTS['mg_min_size'],
                                            coarse=coarse, smoother='line'))
            for coarse, h in (('inv', hj), ('lu', hj_lu))}


def test_line_pcr_states_match_jax(line_hiers):
    hj, ht = line_hiers['inv']
    assert len(ht.levels) == len(hj.levels) == 3
    for lj, lt in zip(hj.levels, ht.levels):
        assert _rel(lt.planes, lj.planes) < 1e-12
        for sj, st in ((lj.linez, lt.linez), (lj.linex, lt.linex)):
            assert st.alphas.shape == sj.alphas.shape
            for a_t, a_j in zip(st, sj):
                assert _rel(a_t, a_j) < TOL
    # x-line bands with the axes swapped
    assert ht.levels[0].linex.ldu.shape[-2:] == (NX, NZ)
    # the transposed hierarchy rebuilds its line states from its planes
    lt = tmg.transpose_hierarchy(ht).levels[0]
    for a_t, a_r in zip(lt.linex, tmg._line_pcr_states(lt.planes)[1]):
        assert torch.equal(a_t, a_r)


@pytest.mark.parametrize('coarse', ['inv', 'lu'])
@pytest.mark.parametrize('nu', [1, 2])
def test_line_smoothed_v_cycle_matches_jax(line_hiers, nu, coarse):
    hj, ht = line_hiers[coarse]
    b = _rand(np.random.default_rng(8), 2, 2, NZ, NX)
    x_j = jax.jit(jax.vmap(lambda bb: jmg.v_cycle(hj, bb, omega=0.5, nu1=nu,
                                                  nu2=nu)))(jnp.asarray(b))
    x_t = tmg.v_cycle(ht, torch.from_numpy(b), omega=0.5, nu1=nu, nu2=nu)
    assert _rel(x_t, x_j) < TOL


def test_block_jacobi_v_cycle_matches_jax(line_hiers):
    '''
    mg_smoother='jacobi' on a block operator: damped block-Jacobi sweeps
    (the JAX hierarchy is the line-smoothed one without its line states).
    '''
    hj = line_hiers['inv'][0]
    hj = hj._replace(levels=tuple(lv._replace(linez=None, linex=None)
                                  for lv in hj.levels))
    _, pp = _plane_pair()
    ht = tmg.build_hierarchy(torch.from_numpy(pp),
                             min_size=OPTS['mg_min_size'], coarse='inv')
    assert ht.levels[0].linez is None
    b = _rand(np.random.default_rng(9), 2, 2, NZ, NX)
    x_j = jax.jit(jax.vmap(lambda bb: jmg.v_cycle(hj, bb, omega=0.5, nu1=2,
                                                  nu2=1)))(jnp.asarray(b))
    x_t = tmg.v_cycle(ht, torch.from_numpy(b), omega=0.5, nu1=2, nu2=1)
    assert _rel(x_t, x_j) < TOL


# --- GMRES and FGMRES ----------------------------------------------------

def _scalar_planes():
    from zephyr_tpu.ops.minizephyr_coeff import minizephyr_planes
    c = jnp.asarray(_model() + 0j)
    return np.asarray(minizephyr_planes(c, jnp.ones((NZ, NX)),
                                        FREQ))[None, None]


@pytest.mark.parametrize('block', [False, True], ids=['scalar', 'block'])
@pytest.mark.parametrize('which', ['gmres_cycle', 'fgmres_cycle', 'gmres',
                                   'fgmres'])
def test_gmres_family_matches_jax(block, which):
    '''
    GMRES(8) cycles and the restarted solvers (equal iteration counts per
    RHS) on the scalar and the block operator, right-preconditioned by the
    pointwise (block-)diagonal inverse; the weakly preconditioned scalar
    system is run to tol 1e-2, the block one to 1e-6.
    '''
    p = _plane_pair()[0] if block else _scalar_planes()
    B = p.shape[0]
    b = np.zeros((2, B, NZ, NX), complex)
    b[0, 0, 20, 28] = 1.0
    b[1] = _rand(np.random.default_rng(10), B, NZ, NX)
    pj, pt = jnp.asarray(p), torch.from_numpy(p)
    dj = jst.invert_block_diag(jst.block_diag(pj))
    dt = tst.invert_block_diag(tst.block_diag(pt))
    kw = (dict(m=8) if which.endswith('cycle')
          else dict(tol=1e-6 if block else 1e-2, maxiter=400, restart=8))
    res_j = jax.jit(jax.vmap(lambda bb: getattr(jk, which)(
        lambda x: jst.apply_block_stencil(pj, x), bb,
        M=lambda r: jst.block_diag_matvec(dj, r), **kw)))(jnp.asarray(b))
    res_t = getattr(tk, which)(
        lambda x: tst.apply_block_stencil_fast(pt, x), torch.from_numpy(b),
        M=lambda r: tst.block_diag_matvec(dt, r), **kw)
    # one cycle: rounding only; hundreds of restarted iterations amplify
    # it along the trajectory
    tol = TOL if which.endswith('cycle') else 1e-6
    assert res_t.iters.tolist() == np.asarray(res_j.iters).tolist()
    assert _rel(res_t.relres, res_j.relres) < tol
    assert _rel(res_t.x, res_j.x) < tol


# --- the solve -----------------------------------------------------------

def test_solve_info_iterations_equal_jax(jax_tti):
    _, x_j, it_j, _ = jax_tti
    _, cfg = _configs()
    op = _torch_op(cfg)
    assert op.cplanes is None and isinstance(op.strat, tsr.StratPCRBlock)
    assert op.hier.levels[0].linez is not None
    x_t, it_t, rr_t = th.solve_info(op, torch.from_numpy(_rhs()), cfg)
    assert it_t.tolist() == it_j.tolist()
    assert bool((rr_t <= cfg.tol).all())
    assert _rel(x_t, x_j) < 1e-6


def test_solve_from_converted_jax_block_state(jax_tti):
    op_j, x_j, it_j, _ = jax_tti
    _, cfg = _configs()
    op = convert.operator_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                            op_j),
                                     device='cpu')
    assert isinstance(op.strat, tsr.StratPCRBlock)
    assert op.hier.levels[1].linex is not None
    x_t, it_t, _ = th.solve_info(op, torch.from_numpy(_rhs()), cfg)
    assert it_t.tolist() == it_j.tolist()
    assert _rel(x_t, x_j) < 1e-6


def test_converted_complex64_block_state_carries_bf16_bits(jax_tti):
    ldu = jnp.asarray(np.asarray(jax_tti[0].strat.ldu).astype(np.complex64))
    strat = jsr.pcr_precompute_block(*ldu)
    op64 = jax_tti[0]._replace(strat=strat)
    t64 = convert.operator_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                             op64),
                                      device='cpu')
    for got, want in ((t64.strat.alphas, strat.alphas),
                      (t64.strat.dinv, strat.dinv)):
        assert got.dtype == torch.bfloat16
        assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16),
                              np.asarray(want).view(np.uint16))


def test_chunked_gmres_matches_jax(jax_tti):
    '''
    make_chunked_solver with GMRES cycles of ``chunk`` = gmres_restart
    steps restarted from the true residual: the same iterates as the JAX
    package's restarted GMRES, so the iteration count is that of its
    slowest right-hand side.
    '''
    _, x_j, it_j, _ = jax_tti
    _, cfg = _configs()
    trace = []
    x_t, it_t, rr_t = th.make_chunked_solver(
        cfg, chunk=cfg.gmres_restart)(_torch_op(cfg),
                                      torch.from_numpy(_rhs()), trace=trace)
    assert it_t == int(it_j.max()) == cfg.gmres_restart * len(trace)
    assert rr_t <= cfg.tol and rr_t == trace[-1][1]
    assert _rel(x_t, x_j) < 1e-6


@pytest.mark.parametrize('krylov', ['gmres', 'fgmres', 'bicgstab'])
def test_krylov_choice_on_scalar_and_block_operators(krylov):
    '''
    krylov='gmres'/'fgmres' on a scalar operator (the production fused
    cycle) and on the block operator; 'bicgstab' on the block operator on
    request. 'auto' is GMRES for blocks and BiCGStab for scalars.
    '''
    assert th._effective_krylov(th.SolverConfig(), 2) == 'gmres'
    assert th._effective_krylov(th.SolverConfig(), 1) == 'bicgstab'
    _, cfg = _configs(krylov=krylov, tol=1e-7)
    x, it, rr = th.solve_info(_torch_op(cfg, 'hom'),
                              torch.from_numpy(_rhs()), cfg)
    assert bool((rr <= 1e-7).all())
    if krylov == 'bicgstab':
        return
    assert all(int(i) % cfg.gmres_restart == 0 for i in it)
    scfg = th.SolverConfig(tol=1e-7, mg_coarse='inv', mg_min_size=10,
                           fft_scale=2, hybrid_comp='fused', mg_nu1=2,
                           mg_nu2=1, krylov=krylov, gmres_restart=10)
    c, rho = convert.model_from_numpy(_model(), np.ones((NZ, NX)),
                                      device='cpu')
    from zephyr_tpu_torch.ops.minizephyr_coeff import minizephyr_planes
    op = th.prepare_operator(
        minizephyr_planes(c, rho, FREQ)[None, None],
        minizephyr_planes(th.shifted_velocity(c, 0.5j), rho, FREQ,
                          pml_cap=1.0)[None, None], scfg)
    q = _rhs()[:, :1]
    x, it, rr = th.solve_info(op, torch.from_numpy(q), scfg)
    assert bool((rr <= 1e-7).all())
    A = tst.planes_to_dense(op.planes[0, 0].numpy())
    assert _rel(x[0, 0].numpy().ravel(),
                np.linalg.solve(A, q[0, 0].ravel())) < 1e-5


def test_block_backward_matches_forward_mode():
    '''
    The backward of a block (TTI) solve: d/dc of sum |x|^2 by reverse mode
    (one GMRES transpose solve with the block transpose preconditioner)
    against the same derivative by forward mode in a seeded direction,
    rel 1e-6 (both solve to tol 1e-10); the transpose preconditioner
    makes GMRES on A^T converge to tol, and the solution is A^-T b (dense,
    rel 1e-8).
    '''
    import torch.autograd.forward_ad as fwAD
    _, cfg = _configs(tol=1e-10)
    c0, rho = convert.model_from_numpy(_model(), np.ones((NZ, NX)),
                                       device='cpu')
    dc = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (NZ, NX))).to(c0.dtype)

    def loss(c):
        p = tplanes(c, rho, FREQ, **_aniso())
        pp = tplanes(th.shifted_velocity(c.detach(), 0.5j), rho, FREQ,
                     pml_cap=1.0, **_aniso())
        op = th.prepare_operator(p.detach(), pp, cfg,
                                 with_transpose=c.requires_grad)
        x = th.solve_batched(op, torch.from_numpy(_rhs()), cfg, planes=p)
        assert torch.isfinite(x).all()
        return torch.sum(torch.abs(x) ** 2), op

    c = c0.clone().requires_grad_(True)
    L, op = loss(c)
    g, = torch.autograd.grad(L, c)
    with fwAD.dual_level():
        d_fw = fwAD.unpack_dual(loss(fwAD.make_dual(c0, dc))[0]).tangent
    assert abs(float(torch.sum(g * dc).real) - float(d_fw)) \
        / abs(float(d_fw)) < 1e-6
    MT = th._make_precond(op, cfg, transpose=True)
    b = torch.from_numpy(_rhs())
    res = th._krylov_solve(
        lambda v: tst.apply_block_stencil_fast(op.planesT, v), b, MT, cfg, 2)
    assert bool((res.relres <= cfg.tol).all())
    A = tst.planes_to_dense_torch(op.planes.detach()).numpy()
    ref = np.linalg.solve(A.T, b[0].numpy().ravel())
    assert _rel(res.x[0].numpy().ravel(), ref) < 1e-8


# --- the forward API -----------------------------------------------------

def _eurus_config(**kw):
    '''
    The discretization config of the prepared JAX reference: the same
    model, anisotropy, frequency, PML and solver options.
    '''
    config = {'c': _model(), 'rho': 1., 'nx': NX, 'nz': NZ, 'freq': FREQ,
              'device': 'cpu', 'solverOpts': dict(OPTS)}
    config.update(_aniso())
    config.update(kw)
    return config


@pytest.mark.parametrize('cls', ['Eurus', 'EurusHD'])
def test_eurus_mul_matches_jax(jax_tti, cls):
    '''
    ``Eurus(config) * q`` is conj(A^-1 (premul q)): held against the JAX
    package's solve of the same system (and its premul), rel 1e-6; a
    half-size RHS is padded and the result clipped; a wrong size raises.
    '''
    config = _eurus_config()
    locs = np.array([[x, z] for z, x in SOURCES], dtype=float)
    q = tb.StackedSimpleSource(config)(locs)
    assert np.array_equal(q, jb.StackedSimpleSource(config)(locs))
    assert np.array_equal(q.T.reshape(_rhs().shape), _rhs())
    A_t, A_j = getattr(tb, cls)(config), getattr(jb, cls)(config)
    assert A_t.shape == A_j.shape == (2 * NZ * NX, 2 * NZ * NX)
    assert A_t.nblock == 2 and A_t.mord == A_j.mord == (-NX, 1)
    assert A_t.premul == A_j.premul
    assert _rel(A_t.A, _plane_pair()[0]) < 1e-12
    u_t = A_t * q
    u_j = np.conj(A_j.premul * jax_tti[1].reshape(2, -1).T)
    assert u_t.shape == (2 * NZ * NX, 2)
    assert _rel(u_t, u_j) < 1e-6
    if cls == 'EurusHD':
        return
    half = A_t * q[:NZ * NX, 0]
    assert half.shape == (NZ * NX,)
    assert _rel(half, u_t[:NZ * NX, 0]) < 1e-6
    with pytest.raises(ValueError, match='dimension mismatch'):
        A_t * np.ones(3 * NZ * NX)


def test_anisotropic_fields_and_source_match_jax():
    config = _eurus_config(theta=0.3, eps=np.full((NZ, NX), 0.2))
    at, aj = tb.Eurus(config), jb.Eurus(config)
    for name in ('theta', 'eps', 'delta'):
        assert np.array_equal(getattr(at, name), getattr(aj, name))
    locs = np.array([[20.3, 11.7], [33.1, 30.4]])
    st = tb.AnisotropicKaiserSource(config)
    sj = jb.AnisotropicKaiserSource(config)
    for a_t, a_j in zip(st.stamps(locs), sj.stamps(locs)):
        assert np.array_equal(a_t, a_j)
    # the skewed grid differs from the isotropic stamp
    iso = tb.SparseKaiserSource(config).stamps(locs)[2]
    assert not np.allclose(st.stamps(locs)[2], iso)


# --- fault F4: the eurus_layered row in both packages --------------------

F4_N, F4_CHUNKS = 256, 6


def _f4_row(dtype):
    '''
    The bench's eurus_layered row (bench.py:425-484) as numpy: the 4-layer
    1500-3000 m/s model at 256^2, theta 0.3, eps 0.2, delta 0.1, freq
    1500/16, 16 point sources drawn with seed 1; the production config
    with gmres_restart=20 and mg_nu1=mg_nu2=1.
    '''
    n = F4_N
    c = np.zeros((n, n))
    for i, v in enumerate([1500., 2000., 2500., 3000.]):
        c[i * n // 4:(i + 1) * n // 4] = v
    pos = np.random.default_rng(1).integers(n // 8, 7 * n // 8, size=(16, 2))
    b = np.zeros((16, 2, n, n), dtype)
    b[np.arange(16), 0, pos[:, 0], pos[:, 1]] = 1.0
    opts = dict(tol=1e-5, maxiter=2000, mg_coarse='inv', mg_min_size=32,
                fft_mode='strat', fft_scale=2, hybrid_comp='fused',
                mg_nu1=1, mg_nu2=1, gmres_restart=20)
    aniso = {k: np.full((n, n), v) for k, v in ANISO.items()}
    return c.astype(dtype), aniso, b, opts


@pytest.mark.slow
@pytest.mark.parametrize('dtype', [np.complex128, np.complex64],
                         ids=['complex128', 'complex64'])
def test_eurus_layered_stall_matches_jax(dtype, monkeypatch, capsys):
    '''
    Fault F4: make_chunked_solver(chunk=16) on the eurus_layered row
    stalls near relres 3.8e-2 in the JAX package on XLA:CPU and in the
    port on the CPU alike, in complex128 as in complex64, so the stall is
    the restarted GMRES(16) with this preconditioner and not float32
    rounding. The per-chunk worst true residuals agree to rel 1e-6
    (complex128) and 1e-3 (complex64: float32 rounding along 96
    iterations). JAX's trace is read from its own chunk loop.
    '''
    import zephyr_tpu.core.realio as jrio
    c, aniso, b, opts = _f4_row(dtype)
    freq = 1500. / 16
    trace_j = []
    realio_jit = jrio.realio_jit

    def recording(fn, **kw):
        step = realio_jit(fn, **kw)

        def wrapped(*args):
            out = step(*args)
            if isinstance(out, tuple) and len(out) == 3:    # a chunk step
                trace_j.append(float(np.asarray(out[1])))
            return out
        return wrapped
    monkeypatch.setattr(jrio, 'realio_jit', recording)
    jcfg, tcfg = jh.SolverConfig(**opts), th.SolverConfig(**opts)
    rdt = np.float64 if dtype == np.complex128 else np.float32
    one = np.ones(c.shape, rdt)
    jan = {k: jnp.asarray(v.astype(rdt)) for k, v in aniso.items()}
    cj = jnp.asarray(c)
    op_j = jax.jit(lambda a, p: jh.prepare_operator(
        a, p, jcfg, with_transpose=False))(
        jplanes(cj, jnp.asarray(one), freq, **jan),
        jplanes(jh.shifted_velocity(cj, jcfg.shift), jnp.asarray(one), freq,
                pml_cap=jcfg.pml_cap, **jan))
    jh.make_chunked_solver(jcfg, chunk=16)(op_j, b, max_chunks=F4_CHUNKS)

    ct = torch.from_numpy(c)
    tan = {k: torch.from_numpy(v.astype(rdt)) for k, v in aniso.items()}
    op_t = th.prepare_operator(
        tplanes(ct, torch.from_numpy(one), freq, **tan),
        tplanes(th.shifted_velocity(ct, tcfg.shift), torch.from_numpy(one),
                freq, pml_cap=tcfg.pml_cap, **tan), tcfg,
        with_transpose=False)
    trace_t = []
    th.make_chunked_solver(tcfg, chunk=16)(op_t, torch.from_numpy(b),
                                           max_chunks=F4_CHUNKS, trace=trace_t)
    trace_t = [r for _, r in trace_t]
    with capsys.disabled():
        print('\nF4 %s chunk traces (worst relres)\n  JAX:  %s\n  port: %s'
              % (np.dtype(dtype).name, ' '.join('%.5e' % r for r in trace_j),
                 ' '.join('%.5e' % r for r in trace_t)))
    assert len(trace_j) == len(trace_t) == F4_CHUNKS
    tol = 1e-6 if dtype == np.complex128 else 1e-3
    assert _rel(trace_t, trace_j) < tol
    # the stall: no chunk after the third gains a tenth of a per cent
    assert trace_j[-1] > 1e-2 and trace_j[-1] > 0.999 * trace_j[3]
