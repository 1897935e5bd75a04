'''
Port parity of the Helmholtz solve: zephyr_tpu_torch against zephyr_tpu
and against a dense LU, complex128, with the production solver config
(fused hybrid cycle, stratified PCR at half resolution, dense coarse
inverse, nu1=2, nu2=1) cut to small grids by mg_min_size=10.

- The solution matches the dense LU to rel 1e-6 at tol 1e-9.
- Per-RHS BiCGStab iteration counts EQUAL the JAX package's on the
  homogeneous and the two-layer model (point sources, tol 1e-5), and the
  solutions agree to rel 1e-6 (both stop below tol 1e-5; the two
  trajectories differ only by complex128 rounding).
- The same holds when the port solves from the JAX-prepared state
  (``convert.operator_from_numpy``), and for the chunked solver.
'''

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zephyr_tpu.core.realio import join_complex_host
from zephyr_tpu.ops.minizephyr_coeff import minizephyr_planes as jplanes
from zephyr_tpu.ops.stencil import planes_to_dense
from zephyr_tpu.solver import helmholtz as jh
from zephyr_tpu_torch import convert
from zephyr_tpu_torch.ops.minizephyr_coeff import minizephyr_planes as tplanes
from zephyr_tpu_torch.solver import helmholtz as th

NZ, NX, FREQ = 48, 40, 150.
PRODUCTION = dict(tol=1e-5, maxiter=2000, mg_coarse='inv', mg_min_size=10,
                  fft_mode='strat', fft_scale=2, hybrid_comp='fused',
                  mg_nu1=2, mg_nu2=1)
SOURCES = ((16, 28), (30, 10))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel())


def _model(medium):
    c = np.full((NZ, NX), 1500. + 0j)
    if medium == 'layered':
        c[NZ // 2:] = 2400.
    return c


def _rhs():
    q = np.zeros((len(SOURCES), 1, NZ, NX), complex)
    for i, (z, x) in enumerate(SOURCES):
        q[i, 0, z, x] = 1.0
    return q


def _jax_op(c, cfg):
    c = jnp.asarray(c)
    rho = jnp.ones((NZ, NX))
    p = jplanes(c, rho, FREQ)[None, None]
    pp = jplanes(jh.shifted_velocity(c, cfg.shift), rho, FREQ,
                 pml_cap=cfg.pml_cap)[None, None]
    return jh.prepare_operator(p, pp, cfg, with_transpose=False)


def _torch_op(c, cfg):
    c, rho = convert.model_from_numpy(c, np.ones((NZ, NX)))
    p = tplanes(c, rho, FREQ)[None, None]
    pp = tplanes(th.shifted_velocity(c, cfg.shift), rho, FREQ,
                 pml_cap=cfg.pml_cap)[None, None]
    return th.prepare_operator(p, pp, cfg)


def _configs(**kw):
    opts = dict(PRODUCTION, **kw)
    return jh.SolverConfig(**opts), th.SolverConfig(**opts)


def test_solver_config_fields_match():
    assert th.SolverConfig()._asdict() == jh.SolverConfig()._asdict()
    assert th.resolve_solver_config({}, torch.complex64).tol == 1e-5
    assert th.resolve_solver_config({}, torch.complex128).tol == 1e-7
    rng = np.random.default_rng(1)
    lateral = 1500. + 400. * rng.random((64, 64))
    for c in (np.full((64, 64), 1500.), lateral):
        for core in (16, 256):
            t = th.resolve_panels(th.SolverConfig(), c, core=core)
            j = jh.resolve_panels(jh.SolverConfig(), c, core=core)
            assert t._asdict() == j._asdict()
    assert th.resolve_panels(th.SolverConfig(), lateral,
                             core=16).strat_panels == 4


def test_fused_hybrid_matches_lu_small():
    _, cfg = _configs(tol=1e-9)
    op = _torch_op(_model('layered'), cfg)
    q = np.zeros((1, 1, NZ, NX), complex)
    q[0, 0, 16, 28] = 1.0
    x, iters, relres = th.solve_info(op, torch.from_numpy(q), cfg)
    A = planes_to_dense(op.planes[0, 0].numpy())
    x_lu = np.linalg.solve(A, q.ravel())
    assert float(relres[0]) <= 1e-9
    assert _rel(x.numpy().ravel(), x_lu) < 1e-6


@pytest.fixture(scope='module', params=['hom', 'layered'])
def jax_reference(request):
    jcfg, _ = _configs()
    c = _model(request.param)
    op = _jax_op(c, jcfg)
    x, it, rr = jax.vmap(lambda b: jh.solve_info(op, b, jcfg))(
        jnp.asarray(_rhs()))
    return c, op, np.asarray(x), np.asarray(it), np.asarray(rr)


def test_iteration_counts_equal_jax(jax_reference):
    c, _, x_j, it_j, rr_j = jax_reference
    _, cfg = _configs()
    x_t, it_t, rr_t = th.solve_info(_torch_op(c, cfg),
                                    torch.from_numpy(_rhs()), cfg)
    assert it_t.tolist() == it_j.tolist()
    assert np.all(rr_t.numpy() <= 1e-5)
    assert _rel(x_t, x_j) < 1e-6


def test_solve_from_converted_jax_state(jax_reference):
    c, op_j, x_j, it_j, _ = jax_reference
    _, cfg = _configs()
    tree = jax.tree_util.tree_map(np.asarray, op_j)
    op = convert.operator_from_numpy(tree)
    assert op.strat.alphas.dtype == torch.complex128
    x_t, it_t, _ = th.solve_info(op, torch.from_numpy(_rhs()), cfg)
    assert it_t.tolist() == it_j.tolist()
    assert _rel(x_t, x_j) < 1e-6


def test_converted_lu_coarse_and_complex64_state():
    'LU pivots (0- vs 1-based) and bf16 leaves survive the conversion.'
    jcfg, cfg = _configs(mg_coarse='lu')
    c = _model('layered')
    op_j = _jax_op(c, jcfg)
    op = convert.operator_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                            op_j))
    b = _rhs()
    x_j = jax.vmap(lambda bb: jh.solve_info(op_j, bb, jcfg)[0])(
        jnp.asarray(b))
    x_t = th.solve_info(op, torch.from_numpy(b), cfg)[0]
    assert _rel(x_t, x_j) < 1e-6
    # a complex64 JAX state: bf16 PCR factors carried bit for bit
    op64 = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.complex64) if jnp.iscomplexobj(a) else a,
        _jax_op(c, jcfg._replace(mg_coarse='inv')))
    from zephyr_tpu.solver.stratified import pcr_precompute
    strat = pcr_precompute(*op64.strat.ldu)
    op64 = op64._replace(strat=strat)
    t64 = convert.operator_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                             op64))
    assert t64.strat.alphas.dtype == torch.bfloat16
    assert np.array_equal(
        t64.strat.alphas.view(torch.int16).numpy().view(np.uint16),
        np.asarray(strat.alphas).view(np.uint16))


def test_chunked_solver_matches_jax():
    jcfg, cfg = _configs()
    c = _model('layered')
    b = _rhs()
    xj, itj, rrj = jh.make_chunked_solver(jcfg, chunk=8)(_jax_op(c, jcfg),
                                                          b)
    xj = np.asarray(join_complex_host(xj))
    xt, itt, rrt = th.make_chunked_solver(cfg, chunk=8)(
        _torch_op(c, cfg), torch.from_numpy(b))
    assert itt == itj
    assert rrt <= 1e-5 and abs(rrt - rrj) <= 1e-3 * rrj
    assert _rel(xt, xj) < 1e-6


def test_chunked_solver_nan_rhs_keeps_pre_chunk_iterate():
    'Non-finite first chunk: no exception, zeros kept, non-finite relres.'
    _, cfg = _configs()
    b = _rhs()
    b[1, 0, 5, 5] = np.nan
    x, iters, relres = th.make_chunked_solver(cfg, chunk=8)(
        _torch_op(_model('hom'), cfg), torch.from_numpy(b))
    assert not np.isfinite(relres)
    assert x.shape == b.shape and not bool(x.abs().sum())


UNPORTED = [
    dict(mg_nu2=3), dict(mg_nu1=3), dict(mg_nu1=0),
    dict(fft_mode='2d'), dict(mg_nu2=0), dict(hybrid_comp='add'),
    dict(fft_scale=4), dict(strat_panels=2), dict(strat_dft='dft'),
    dict(krylov='gmres'), dict(krylov='fgmres'),
    dict(mg_coarse='iterative'),
]


@pytest.mark.parametrize('kw', UNPORTED)
def test_unported_configs_raise(kw):
    _, cfg = _configs(**kw)
    with pytest.raises(NotImplementedError):
        th.check_config(cfg)


def test_default_config_and_block_operators_raise():
    '''
    The default SolverConfig and the 'mult' compositions run now (K5,
    K7); three post-smoothing sweeps still need K6, and block operators
    still raise.
    '''
    th.check_config(th.SolverConfig())
    for kw in (dict(hybrid_comp='mult'), dict(fft_scale=1),
               dict(mg_nu2=2)):
        th.check_config(_configs(**kw)[1])
    with pytest.raises(NotImplementedError, match='K6'):
        th.check_config(th.SolverConfig(mg_nu2=3))
    _, cfg = _configs()
    with pytest.raises(NotImplementedError, match='B=2'):
        th.check_config(cfg, block_size=2)
    # the plain multigrid preconditioner with the fused kernels is ported
    _, mg = _configs(precond='mg', tol=1e-7)
    op = _torch_op(_model('hom'), mg)
    _, it, rr = th.solve_info(op, torch.from_numpy(_rhs()), mg)
    assert bool((rr <= 1e-7).all())
