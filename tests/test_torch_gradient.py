'''
Port parity of the gradient slice: the transpose preconditioner, the
default SolverConfig solve and the differentiable ``solve`` of
zephyr_tpu_torch against zephyr_tpu (and against dense autodiff), on the
CPU in complex128, on a 32x28 grid cut to three multigrid levels by
mg_min_size=10, for the default config ('mult', fft_scale=1, nu2=2, LU
coarse solve) and the production config (fused, fft_scale=2, nu2=1,
dense coarse inverse).

Tolerances:
- preconditioner applications: rel 1e-10 (two LAPACK builds for the
  dense coarsest level; every other step is the same arithmetic);
- solves: equal BiCGStab iteration counts for point sources and rel 1e-6
  between the solutions (both stop below tol; the trajectories differ by
  complex128 rounding only);
- gradients w.r.t. the real velocity c (a real quantity in both
  frameworks, so no complex convention enters): rel 1e-6 against
  ``jax.grad`` through the JAX package's ``solve`` and against torch
  autograd through a dense ``torch.linalg.solve``, with solves at
  tol 1e-10; on the Marmousi model through the x-panelled solve (its
  transposed panel family in the backward) and the nu 3/3 smoother,
  rel 1e-8 with solves at tol 1e-12;
- the forward-mode rule of ``solve_batched`` (tangents of c and b):
  rel 1e-6 against ``jax.jvp`` through the JAX package's ``solve`` and
  against a central difference (eps 1e-3), solves at tol 1e-12.
'''

import functools

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import jax
import jax.numpy as jnp

from zephyr_tpu.ops.minizephyr_coeff import minizephyr_planes as jplanes
from zephyr_tpu.solver import helmholtz as jh
import zephyr_tpu.backend as jb
from zephyr_tpu_torch import convert
import zephyr_tpu_torch.backend as tb
from zephyr_tpu_torch.ops.minizephyr_coeff import minizephyr_planes as tplanes
from zephyr_tpu_torch.ops.stencil import planes_to_dense_torch
from zephyr_tpu_torch.solver import helmholtz as th

NZ, NX, FREQ = 32, 28, 150.
CONFIGS = {
    'default': dict(mg_min_size=10),
    'production': dict(tol=1e-5, maxiter=2000, mg_coarse='inv',
                       mg_min_size=10, fft_mode='strat', fft_scale=2,
                       hybrid_comp='fused', mg_nu1=2, mg_nu2=1),
}
SOURCES = ((10, 17), (22, 6))


def _rel(a, b):
    a, b = (np.asarray(v.detach().resolve_conj() if torch.is_tensor(v)
                       else v) for v in (a, b))
    return np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel())


def _configs(name, **kw):
    opts = dict(CONFIGS[name], **kw)
    return jh.SolverConfig(**opts), th.SolverConfig(**opts)


def _model(medium):
    if medium == 'marmousi':
        from bench import _marmousi_c
        return _marmousi_c(NZ, np.float64)[:, :NX]
    c = np.full((NZ, NX), 1500.)
    if medium == 'layered':
        c[NZ // 2:] = 2300.
    return c


def _rhs():
    q = np.zeros((len(SOURCES), 1, NZ, NX), complex)
    for i, (z, x) in enumerate(SOURCES):
        q[i, 0, z, x] = 1.0
    return q


def _jax_op(c, cfg):
    c = jnp.asarray(c, dtype=jnp.complex128)
    rho = jnp.ones((NZ, NX))
    p = jplanes(c, rho, FREQ)[None, None]
    pp = jplanes(jh.shifted_velocity(c, cfg.shift), rho, FREQ,
                 pml_cap=cfg.pml_cap)[None, None]
    return jh.prepare_operator(p, pp, cfg, with_transpose=True)


@functools.lru_cache(maxsize=None)
def _jax_op_jit(cfg):
    'One compiled JAX preparation per config (eager dispatch is slower).'
    return jax.jit(lambda c: _jax_op(c, cfg))


def _torch_op(c, cfg):
    c = c.to(torch.complex128)
    rho = torch.ones((NZ, NX), dtype=torch.float64)
    p = tplanes(c, rho, FREQ)[None, None]
    pp = tplanes(th.shifted_velocity(c.detach(), cfg.shift), rho, FREQ,
                 pml_cap=cfg.pml_cap)[None, None]
    return th.prepare_operator(p, pp, cfg)


@pytest.mark.parametrize('name', ['default', 'production'])
def test_preconditioners_match_jax(name):
    '''
    Forward and transpose preconditioner applications, rel 1e-10, of the
    port's own preparation and of the JAX state carried over by
    ``operator_from_numpy`` (hierT and planesT included).
    '''
    jcfg, cfg = _configs(name)
    c = _model('layered')
    op_j = _jax_op_jit(jcfg)(c)
    op_t = _torch_op(torch.from_numpy(c), cfg)
    op_c = convert.operator_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                              op_j),
                                       device='cpu')
    assert len(op_c.hierT.levels) == len(op_j.hierT.levels)
    rng = np.random.default_rng(3)
    r = (rng.standard_normal((2, 1, NZ, NX))
         + 1j * rng.standard_normal((2, 1, NZ, NX)))
    for transpose in (False, True):
        Mj = jax.jit(jax.vmap(jh._make_precond(op_j, jcfg,
                                               transpose=transpose)))
        ref = Mj(jnp.asarray(r))
        for op in (op_t, op_c):
            Mt = th._make_precond(op, cfg, transpose=transpose)
            assert _rel(Mt(torch.from_numpy(r)), ref) < 1e-10
    # the transposed operator parts
    assert _rel(op_t.planesT, op_j.planesT) < 1e-12
    for lt, lj in zip(op_t.hierT.levels, op_j.hierT.levels):
        assert _rel(lt.planes, lj.planes) < 1e-12


@pytest.mark.parametrize('medium', ['hom', 'layered'])
def test_default_config_iterations_equal_jax(medium):
    jcfg, cfg = _configs('default')
    c = _model(medium)
    op_j = _jax_op_jit(jcfg)(c)
    x_j, it_j, _ = jax.jit(jax.vmap(lambda b: jh.solve_info(op_j, b,
                                                            jcfg)))(
        jnp.asarray(_rhs()))
    x_t, it_t, rr_t = th.solve_info(_torch_op(torch.from_numpy(c), cfg),
                                    torch.from_numpy(_rhs()), cfg)
    assert it_t.tolist() == np.asarray(it_j).tolist()
    assert np.all(rr_t.numpy() <= cfg.tol)
    assert _rel(x_t, x_j) < 1e-6


def test_minizephyr_default_config_matches_jax():
    '``MiniZephyr(config) * q`` with no solverOpts, in both packages.'
    config = {'c': np.where(np.arange(48)[:, None] < 24, 2500., 3200.)
              * np.ones((48, 40)), 'rho': 1., 'nx': 40, 'nz': 48,
              'freq': 150., 'device': 'cpu'}
    locs = np.array([[20., 16.], [11.3, 30.7]])
    q = tb.SparseKaiserSource(config)(locs)
    u_t = tb.MiniZephyr(config) * q
    u_j = jb.MiniZephyr(config) * jb.SparseKaiserSource(config)(locs)
    assert u_t.shape == (48 * 40, 2)
    assert _rel(u_t, u_j) < 1e-6


def _loss_torch(c, cfg):
    op = _torch_op(c, cfg)
    u = th.solve_batched(op, torch.from_numpy(_rhs()), cfg)
    return torch.sum(torch.abs(u) ** 2)


@pytest.mark.parametrize('name', ['default', 'production'])
def test_solve_gradient_matches_jax_grad(name):
    jcfg, cfg = _configs(name, tol=1e-10)
    c0 = _model('layered')

    def loss_jax(c):
        op = _jax_op(c, jcfg)
        u = jax.vmap(lambda b: jh.solve(op, b, jcfg))(jnp.asarray(_rhs()))
        return jnp.sum(jnp.abs(u) ** 2)

    g_j = np.asarray(jax.jit(jax.grad(loss_jax))(jnp.asarray(c0)))
    c = torch.from_numpy(c0).requires_grad_(True)
    g_t, = torch.autograd.grad(_loss_torch(c, cfg), c)
    assert g_t.dtype == torch.float64
    assert _rel(g_t, g_j) < 1e-6


@pytest.mark.parametrize('kw', [dict(strat_panels=2, strat_overlap=2),
                                dict(mg_nu1=3, mg_nu2=3)])
def test_panelled_and_nu33_gradients_match_jax_grad(kw):
    '''
    The backward of the production solve with x-panels (the transposed
    panel family, the default 'in' taper; every taper's transposed apply
    is held in tests/test_torch_stratified.py) and with nu 3/3 (K6 in
    both directions), on the Marmousi model: rel 1e-8 against jax.grad.
    '''
    jcfg, cfg = _configs('production', tol=1e-12, **kw)
    c0 = _model('marmousi')

    def loss_jax(c):
        op = _jax_op(c, jcfg)
        u = jax.vmap(lambda b: jh.solve(op, b, jcfg))(jnp.asarray(_rhs()))
        return jnp.sum(jnp.abs(u) ** 2)

    g_j = np.asarray(jax.jit(jax.grad(loss_jax))(jnp.asarray(c0)))
    c = torch.from_numpy(c0).requires_grad_(True)
    g_t, = torch.autograd.grad(_loss_torch(c, cfg), c)
    assert _rel(g_t, g_j) < 1e-8


def test_solve_gradient_matches_dense_autodiff():
    'd/dc and d/db through solve against a dense torch.linalg.solve.'
    _, cfg = _configs('production', tol=1e-10)
    rng = np.random.default_rng(5)
    c0 = 1900. + 120. * rng.standard_normal((NZ, NX))
    b0 = _rhs() * (1.0 - 0.4j)
    c = torch.from_numpy(c0).requires_grad_(True)
    b = torch.from_numpy(b0).requires_grad_(True)
    op = _torch_op(c, cfg)
    u = th.solve_batched(op, b, cfg)
    g_c, g_b = torch.autograd.grad(torch.sum(torch.abs(u) ** 2), (c, b))

    cd = torch.from_numpy(c0).requires_grad_(True)
    bd = torch.from_numpy(b0).requires_grad_(True)
    A = planes_to_dense_torch(tplanes(cd.to(torch.complex128),
                                      torch.ones((NZ, NX),
                                                 dtype=torch.float64),
                                      FREQ)[None, None])
    ud = torch.linalg.solve(A, bd.reshape(len(SOURCES), -1).T).T
    gd_c, gd_b = torch.autograd.grad(torch.sum(torch.abs(ud) ** 2),
                                     (cd, bd))
    assert _rel(g_c, gd_c) < 1e-6
    assert _rel(g_b, gd_b) < 1e-6


def test_backward_needs_the_transposed_parts():
    _, cfg = _configs('default')
    c = torch.from_numpy(_model('hom')).requires_grad_(True)
    cc = c.to(torch.complex128)
    p = tplanes(cc, torch.ones((NZ, NX), dtype=torch.float64),
                FREQ)[None, None]
    op = th.prepare_operator(p, None, cfg, with_transpose=False)
    assert op.hierT is None and op.planesT is None
    u = th.solve(op, torch.from_numpy(_rhs()[0]), cfg)
    with pytest.raises(ValueError, match='with_transpose'):
        torch.autograd.grad(torch.sum(torch.abs(u) ** 2), c)


def test_converted_state_backward_matches_jax_vjp():
    '''
    The backward w.r.t. b through a converted JAX state (production
    config) against jax.vjp of the JAX package's solve: JAX's cotangent
    is A^{-T} g and torch's A^{-H} g, so conj(torch(conj(g))) == JAX(g).
    '''
    jcfg, cfg = _configs('production', tol=1e-10)
    op_j = _jax_op_jit(jcfg)(_model('layered'))
    op = convert.operator_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                            op_j),
                                     device='cpu')
    g = np.random.default_rng(9).standard_normal((1, NZ, NX)) * (1 + 2j)
    b = torch.from_numpy(_rhs()[0]).requires_grad_(True)
    u = th.solve(op, b, cfg)
    gb_t, = torch.autograd.grad(u, b, grad_outputs=torch.from_numpy(
        g.conj()))
    gb_j = jax.jit(lambda gg: jax.vjp(lambda bb: jh.solve(op_j, bb, jcfg),
                                      jnp.asarray(_rhs()[0]))[1](gg)[0])(
        jnp.asarray(g))
    assert _rel(torch.conj(gb_t), gb_j) < 1e-6


def _solve_torch_planes(c, b, cfg):
    '''
    solve_batched with the operator prepared from detached planes and the
    planes of c as the differentiable input (the middleware's pattern).
    '''
    cc = c.to(torch.complex128)
    rho = torch.ones((NZ, NX), dtype=torch.float64)
    p = tplanes(cc, rho, FREQ)[None, None]
    pp = tplanes(th.shifted_velocity(cc.detach(), cfg.shift), rho, FREQ,
                 pml_cap=cfg.pml_cap)[None, None]
    op = th.prepare_operator(p.detach(), pp, cfg, with_transpose=False)
    return th.solve_batched(op, b, cfg, planes=p)


@pytest.mark.parametrize('name', ['default', 'production'])
def test_solve_jvp_matches_jax_jvp(name):
    '''
    dx = A^{-1} (db - dA x): the forward-mode rule against jax.jvp through
    the JAX package's solve and against a central difference.
    '''
    jcfg, cfg = _configs(name, tol=1e-12)
    c0 = _model('layered')
    rng = np.random.default_rng(12)
    dc = rng.standard_normal((NZ, NX))
    b0 = _rhs() * (1.0 - 0.4j)
    db = 0.3 * (rng.standard_normal(b0.shape)
                + 1j * rng.standard_normal(b0.shape))

    def fwd_jax(c, b):
        op = _jax_op(c, jcfg)
        return jax.vmap(lambda bb: jh.solve(op, bb, jcfg))(b)

    _, ref = jax.jit(lambda c, b, t, tb: jax.jvp(fwd_jax, (c, b),
                                                 (t, tb)))(
        jnp.asarray(c0), jnp.asarray(b0), jnp.asarray(dc),
        jnp.asarray(db))
    with fwAD.dual_level():
        x = _solve_torch_planes(
            fwAD.make_dual(torch.from_numpy(c0), torch.from_numpy(dc)),
            fwAD.make_dual(torch.from_numpy(b0), torch.from_numpy(db)),
            cfg)
        tangent = fwAD.unpack_dual(x).tangent
    assert tangent.dtype == torch.complex128
    assert _rel(tangent, ref) < 1e-6
    eps = 1e-3

    def at(sign):
        return _solve_torch_planes(torch.from_numpy(c0 + sign * eps * dc),
                                   torch.from_numpy(b0 + sign * eps * db),
                                   cfg)

    assert _rel(tangent, (at(1) - at(-1)) / (2 * eps)) < 1e-6
