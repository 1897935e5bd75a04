'''
Port parity of the pieces behind kernels K5 and K7 and the transposed
operator: zephyr_tpu_torch against zephyr_tpu on the CPU, complex128, at
even and odd shapes (on the CPU both packages run their plain
references; the CUDA kernels are held against these twins on the card by
tests/test_torch_kernels.py and chip_smoke.py).

Tolerances: rel 1e-12 for the pointwise twins, the transfers and the
plane transposes (the same floating-point operations in the same order);
rel 1e-10 wherever a dense coarsest-level inverse/LU enters (two LAPACK
builds, the coarse operator's condition number times machine epsilon).
'''

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zephyr_tpu.ops import stencil as jst
from zephyr_tpu.ops.minizephyr_coeff import minizephyr_planes as jplanes
from zephyr_tpu.solver import multigrid as jmg
from zephyr_tpu.solver import stratified as jstrat
from zephyr_tpu.solver.helmholtz import shifted_velocity as jshift
from zephyr_tpu_torch.ops import stencil as tst
from zephyr_tpu_torch.ops.minizephyr_coeff import minizephyr_planes as tplanes
from zephyr_tpu_torch.solver import multigrid as tmg
from zephyr_tpu_torch.solver import stratified as tstrat
from zephyr_tpu_torch.solver.helmholtz import shifted_velocity as tshift

SHAPES = [(12, 16, 2), (13, 9, 3), (37, 53, 1), (2, 7, 2)]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel())


def _cplx(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.mark.parametrize('nz,nx,R', SHAPES)
def test_jacobi_sweep_twin_matches_jax(nz, nx, R):
    'K5 dispatch on the CPU against the JAX batched sweep.'
    rng = np.random.default_rng(nz * 100 + nx)
    p, d = _cplx(rng, 9, nz, nx), _cplx(rng, nz, nx)
    b, u = _cplx(rng, R, nz, nx), _cplx(rng, R, nz, nx)
    out_t = tst.jacobi_sweep_batched(*map(torch.from_numpy, (p, d, b, u)))
    out_j = jax.vmap(lambda bb, uu: jst.jacobi_sweep_fast(
        jnp.asarray(p), jnp.asarray(d), bb, uu))(jnp.asarray(b),
                                                 jnp.asarray(u))
    assert out_t.shape == (R, nz, nx)
    assert _rel(out_t, out_j) < 1e-12


@pytest.mark.parametrize('nz,nx,R', SHAPES)
def test_transfers_match_jax(nz, nx, R):
    'K7 dispatch (restrict, prolong) on the CPU against the JAX transfers.'
    rng = np.random.default_rng(nz * 7 + nx)
    nzc, nxc = (nz + 1) // 2, (nx + 1) // 2
    v, vc = _cplx(rng, R, 1, nz, nx), _cplx(rng, R, 1, nzc, nxc)
    rc_t = tmg.restrict(torch.from_numpy(v))
    rc_j = jax.vmap(jmg.restrict)(jnp.asarray(v))
    assert rc_t.shape == (R, 1, nzc, nxc)
    assert _rel(rc_t, rc_j) < 1e-12
    pr_t = tmg.prolong(torch.from_numpy(vc), nz, nx)
    pr_j = jax.vmap(lambda q: jmg.prolong(q, nz, nx))(jnp.asarray(vc))
    assert pr_t.shape == (R, 1, nz, nx)
    assert _rel(pr_t, pr_j) < 1e-12
    # R = (1/4) P^T on the cropped grid: <R v, w> = <v, P w> / 4
    lhs = torch.sum(rc_t * torch.from_numpy(vc))
    rhs = torch.sum(torch.from_numpy(v) * pr_t) / 4
    assert abs(complex(lhs - rhs)) < 1e-12 * abs(complex(rhs))


@pytest.mark.parametrize('nz,nx', [(12, 16), (13, 9), (5, 3)])
def test_transpose_planes_match_jax_and_dense(nz, nx):
    rng = np.random.default_rng(nz + nx)
    p = _cplx(rng, 2, 2, 9, nz, nx)
    pt_t = tst.transpose_block_planes(torch.from_numpy(p))
    pt_j = jst.transpose_block_planes(jnp.asarray(p))
    assert np.array_equal(pt_t.numpy(), np.asarray(pt_j))
    scalar = p[0, 1]
    A = tst.planes_to_dense(scalar)
    AT = tst.planes_to_dense(tst.transpose_planes(torch.from_numpy(scalar)))
    assert np.array_equal(AT, A.T)


def _hiers(coarse):
    nz, nx = 44, 37
    c = np.full((nz, nx), 1500. + 0j)
    c[nz // 2:] = 2400.
    pj = jplanes(jshift(jnp.asarray(c), 0.5j), jnp.ones((nz, nx)), 150.,
                 pml_cap=1.0)[None, None]
    pt = tplanes(tshift(torch.from_numpy(c), 0.5j),
                 torch.ones((nz, nx), dtype=torch.float64), 150.,
                 pml_cap=1.0)[None, None]
    hj = jax.jit(lambda p: jmg.transpose_hierarchy(jmg.build_hierarchy(
        p, min_size=10, coarse=coarse)))(pj)
    ht = tmg.transpose_hierarchy(tmg.build_hierarchy(pt, min_size=10,
                                                     coarse=coarse))
    return hj, ht


@pytest.mark.parametrize('coarse', ['inv', 'lu'])
def test_transpose_hierarchy_and_v_cycle_match_jax(coarse):
    hj, ht = _hiers(coarse)
    assert len(ht.levels) == len(hj.levels) == 3
    for lj, lt in zip(hj.levels, ht.levels):
        assert _rel(lt.planes, lj.planes) < 1e-12
        assert _rel(lt.dinv, lj.dinv) < 1e-12
    if coarse == 'inv':
        assert _rel(ht.coarse_inv, hj.coarse_inv) < 1e-10
    else:
        assert ht.coarse_inv is None and ht.coarse_lu is not None
    rng = np.random.default_rng(5)
    b = _cplx(rng, 3, 1, 44, 37)
    # the default V-cycle (nu2=2: K4 then K5 per level) on the transposed
    # hierarchy
    x_j = jax.jit(jax.vmap(lambda bb: jmg.v_cycle(hj, bb, omega=0.5)))(
        jnp.asarray(b))
    x_t = tmg.v_cycle(ht, torch.from_numpy(b), omega=0.5)
    assert _rel(x_t, x_j) < 1e-10


def test_stratified_transpose_matches_jax():
    rng = np.random.default_rng(11)
    nz, nx = 24, 20
    l, d, u = _cplx(rng, nz, nx), _cplx(rng, nz, nx) + 6., _cplx(rng, nz, nx)
    for a_t, a_j in zip(tstrat.transpose_strat(tuple(map(torch.from_numpy,
                                                         (l, d, u)))),
                        jstrat.transpose_strat((jnp.asarray(l),
                                                jnp.asarray(d),
                                                jnp.asarray(u)))):
        assert np.array_equal(a_t.numpy(), np.asarray(a_j))
    r = _cplx(rng, 2, 1, nz, nx)
    st = tstrat.pcr_precompute(*map(torch.from_numpy, (l, d, u)))
    sj = jstrat.pcr_precompute(*map(jnp.asarray, (l, d, u)))
    out_t = tstrat.stratified_apply(tstrat.transpose_pcr(st),
                                    torch.from_numpy(r), transpose=True)
    out_j = jstrat.stratified_apply(sj, jnp.asarray(r), transpose=True)
    assert _rel(out_t, out_j) < 1e-12
