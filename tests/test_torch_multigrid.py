'''
Port parity: the multigrid hierarchy and the V-cycle of zephyr_tpu_torch
against zephyr_tpu, complex128, on the CSLP-shifted MiniZephyr operator
of a two-layer model, at every scalar sweep-count regime (the downstroke
kernel K2 at nu1 = 1, 2; the two-sweep kernel K6 from three sweeps on;
none at nu = 0) and for the public ``presmooth_residual`` (K9 at
nu1 = 2), on the forward and on the transposed hierarchy.

Tolerance: rel 1e-10 — the dense coarsest-level inverse/LU goes through
two LAPACK builds whose rounding differs by the coarse operator's
condition number times machine epsilon.
'''

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zephyr_tpu.ops.minizephyr_coeff import minizephyr_planes as jplanes
from zephyr_tpu.solver import multigrid as jmg
from zephyr_tpu.solver.helmholtz import shifted_velocity as jshift
from zephyr_tpu_torch.ops.minizephyr_coeff import minizephyr_planes as tplanes
from zephyr_tpu_torch.solver import multigrid as tmg
from zephyr_tpu_torch.solver.helmholtz import shifted_velocity as tshift

NZ, NX, FREQ = 44, 37, 150.
TOL = 1e-10


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel())


def _shifted_planes():
    c = np.full((NZ, NX), 1500. + 0j)
    c[NZ // 2:] = 2400.
    pj = jplanes(jshift(jnp.asarray(c), 0.5j), jnp.ones((NZ, NX)), FREQ,
                 pml_cap=1.0)[None, None]
    pt = tplanes(tshift(torch.from_numpy(c), 0.5j),
                 torch.ones((NZ, NX), dtype=torch.float64), FREQ,
                 pml_cap=1.0)[None, None]
    return pj, pt


@pytest.fixture(scope='module')
def hiers():
    pj, pt = _shifted_planes()
    out = {}
    for coarse in ('inv', 'lu'):
        out[coarse] = (jmg.build_hierarchy(pj, min_size=10, coarse=coarse),
                       tmg.build_hierarchy(pt, min_size=10, coarse=coarse))
    return out


def test_build_hierarchy_parity(hiers):
    hj, ht = hiers['inv']
    assert len(ht.levels) == len(hj.levels) == 3
    for lj, lt in zip(hj.levels, ht.levels):
        assert lt.planes.shape == lj.planes.shape
        assert _rel(lt.planes, lj.planes) < TOL
        assert _rel(lt.dinv, lj.dinv) < TOL
        assert np.array_equal(lt.mask.numpy(), np.asarray(lj.mask))
    assert ht.levels[-1].planes.shape[-2:] == (11, 10)   # odd coarse grid
    assert _rel(ht.coarse_inv, hj.coarse_inv) < TOL


@pytest.mark.parametrize('coarse', ['inv', 'lu'])
def test_v_cycle_parity(hiers, coarse):
    hj, ht = hiers[coarse]
    rng = np.random.default_rng(2)
    b = (rng.standard_normal((3, 1, NZ, NX))
         + 1j * rng.standard_normal((3, 1, NZ, NX)))
    x_j = jax.vmap(lambda bb: jmg.v_cycle(hj, bb, omega=0.5, nu1=2,
                                          nu2=1))(jnp.asarray(b))
    x_t = tmg.v_cycle(ht, torch.from_numpy(b), omega=0.5, nu1=2, nu2=1)
    assert _rel(x_t, x_j) < TOL
    # single-sweep downstroke (mg_nu1=1) too
    x_j1 = jax.vmap(lambda bb: jmg.v_cycle(hj, bb, omega=0.5, nu1=1,
                                           nu2=1))(jnp.asarray(b))
    x_t1 = tmg.v_cycle(ht, torch.from_numpy(b), omega=0.5, nu1=1, nu2=1)
    assert _rel(x_t1, x_j1) < TOL


def _rhs(seed, R=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((R, 1, NZ, NX))
            + 1j * rng.standard_normal((R, 1, NZ, NX)))


@pytest.fixture(scope='module')
def transposed(hiers):
    hj, ht = hiers['inv']
    return jmg.transpose_hierarchy(hj), tmg.transpose_hierarchy(ht)


@pytest.mark.parametrize('nu1,nu2', [(0, 1), (1, 0), (3, 1), (2, 3), (3, 3),
                                     (4, 4), (5, 2)])
def test_v_cycle_sweep_counts_match_jax(hiers, transposed, nu1, nu2):
    '''
    Every sweep-count regime of the scalar smoother (zero sweeps, odd
    counts, K6 from zero and from u) on the forward and the transposed
    hierarchy.
    '''
    b = _rhs(nu1 * 10 + nu2)
    for hj, ht in (hiers['inv'], transposed):
        x_j = jax.vmap(lambda bb: jmg.v_cycle(hj, bb, omega=0.5, nu1=nu1,
                                              nu2=nu2))(jnp.asarray(b))
        x_t = tmg.v_cycle(ht, torch.from_numpy(b), omega=0.5, nu1=nu1,
                          nu2=nu2)
        assert _rel(x_t, x_j) < TOL


@pytest.mark.parametrize('nu1', [0, 1, 2, 3])
def test_presmooth_residual_scalar_matches_jax(hiers, transposed, nu1):
    '''
    The public ``presmooth_residual`` on a scalar level (K9 at nu1 = 2;
    at nu1 = 0 the iterate is zero and the residual the masked b).
    '''
    b = _rhs(40 + nu1, R=3)
    for hj, ht in (hiers['inv'], transposed):
        for lev in (0, 1):
            u_j, r_j = jax.vmap(lambda bb: jmg.presmooth_residual(
                hj.levels[lev], bb, 0.5, nu1))(jnp.asarray(
                    b[..., ::2 ** lev, ::2 ** lev]))
            u_t, r_t = tmg.presmooth_residual(
                ht.levels[lev], torch.from_numpy(
                    np.ascontiguousarray(b[..., ::2 ** lev, ::2 ** lev])),
                0.5, nu1)
            assert u_t.shape == r_t.shape == u_j.shape
            if nu1 == 0:
                assert not bool(u_t.abs().sum())
            else:
                assert _rel(u_t, u_j) < TOL
            assert _rel(r_t, r_j) < TOL


def test_unported_smoothing_raises(hiers):
    '''
    Smoothers and coarse solves the port lacks raise (an unknown name;
    the iterative coarse solve builds with neither LU nor inverse, and is
    held against the JAX package in tests/test_torch_solver_configs.py);
    smoother='line' on scalar planes is 'jacobi', as in the JAX package.
    '''
    _, ht = hiers['inv']
    with pytest.raises(ValueError, match='coarse'):
        tmg.build_hierarchy(ht.levels[0].planes, coarse='cholesky')
    hi = tmg.build_hierarchy(ht.levels[0].planes, min_size=10,
                             coarse='iterative')
    assert hi.coarse_lu is None and hi.coarse_inv is None
    hl = tmg.build_hierarchy(ht.levels[0].planes, min_size=10,
                             coarse='inv', smoother='line')
    assert all(lv.linez is None and lv.linex is None for lv in hl.levels)
    r = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 1, NZ, NX)) + 0j)
    assert torch.equal(tmg.v_cycle(hl, r, omega=0.5, nu1=2, nu2=1),
                       tmg.v_cycle(ht, r, omega=0.5, nu1=2, nu2=1))
    with pytest.raises(ValueError, match='smoother'):
        tmg.build_hierarchy(ht.levels[0].planes, smoother='sor')
