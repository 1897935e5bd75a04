'''
Port parity: the multigrid hierarchy and the V-cycle of zephyr_tpu_torch
against zephyr_tpu, complex128, on the CSLP-shifted MiniZephyr operator
of a two-layer model.

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


def test_unported_smoothing_raises(hiers):
    _, ht = hiers['inv']
    b = torch.zeros((1, 1, NZ, NX), dtype=torch.complex128)
    with pytest.raises(NotImplementedError, match='K6'):
        tmg.v_cycle(ht, b, nu2=3)
    with pytest.raises(NotImplementedError, match='K6'):
        tmg.v_cycle(ht, b, nu1=3)
    with pytest.raises(NotImplementedError, match='TTI'):
        tmg.build_hierarchy(ht.levels[0].planes, smoother='line')
