'''
Port parity: the MiniZephyr coefficient planes of zephyr_tpu_torch
against zephyr_tpu's, complex128, on a heterogeneous model made with
numpy from a seed, with PML, free surfaces, 2.5D ky, Laplace damping
(tau) and the capped preconditioner PML.

Tolerance: rel 1e-12 (complex128 rounding of the same formulas).
'''

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zephyr_tpu.ops.minizephyr_coeff import minizephyr_planes as jplanes
from zephyr_tpu.solver.helmholtz import shifted_velocity as jshift
from zephyr_tpu_torch.convert import model_from_numpy
from zephyr_tpu_torch.ops.minizephyr_coeff import minizephyr_planes as tplanes
from zephyr_tpu_torch.solver.helmholtz import shifted_velocity as tshift

NZ, NX = 30, 26
rng = np.random.default_rng(11)
C = 1500. + 1000. * rng.random((NZ, NX)) + 5j * rng.random((NZ, NX))
RHO = 1.0 + 0.5 * rng.random((NZ, NX))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel())


CASES = [
    dict(),
    dict(freeSurf=(True, False, True, False)),
    dict(freeSurf=(False, True, False, True), nPML=6),
    dict(ky=0.013, tau=0.4),
    dict(pml_cap=1.0, dx=2.0, dz=1.5),
    dict(pml=False),
    dict(freq=90. - 3j, freeSurf=(True, True, False, False), ky=0.005,
         tau=1.5, pml_cap=2.0),
]


@pytest.mark.parametrize('kw', CASES)
def test_planes_parity(kw):
    kw = dict(kw)
    freq = kw.pop('freq', 120.)
    p_j = jplanes(jnp.asarray(C), jnp.asarray(RHO), freq, **kw)
    c, rho = model_from_numpy(C, RHO, device='cpu')
    p_t = tplanes(c, rho, freq, **kw)
    assert p_t.shape == (9, NZ, NX) and p_t.dtype == torch.complex128
    assert _rel(p_t, p_j) < 1e-12


def test_shifted_planes_parity():
    'The CSLP preconditioner planes (shifted velocity, capped PML).'
    p_j = jplanes(jshift(jnp.asarray(C), 0.5j), jnp.asarray(RHO), 120.,
                  pml_cap=1.0)
    c, rho = model_from_numpy(C, RHO, device='cpu')
    p_t = tplanes(tshift(c, 0.5j), rho, 120., pml_cap=1.0)
    assert _rel(p_t, p_j) < 1e-12


def test_planes_autograd_flows_through_c():
    c, rho = model_from_numpy(C, RHO, device='cpu')
    c = c.clone().requires_grad_(True)
    p = tplanes(c, rho, 120.)
    torch.sum(torch.abs(p) ** 2).backward()
    assert c.grad is not None and bool(torch.isfinite(c.grad).all())
