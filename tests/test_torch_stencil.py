'''
Port parity: zephyr_tpu_torch's stencil algebra, grid transfers and
fused-operator twins against zephyr_tpu on the same inputs (made with
numpy from a seed), both in complex128. The twins are what the CUDA
kernels K1, K2, K4, K6 and K9 are held against on the card; here they are
held against the JAX package's own reference bodies (the functions its
CPU path runs in place of the Pallas kernels), and the K6 and K9 twins
also against the Pallas kernels themselves in interpret mode (complex64).

Tolerance: rel 1e-12 (complex128 rounding; the two frameworks may sum
the same terms in a different order); rel 1e-5 against the Pallas
kernels (float32).
'''

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zephyr_tpu.ops import stencil as jst
from zephyr_tpu.solver import multigrid as jmg
from zephyr_tpu_torch.ops import stencil as tst
from zephyr_tpu_torch.solver import multigrid as tmg

TOL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel())


def _cplx(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _inputs(nz, nx, R=3, seed=0):
    'Random planes, damped diagonal inverse, ring mask and fields.'
    rng = np.random.default_rng(seed)
    planes = _cplx(rng, 9, nz, nx)
    planes[4] += 8.0          # diagonally dominant, like a shifted operator
    d = 0.5 / planes[4]
    mask = np.ones((nz, nx))
    mask[0, :] = mask[-1, :] = mask[:, 0] = mask[:, -1] = 0
    b = _cplx(rng, R, nz, nx)
    u = _cplx(rng, R, nz, nx)
    ec = _cplx(rng, R, (nz + 1) // 2, (nx + 1) // 2)
    return planes, d, mask, b, u, ec


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize('nz,nx', [(16, 12), (13, 11)])
def test_apply_stencil_parity(nz, nx):
    planes, _, _, _, u, _ = _inputs(nz, nx)
    out_t = tst.apply_stencil(*_t(planes, u))
    out_j = jst.apply_stencil(*_j(planes, u))
    assert _rel(out_t, out_j) < TOL
    # the batched dispatch runs the twin for CPU tensors
    out_d = tst.apply_stencil_batched(*_t(planes, u))
    assert torch.equal(out_d, out_t)
    # and the dense assembly of the port agrees with the numpy one
    dense_t = tst.planes_to_dense_torch(torch.from_numpy(planes)[None, None])
    assert np.array_equal(dense_t.numpy(), jst.planes_to_dense(planes))


def test_sanitize_and_galerkin_parity():
    planes, *_ = _inputs(15, 10)
    s_t = tst.sanitize_planes(torch.from_numpy(planes))
    s_j = jst.sanitize_planes(jnp.asarray(planes))
    assert np.array_equal(s_t.numpy(), np.asarray(s_j))
    g_t = tmg.galerkin_coarsen(torch.from_numpy(planes)[None, None])
    g_j = jmg.galerkin_coarsen(jnp.asarray(planes)[None, None])
    assert g_t.shape == (1, 1, 9, 8, 5)
    assert _rel(g_t, g_j) < TOL


@pytest.mark.parametrize('nz,nx', [(16, 12), (13, 11), (12, 7)])
def test_restrict_prolong_parity(nz, nx):
    *_, b, _, ec = _inputs(nz, nx)
    r_t = tmg._restrict_ref(torch.from_numpy(b))
    r_j = jmg._restrict_ref(jnp.asarray(b))
    assert r_t.shape == ((3, (nz + 1) // 2, (nx + 1) // 2))
    assert _rel(r_t, r_j) < TOL
    p_t = tmg._prolong_ref(torch.from_numpy(ec), nz, nx)
    p_j = jmg._prolong_ref(jnp.asarray(ec), nz, nx)
    assert p_t.shape == (3, nz, nx)
    assert _rel(p_t, p_j) < TOL


@pytest.mark.parametrize('nsweeps', [1, 2])
@pytest.mark.parametrize('nz,nx', [(16, 12), (13, 11)])
def test_presmooth_restrict_twin_parity(nsweeps, nz, nx):
    'The K2 twin (both sweep counts) against the JAX reference bodies.'
    planes, d, mask, b, _, _ = _inputs(nz, nx)
    u_t, rc_t = tst.presmooth_restrict_batched(*_t(planes, d, mask, b),
                                               nsweeps)
    ref = jst._ps2rr_ref if nsweeps == 2 else jst._ps1rr_ref
    u_j, rc_j = ref(*_j(planes, d, mask, b))
    assert rc_t.shape == (3, (nz + 1) // 2, (nx + 1) // 2)
    assert _rel(u_t, u_j) < TOL
    assert _rel(rc_t, rc_j) < TOL


@pytest.mark.parametrize('nz,nx', [(16, 12), (13, 11)])
def test_prolong_add_smooth_twin_parity(nz, nx):
    'The K4 twin against the JAX reference body.'
    planes, d, mask, b, u, ec = _inputs(nz, nx)
    out_t = tst.prolong_add_smooth_batched(*_t(planes, d, mask, b, u, ec))
    out_j = jst._pas_ref(*_j(planes, d, mask, b, u, ec))
    assert _rel(out_t, out_j) < TOL


@pytest.mark.parametrize('nz,nx', [(16, 12), (13, 11), (7, 9)])
def test_jacobi2_and_presmooth_residual_twin_parity(nz, nx):
    '''
    The K6 twins (from u and from zero) and the K9 twin, called through
    their dispatch functions, against the JAX reference bodies.
    '''
    planes, d, mask, b, u, _ = _inputs(nz, nx)
    out_t = tst.jacobi_sweep2_batched(*_t(planes, d, b, u))
    assert _rel(out_t, jst._jacobi2_ref(*_j(planes, d, b, u))) < TOL
    out_t = tst.jacobi_sweep2_batched(*_t(planes, d, b))
    assert _rel(out_t, jst._jacobi2z_ref(*_j(planes, d, b))) < TOL
    u_t, r_t = tst.presmooth_residual_batched(*_t(planes, d, mask, b))
    u_j, r_j = jst._ps2r_ref(*_j(planes, d, mask, b))
    assert _rel(u_t, u_j) < TOL and _rel(r_t, r_j) < TOL


def test_jacobi2_and_presmooth_residual_twins_match_pallas():
    '''
    complex64 at 16x128, R=2: the K6 twins and the K9 twin against
    ``jacobi_sweep2_pallas_batched`` and
    ``presmooth2_residual_pallas_batched`` in interpret mode, as the JAX
    package's own tests run them on the CPU.
    '''
    from zephyr_tpu.ops.pallas_stencil import (
        jacobi_sweep2_pallas_batched, presmooth2_residual_pallas_batched)
    planes, d, mask, b, u, _ = _inputs(16, 128, R=2, seed=5)
    planes, d, b, u = (a.astype(np.complex64) for a in (planes, d, b, u))
    mask = mask.astype(np.float32)
    for uu in (u, None):
        out_p = jacobi_sweep2_pallas_batched(
            *_j(planes, d, b), None if uu is None else jnp.asarray(uu),
            interpret=True)
        args = _t(planes, d, b) + ([] if uu is None else _t(uu))
        out_t = tst.jacobi_sweep2_batched(*args)
        assert out_t.dtype == torch.complex64
        assert _rel(out_t, out_p) < 1e-5
    u_p, r_p = presmooth2_residual_pallas_batched(*_j(planes, d, mask, b),
                                                  interpret=True)
    u_t, r_t = tst.presmooth_residual_batched(*_t(planes, d, mask, b))
    assert _rel(u_t, u_p) < 1e-5 and _rel(r_t, r_p) < 1e-5


def test_block_diag_helpers_parity():
    rng = np.random.default_rng(3)
    planes = _cplx(rng, 2, 2, 9, 6, 5)
    r = _cplx(rng, 4, 2, 6, 5)
    for B in (1, 2):
        p = planes[:B, :B]
        D_t = tst.invert_block_diag(tst.block_diag(torch.from_numpy(p)))
        D_j = jst.invert_block_diag(jst.block_diag(jnp.asarray(p)))
        assert _rel(D_t, D_j) < TOL
        y_t = tst.block_diag_matvec(D_t, torch.from_numpy(r[:, :B]))
        y_j = jst.block_diag_matvec(D_j, jnp.asarray(r[:, :B]))
        assert _rel(y_t, y_j) < TOL
        a_t = tst.apply_block_stencil(torch.from_numpy(p),
                                      torch.from_numpy(r[:, :B]))
        a_j = jst.apply_block_stencil(jnp.asarray(p), jnp.asarray(r[:, :B]))
        assert _rel(a_t, a_j) < TOL
