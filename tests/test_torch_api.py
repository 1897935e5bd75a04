'''
The public API the port carries beside the solver paths, against the
JAX package's on the CPU, complex128 / float64, on inputs made from
numpy seeds: ``ops.special.bessel_i0`` and ``sinc`` (rel 1e-14),
``ops.stencil.block_planes_to_dense`` (exact), the solver exports
(``gmres``, ``gmres_cycle``, ``bicgstab_batched``, ``bicgstab`` with
``x0``, ``solve_batched_jit``: iteration counts equal, rel 1e-10) and
``backend.discretization.default_complex_dtype``.
'''

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zephyr_tpu.ops import special as jsp
from zephyr_tpu.ops import stencil as jst
from zephyr_tpu.solver import krylov as jk
import zephyr_tpu.solver as jsolver
from zephyr_tpu_torch.backend.discretization import default_complex_dtype
from zephyr_tpu_torch.ops import special as tsp
from zephyr_tpu_torch.ops import stencil as tst
import zephyr_tpu_torch.solver as tsolver
from zephyr_tpu_torch.solver import krylov as tk

N = 12


def _rel(a, b):
    a, b = (np.asarray(v.detach() if torch.is_tensor(v) else v)
            for v in (a, b))
    return np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel())


def test_public_names_match_the_jax_package():
    'Every name of zephyr_tpu.solver (and the frontend) exists in the port.'
    for name in ('gmres', 'gmres_cycle', 'bicgstab', 'bicgstab_batched',
                 'solve_batched_jit', 'solve_batched', 'solve_info'):
        assert hasattr(jsolver, name) and hasattr(tsolver, name), name
    import zephyr_tpu.frontend as jf
    import zephyr_tpu_torch.frontend as tf
    assert set(n for n in dir(jf) if n[0].isupper()) \
        <= set(n for n in dir(tf) if n[0].isupper())
    assert default_complex_dtype('cpu') == torch.complex128
    assert default_complex_dtype('cuda') == torch.complex64


@pytest.mark.parametrize('fn', ['bessel_i0', 'sinc'])
def test_special_functions_match_jax(fn):
    x = np.random.default_rng(0).uniform(-30., 30., 200)
    x[:3] = (0., 1., -2.)
    ref = np.asarray(getattr(jsp, fn)(jnp.asarray(x)))
    out = getattr(tsp, fn)(torch.from_numpy(x))
    assert out.dtype == torch.float64
    assert _rel(out, ref) < 1e-14
    assert np.allclose(out.numpy(), getattr(np, 'i0' if fn == 'bessel_i0'
                                            else 'sinc')(x), rtol=1e-14)


def test_block_planes_to_dense_matches_jax():
    rng = np.random.default_rng(1)
    planes = (rng.standard_normal((2, 2, 9, 5, 7))
              + 1j * rng.standard_normal((2, 2, 9, 5, 7)))
    ref = jst.block_planes_to_dense(planes)
    for p in (planes, torch.from_numpy(planes)):
        out = tst.block_planes_to_dense(p)
        assert out.shape == (2 * 35, 2 * 35)
        assert np.array_equal(out, ref)
    dense = tst.planes_to_dense_torch(torch.from_numpy(planes)).numpy()
    assert np.array_equal(dense, ref)


def _system():
    '''
    A diagonally dominant complex 9-point operator on N x N, its Jacobi
    preconditioner and three right-hand sides (one all zero).
    '''
    rng = np.random.default_rng(2)
    planes = 0.2 * (rng.standard_normal((1, 1, 9, N, N))
                    + 1j * rng.standard_normal((1, 1, 9, N, N)))
    planes[0, 0, 4] += 3.0
    b = (rng.standard_normal((3, 1, N, N))
         + 1j * rng.standard_normal((3, 1, N, N)))
    b[1] = 0.
    x0 = 0.1 * (rng.standard_normal((3, 1, N, N))
                + 1j * rng.standard_normal((3, 1, N, N)))
    return planes, b, x0


@pytest.mark.parametrize('with_x0', [False, True], ids=['zero', 'x0'])
def test_bicgstab_batched_and_x0_match_jax(with_x0):
    '''
    bicgstab_batched (the port's bicgstab on the batch) and bicgstab
    with an initial guess against the JAX package's vmapped ones:
    per-RHS iterations equal, x rel 1e-10.
    '''
    planes, b, x0 = _system()
    pj, pt = jnp.asarray(planes), torch.from_numpy(planes)
    dj, dt = 1.0 / pj[0, 0, 4], 1.0 / pt[0, 0, 4]

    def mvj(v):
        return jst.apply_block_stencil(pj, v)

    def mvt(v):
        return tst.apply_block_stencil(pt, v)

    if with_x0:
        ref = jax.vmap(lambda bb, xx: jk.bicgstab(
            mvj, bb, M=lambda r: dj * r, x0=xx, tol=1e-10,
            maxiter=100))(jnp.asarray(b), jnp.asarray(x0))
        out = tsolver.bicgstab(mvt, torch.from_numpy(b),
                               M=lambda r: dt * r,
                               x0=torch.from_numpy(x0), tol=1e-10,
                               maxiter=100)
    else:
        ref = jk.bicgstab_batched(mvj, jnp.asarray(b), M=lambda r: dj * r,
                                  tol=1e-10, maxiter=100)
        out = tsolver.bicgstab_batched(mvt, torch.from_numpy(b),
                                       M=lambda r: dt * r, tol=1e-10,
                                       maxiter=100)
    assert out.iters.tolist() == np.asarray(ref.iters).tolist()
    assert bool((out.relres <= 1e-10).all())
    for lane in (0, 2):
        assert _rel(out.x[lane], ref.x[lane]) < 1e-10


def test_gmres_exports_match_jax():
    '''
    The exported ``gmres_cycle`` (one GMRES(8) cycle, from x0) and
    ``gmres`` (restarted to tol) against the JAX package's: x rel 1e-10.
    '''
    planes, b, x0 = _system()
    b[1] = b[0]
    pj, pt = jnp.asarray(planes), torch.from_numpy(planes)
    ref = jax.vmap(lambda bb, xx: jk.gmres_cycle(
        lambda v: jst.apply_block_stencil(pj, v), bb, x0=xx, m=8))(
        jnp.asarray(b), jnp.asarray(x0))
    out = tsolver.gmres_cycle(lambda v: tst.apply_block_stencil(pt, v),
                              torch.from_numpy(b), x0=torch.from_numpy(x0),
                              m=8)
    assert _rel(out.x, ref.x) < 1e-10
    out = tsolver.gmres(lambda v: tst.apply_block_stencil(pt, v),
                        torch.from_numpy(b), tol=1e-10, maxiter=80,
                        restart=8)
    assert bool((out.relres <= 1e-10).all())
    x = np.linalg.solve(jst.block_planes_to_dense(planes),
                        b.reshape(3, -1).T).T
    assert _rel(out.x.reshape(3, -1), x) < 1e-9


def test_solve_batched_jit_is_solve_batched():
    from zephyr_tpu_torch.ops.minizephyr_coeff import minizephyr_planes
    c = torch.full((24, 24), 1500. + 0j, dtype=torch.complex128)
    rho = torch.ones((24, 24), dtype=torch.float64)
    cfg = tsolver.SolverConfig(tol=1e-9, mg_min_size=8)
    p = minizephyr_planes(c, rho, 150.)[None, None]
    pp = minizephyr_planes(tsolver.shifted_velocity(c, cfg.shift), rho,
                           150., pml_cap=1.0)[None, None]
    op = tsolver.prepare_operator(p, pp, cfg, with_transpose=False)
    b = torch.zeros((1, 1, 24, 24), dtype=torch.complex128)
    b[0, 0, 12, 12] = 1.
    assert torch.equal(tsolver.solve_batched_jit(op, b, cfg),
                       tsolver.solve_batched(op, b, cfg))
