'''
Port parity of the FWI gradient routine and what it stands on:
``resample_field`` (and its VJP) against ``jax.image.resize``
(``jax.vjp``), the grid plan, the Kaiser stamps and the viscous velocity
against the JAX package, and ``fwi_misfit_grad_chunked`` against the JAX
package's on its dense-R path and on its stamp path with per-frequency
grids (targetGPW) and on a Marmousi model with the production config
and x-panels (the transposed-planes operator runs the panel family),
plus a central-difference check of the port's gradient; and the port's nearest-gridpoint search (which never builds
the grid-sized distance array) against the JAX package's. CPU,
complex128 / float64.

Tolerances: rel 1e-12 for the resampler and its VJP (the same weights,
contracted in another order), exact equality for the host-side plan and
stamps, rel 1e-12 for the viscous velocity; misfit rel 1e-8 and
gradient rel 1e-6 between the two routines (both solve to tol 1e-9; the
trajectories differ by rounding); the central difference (eps 0.05 on a
smoothed direction, solves at tol 1e-11) within 2e-4 relative, as the
JAX package's own test.
'''

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import zephyr_tpu.backend as jb
from zephyr_tpu.backend.interpolation import resample_field as jresample
from zephyr_tpu.parallel import multifreq as jmf
from zephyr_tpu.solver.helmholtz import SolverConfig as JConfig
import zephyr_tpu_torch.backend as tb
from zephyr_tpu_torch.backend.interpolation import resample_field
from zephyr_tpu_torch.parallel import multifreq as tmf
from zephyr_tpu_torch.solver.helmholtz import SolverConfig

RESIZES = [((37, 53), (19, 27)), ((19, 27), (37, 53)), ((33, 20), (50, 11)),
           ((40, 40), (24, 40)), ((64, 64), (48, 48))]
OPTS = dict(tol=1e-9, maxiter=300, mg_min_size=10)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel())


@pytest.mark.parametrize('shape_in,shape_out', RESIZES)
@pytest.mark.parametrize('kind', ['real', 'complex'])
def test_resample_field_and_vjp_match_jax(shape_in, shape_out, kind):
    rng = np.random.default_rng(sum(shape_in) + sum(shape_out))
    f = rng.standard_normal(shape_in)
    ct = rng.standard_normal(shape_out)
    if kind == 'complex':
        f = f + 1j * rng.standard_normal(shape_in)
        ct = ct + 1j * rng.standard_normal(shape_out)
    out_j, vjp = jax.vjp(lambda v: jresample(v, shape_out), jnp.asarray(f))
    ft = torch.from_numpy(f).requires_grad_(True)
    out_t = resample_field(ft, shape_out)
    assert out_t.shape == shape_out
    assert _rel(out_t.detach(), out_j) < 1e-12
    # the weights are real, so both frameworks' cotangent is W^T ct
    g_t, = torch.autograd.grad(out_t, ft, grad_outputs=torch.from_numpy(ct))
    g_j, = vjp(jnp.asarray(ct))
    assert _rel(g_t, g_j) < 1e-12


def test_plan_stamps_and_viscous_velocity_match_jax():
    freqs = np.linspace(0.6, 1.0, 8) * (1500. / 16)
    for n, kw in ((2048, dict(target_gpw=16)), (300, dict(target_gpw=8)),
                  (64, dict(target_gpw=8., quantum=16, min_size=32)),
                  (64, dict())):
        assert (tmf.freq_grid_plan(n, n, freqs, 1500., **kw)
                == jmf.freq_grid_plan(n, n, freqs, 1500., **kw))
    # the nearest-gridpoint search, at random and at tie locations
    cfg = {'nx': 40, 'nz': 48, 'dx': 1.5, 'dz': 1.25, 'xorig': 2.}
    rng = np.random.default_rng(7)
    loc = np.stack([rng.uniform(-3, 65, 60), rng.uniform(-3, 63, 60)], 1)
    for pts in (loc, np.round(loc * 2) / 2 * np.array([1.5, 1.25])):
        assert np.array_equal(tb.SimpleSource(cfg).linIndexOf(pts),
                              jb.SimpleSource(cfg).linIndexOf(pts))
    pos = np.array([[12.3, 40.7], [30.0, 8.2]])
    for receiver in (False, True):
        for a_t, a_j in zip(
                tmf._kaiser_stamps((48, 40), 1.5, 1.25, pos, 4, receiver),
                jmf._kaiser_stamps((48, 40), 1.5, 1.25, pos, 4, receiver)):
            assert np.array_equal(a_t, np.asarray(a_j))
    rng = np.random.default_rng(0)
    c = 1500. + 100. * rng.standard_normal((6, 5)) + 0j
    Q = 20. + rng.random((6, 5))
    for q, fb in ((np.inf, 0.), (Q, 0.), (Q, 40.), (35., 40.)):
        v_t = tmf.viscous_velocity(torch.from_numpy(c), 70., q, fb)
        v_j = jmf.viscous_velocity(jnp.asarray(c), 70., q, fb)
        assert _rel(v_t, v_j) < 1e-12


def test_fwi_gradient_dense_matches_jax():
    nz, nx = 32, 28
    q = np.zeros((1, 2, nz, nx), np.complex128)
    q[:, 0, 10, 10] = 1.0
    q[:, 1, 20, 18] = 1.0
    R = np.zeros((2, nz * nx), np.complex128)
    R[0, 16 * nx + 6] = 1.0
    R[1, 22 * nx + 20] = 1.0
    c = 2000. * np.ones((nz, nx))
    c[12:20, 10:18] -= 150.
    rho = np.ones((nz, nx))
    dobs = np.full((1, 2, 2), 0.01 + 0.02j)
    args = (c, rho, np.array([90.]), q, R, dobs)
    kw = dict(chunk=1, nPML=8, premul=np.array([1.5 - 0.5j]))
    m_j, g_j = jmf.fwi_misfit_grad_chunked(*args, config=JConfig(**OPTS),
                                           **kw)
    m_t, g_t = tmf.fwi_misfit_grad_chunked(*args,
                                           config=SolverConfig(**OPTS),
                                           device='cpu', **kw)
    assert g_t.shape == (nz, nx) and g_t.dtype == np.float64
    assert abs(m_t - m_j) / m_j < 1e-8
    assert _rel(g_t, g_j) < 1e-6


def test_fwi_gradient_panelled_marmousi_matches_jax():
    '''
    The production config (fused cycle, fft_scale=2) with 2 x-panels and
    the nu 3/3 smoother on the bench's Marmousi model cut to 40x36, two
    point sources, three receivers, two frequencies.
    '''
    from bench import _marmousi_c
    nz, nx = 40, 36
    c = _marmousi_c(nz, np.float64)[:, :nx]
    opts = dict(OPTS, mg_coarse='inv', fft_scale=2, hybrid_comp='fused',
                mg_nu1=3, mg_nu2=3, strat_panels=2, strat_overlap=2)
    q = np.zeros((2, 2, nz, nx), np.complex128)
    q[:, 0, 12, 10] = q[:, 1, 26, 24] = 1.0
    R = np.zeros((3, nz * nx), np.complex128)
    for i, (z, x) in enumerate(((30, 8), (10, 30), (20, 18))):
        R[i, z * nx + x] = 1.0
    kw = dict(chunk=2, nPML=8)
    args = (c, np.ones((nz, nx)), np.array([120., 180.]), q, R,
            np.full((2, 2, 3), 0.01 - 0.02j))
    m_j, g_j = jmf.fwi_misfit_grad_chunked(*args, config=JConfig(**opts),
                                           **kw)
    m_t, g_t = tmf.fwi_misfit_grad_chunked(*args,
                                           config=SolverConfig(**opts),
                                           device='cpu', **kw)
    assert abs(m_t - m_j) / m_j < 1e-8
    assert _rel(g_t, g_j) < 1e-6


def _adapted_problem():
    nz = nx = 48
    c = 2000. * np.ones((nz, nx))
    c[20:34, 16:36] -= 120.
    kw = dict(chunk=2, target_gpw=8., cmin=2000., grid_quantum=16,
              grid_min=32, nPML=8,
              src_pos=np.array([[12.0, 12.0], [36.0, 14.0]]),
              rec_pos=np.array([[40.0, 22.0], [16.0, 40.0], [30.0, 44.0]]))
    freqs = np.array([150., 320.])
    assert (tmf.freq_grid_plan(nz, nx, freqs, 2000., target_gpw=8.,
                               quantum=16, min_size=32)
            == [(32, 32), (48, 48)])
    return c, np.ones((nz, nx)), freqs, np.zeros((2, 2, 3), complex), kw


def test_fwi_gradient_stamps_per_frequency_grids_match_jax():
    'The stamp path with a coarser grid for the low frequency (resample).'
    c, rho, freqs, dobs, kw = _adapted_problem()
    m_j, g_j = jmf.fwi_misfit_grad_chunked(c, rho, freqs, None, None, dobs,
                                           config=JConfig(**OPTS), **kw)
    m_t, g_t = tmf.fwi_misfit_grad_chunked(c, rho, freqs, None, None, dobs,
                                           config=SolverConfig(**OPTS),
                                           device='cpu', **kw)
    assert abs(m_t - m_j) / m_j < 1e-8
    assert _rel(g_t, g_j) < 1e-6


def test_fwi_gradient_central_difference():
    c, rho, freqs, dobs, kw = _adapted_problem()
    cfg = SolverConfig(**dict(OPTS, tol=1e-11, maxiter=600))
    stats = {}
    m0, g = tmf.fwi_misfit_grad_chunked(c, rho, freqs, None, None, dobs,
                                        config=cfg, stats=stats,
                                        device='cpu', **kw)
    assert np.isfinite(m0) and np.isfinite(g).all()
    assert stats['shapes'] == [(32, 32), (48, 48)]
    assert len(stats['iters']) == 2 and set(stats['seconds']) == {
        'prep', 'fwd_solve', 'residual', 'adj_solve', 'grad_term'}
    rng = np.random.default_rng(3)
    dc = rng.standard_normal(c.shape)
    # smooth the direction so the cubic-resample VJP is well resolved
    k = np.ones(5) / 5.
    dc = np.apply_along_axis(np.convolve, 0, dc, k, mode='same')
    dc = np.apply_along_axis(np.convolve, 1, dc, k, mode='same')
    eps = 0.05
    m_p, _ = tmf.fwi_misfit_grad_chunked(c + eps * dc, rho, freqs, None,
                                         None, dobs, config=cfg,
                                         device='cpu', **kw)
    m_m, _ = tmf.fwi_misfit_grad_chunked(c - eps * dc, rho, freqs, None,
                                         None, dobs, config=cfg,
                                         device='cpu', **kw)
    fd = (m_p - m_m) / (2 * eps)
    an = float(np.sum(g * dc))
    assert abs(fd - an) / abs(an) < 2e-4, (fd, an)
