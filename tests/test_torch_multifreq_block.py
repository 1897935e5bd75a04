'''
Port parity of multi-frequency block modelling:
zephyr_tpu_torch.parallel's ``build_multifreq_ops``, ``multifreq_solve``,
``multifreq_dpred``, ``multifreq_dpred_chunked`` and ``fwi_misfit``
against zephyr_tpu.parallel on the same inputs, on the CPU in complex128,
at 48x40 with 2 frequencies, 3 point sources and 4 receivers (two taps
each), the production solver config (cut to three multigrid levels by
mg_min_size=10) at tol 1e-10; plus the Eurus (B=2) forward and its
gradient, and the refusal of the CPU without ``device='cpu'``.

The JAX references come from one compiled program: the JAX package's
operators (``build_multifreq_ops``, carried to the port by
``convert.multifreq_ops_from_numpy``) and their ``multifreq_solve``, the
data and ``jax.value_and_grad`` of ``fwi_misfit`` at a real model, and
the data at a complex (attenuating) model.

Tolerances (relative, 2-norm): every wavefield, data cube, misfit and
gradient within 1e-6 (both packages solve to 1e-10; the trajectories
differ by rounding). The port applies the receiver matrix as a gather
over its nonzeros, not a matmul, so no TF32 setting reaches the data.
'''

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zephyr_tpu.parallel import multifreq as jmf
from zephyr_tpu.solver.helmholtz import SolverConfig as JaxConfig
from zephyr_tpu_torch import convert
from zephyr_tpu_torch.backend import Eurus
from zephyr_tpu_torch.parallel import multifreq as tmf
from zephyr_tpu_torch.solver.helmholtz import SolverConfig

NZ, NX = 48, 40
FREQS = np.array([150., 220.])
NPML = 8
OPTS = dict(tol=1e-10, maxiter=2000, mg_coarse='inv', mg_min_size=10,
            fft_mode='strat', fft_scale=2, hybrid_comp='fused', mg_nu1=2,
            mg_nu2=1)
TOL = 1e-6


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel())


def _inputs():
    '''
    The seeded model (a slow box in 2000 m/s), its attenuating complex
    twin, unit point sources (nfreq, nsrc, nz, nx), a two-tap receiver
    matrix (nrec, nz nx) and small observed data.
    '''
    c = 2000. * np.ones((NZ, NX))
    c[20:30, 10:25] = 2200.
    c_cplx = c + 0.5j * c / 40.
    nsrc, nrec = 3, 4
    q = np.zeros((len(FREQS), nsrc, NZ, NX), np.complex128)
    for s in range(nsrc):
        q[:, s, 10 + 6 * s, 8 + 5 * s] = 1.
    R = np.zeros((nrec, NZ * NX), np.complex128)
    for r in range(nrec):
        R[r, (8 + 9 * r) * NX + 32] = 1.
        R[r, (8 + 9 * r) * NX + 33] = 0.5
    rng = np.random.default_rng(4)
    dobs = 1e-3 * (rng.standard_normal((len(FREQS), nsrc, nrec))
                   + 1j * rng.standard_normal((len(FREQS), nsrc, nrec)))
    return c, c_cplx, np.ones((NZ, NX)), q, R, dobs


@functools.lru_cache(maxsize=None)
def _jax_refs():
    'The JAX package\'s operators, wavefields, data, misfit and gradient.'
    c, c_cplx, rho, q, R, dobs = _inputs()
    cfg = JaxConfig(**OPTS)
    b = jnp.asarray(q)[:, :, None]

    def refs(c, c_cplx, rho, freqs, q, R, dobs):
        ops = jmf.build_multifreq_ops(c, rho, freqs, cfg, nPML=NPML)
        x = jmf.multifreq_solve(ops, b, cfg)

        def objective(cc):
            d = jmf.multifreq_dpred(cc, rho, freqs, q, R, config=cfg,
                                    nPML=NPML)
            return 0.5 * jnp.sum(jnp.abs(d - dobs) ** 2), d

        (f, d), g = jax.value_and_grad(objective, has_aux=True)(c)
        d_cplx = jmf.multifreq_dpred(c_cplx, rho, freqs, q, R, config=cfg,
                                     nPML=NPML)
        return ops, x, f, d, g, d_cplx

    out = jax.jit(refs)(*(jnp.asarray(a) for a in (c, c_cplx, rho, FREQS,
                                                   q, R, dobs)))
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    'One torch thread: at these sizes more are no faster.'
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_multifreq_solve_on_jax_operators():
    '''
    The JAX package's stacked operators carried over per frequency; both
    packages' multifreq_solve on them, conjugated wavefields within 1e-6.
    '''
    ops_np, x_ref = _jax_refs()[:2]
    ops = convert.multifreq_ops_from_numpy(ops_np, device='cpu')
    assert len(ops) == len(FREQS)
    assert ops[0].planes.shape == (1, 1, 9, NZ, NX)
    assert ops[1].hierT is not None and ops[1].planesT is not None
    q = _inputs()[3]
    x = tmf.multifreq_solve(ops, q[:, :, None], SolverConfig(**OPTS))
    assert x.shape == (len(FREQS), 3, 1, NZ, NX)
    assert _rel(x.numpy(), x_ref) < TOL


def test_build_multifreq_ops_planes_match_jax():
    'The port builds the same planes as the JAX package, per frequency.'
    c, _, rho, *_ = _inputs()
    ops = tmf.build_multifreq_ops(c, rho, FREQS, SolverConfig(**OPTS),
                                  device='cpu', nPML=NPML)
    ref = _jax_refs()[0].planes
    for i, op in enumerate(ops):
        assert op.planes.dtype == torch.complex128
        assert _rel(op.planes.numpy(), ref[i]) < 1e-12


@pytest.mark.parametrize('model', ['real', 'complex'])
def test_multifreq_dpred_matches_jax(model):
    'The differentiable forward map, real and attenuating (complex) c.'
    c, c_cplx, rho, q, R, _ = _inputs()
    ref = _jax_refs()[3 if model == 'real' else 5]
    d = tmf.multifreq_dpred(c if model == 'real' else c_cplx, rho, FREQS, q,
                            R, config=SolverConfig(**OPTS), device='cpu',
                            nPML=NPML)
    assert d.shape == (len(FREQS), 3, 4) and d.dtype == torch.complex128
    assert _rel(d.numpy(), ref) < TOL


@pytest.mark.parametrize('model', ['real', 'complex'])
def test_multifreq_dpred_chunked_matches_jax(model):
    '''
    The host-driven chunked forward modelling (one prepared operator a
    frequency, restarted chunked solves) against the JAX package's data,
    with its per-frequency stats.
    '''
    c, c_cplx, rho, q, R, _ = _inputs()
    ref = _jax_refs()[3 if model == 'real' else 5]
    stats = {}
    d = tmf.multifreq_dpred_chunked(c if model == 'real' else c_cplx, rho,
                                    FREQS, q, R,
                                    config=SolverConfig(**OPTS), chunk=16,
                                    device='cpu', stats=stats, nPML=NPML)
    assert isinstance(d, np.ndarray) and d.dtype == np.complex128
    assert d.shape == (len(FREQS), 3, 4)
    assert _rel(d, ref) < TOL
    assert len(stats['iters']) == len(FREQS)
    assert max(stats['relres']) <= OPTS['tol']


def test_fwi_misfit_value_and_gradient_match_jax():
    '''
    fwi_misfit's value and its torch.autograd gradient w.r.t. c against
    jax.value_and_grad of the JAX package's fwi_misfit (a real objective
    of a real model: no conjugation convention enters).
    '''
    c, _, rho, q, R, dobs = _inputs()
    _, _, f_ref, _, g_ref, _ = _jax_refs()
    ct = torch.tensor(c, requires_grad=True)
    f = tmf.fwi_misfit(ct, dobs, rho, FREQS, q, R,
                       config=SolverConfig(**OPTS), device='cpu', nPML=NPML)
    g, = torch.autograd.grad(f, ct)
    assert abs(float(f.detach()) - float(f_ref)) / float(f_ref) < TOL
    assert g.shape == (NZ, NX) and bool(torch.isfinite(g).all())
    assert _rel(g.numpy(), g_ref) < TOL


def test_eurus_forward_and_gradient():
    '''
    With eurus_params the map solves the 2x2 block (TTI) system: its data
    equal the port's Eurus discretization's wavefields through the same
    receivers, and the reverse-mode gradient of the data misfit (GMRES
    transpose solves) equals the port's forward-mode derivative in a
    seeded direction, rel 1e-6 (tests/test_torch_tti_gradient.py holds
    it against jax.grad).
    '''
    import torch.autograd.forward_ad as fwAD
    n_z, n_x, freq = 24, 20, 200.
    c = 2000. * np.ones((n_z, n_x))
    aniso = {k: v * np.ones((n_z, n_x))
             for k, v in (('theta', 0.3), ('eps', 0.2), ('delta', 0.1))}
    q = np.zeros((1, 1, n_z, n_x), np.complex128)
    q[0, 0, 10, 8] = 1.
    R = np.zeros((2, n_z * n_x), np.complex128)
    R[0, 6 * n_x + 14] = R[1, 16 * n_x + 14] = 1.
    cfg = dict(tol=1e-10, mg_min_size=8)
    kw = dict(config=SolverConfig(**cfg), eurus_params=dict(aniso, cPML=1e3),
              device='cpu', nPML=6)
    d = tmf.multifreq_dpred(c, np.ones((n_z, n_x)), [freq], q, R, **kw)
    u = Eurus(dict(aniso, c=c, rho=1., nx=n_x, nz=n_z, freq=freq, nPML=6,
                   cPML=1e3, solverOpts=cfg, device='cpu')) \
        * q[0, 0].reshape(-1, 1)
    assert _rel(d.numpy()[0, 0], R @ u[:, 0]) < TOL
    dobs = 0.5 * d.numpy()
    ct = torch.tensor(c, requires_grad=True)
    f = tmf.fwi_misfit(ct, dobs, np.ones((n_z, n_x)), [freq], q, R, **kw)
    g, = torch.autograd.grad(f, ct)
    assert g.shape == (n_z, n_x) and bool(torch.isfinite(g).all())
    dc = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (n_z, n_x)))
    with fwAD.dual_level():
        f_fw = tmf.fwi_misfit(fwAD.make_dual(torch.tensor(c), dc), dobs,
                              np.ones((n_z, n_x)), [freq], q, R, **kw)
        df = float(fwAD.unpack_dual(f_fw).tangent)
    assert abs(float(torch.sum(g * dc)) - df) / abs(df) < TOL


def test_entry_points_refuse_the_cpu_by_default(monkeypatch):
    '''
    Without a card, an entry point called without ``device`` raises
    RuntimeError (nothing falls back to the CPU).
    '''
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    c, _, rho, q, R, dobs = _inputs()
    calls = [
        lambda: tmf.build_multifreq_ops(c, rho, FREQS),
        lambda: tmf.multifreq_dpred(c, rho, FREQS, q, R),
        lambda: tmf.fwi_misfit(c, dobs, rho, FREQS, q, R),
        lambda: tmf.multifreq_dpred_chunked(c, rho, FREQS, q, R),
        lambda: tmf.multifreq_dpred_25d(c, rho, FREQS, q, R, nky=2),
        lambda: convert.multifreq_ops_from_numpy(_jax_refs()[0]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
