'''
The spatial domain decomposition of the port
(zephyr_tpu_torch.parallel.spatial) against the JAX package's
(zephyr_tpu.parallel.spatial), the mirror of tests/test_spatial.py: the
JAX package on the 8 virtual CPU devices of tests/conftest.py, the port
on virtual meshes of the CPU (``['cpu'] * 4``), both in complex128 on the
same numpy inputs.

Tolerances: the sharded apply 1e-12 absolute (unit-scale fields); the
halo exchange and overlap exact; one application of the shard-local
hybrid preconditioner (overlap 8, mirror fill, closure mask) 1e-10
relative; the DD solve (2x2 tiles, overlap 8) 1e-6 relative between
the packages and 1e-5 from the global solve, iterations within 2 (port
107 on one torch thread, JAX 106); the DD forward 1e-6 relative between
the packages and 1e-5 from the single-device ``multifreq_dpred``,
iterations within 10% (4 x slabs, overlap 0: port 469 and 242 on one
thread, 451 and 244 on eight, JAX 443 and 248). The counts follow
rounding: at tol 1e-8 on these grids the trajectories part at the last
bit (torch's thread count alone moves them, at overlap 4 by 24 of
219), while the solutions agree to 1e-8.
'''

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh as JMesh, PartitionSpec as P

from zephyr_tpu.ops.minizephyr_coeff import minizephyr_planes as j_planes
from zephyr_tpu.parallel import spatial as jsp
from zephyr_tpu.solver.helmholtz import (SolverConfig as JConfig,
                                         shifted_velocity as j_shift)

from zephyr_tpu_torch.ops.minizephyr_coeff import minizephyr_planes
from zephyr_tpu_torch.ops.stencil import apply_block_stencil
from zephyr_tpu_torch.parallel import spatial as sp
from zephyr_tpu_torch.parallel.mesh import Mesh, Sharding
from zephyr_tpu_torch.parallel.multifreq import multifreq_dpred
from zephyr_tpu_torch.solver.helmholtz import (SolverConfig,
                                               prepare_operator, solve_info,
                                               shifted_velocity)

NZ, NX = 64, 128
FREQ = 100.
CFG = dict(tol=1e-8, maxiter=600, mg_coarse='inv', mg_min_size=16)
#: mesh name -> (shape, axis names, make_* keywords)
MESHES = {'x4': ((4,), ('x',), dict(axis_name='x')),
          'zx22': ((2, 2), ('z', 'x'), dict(axis_name='x', axis_z='z'))}


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    '''
    One torch thread for this file: its small shapes gain nothing from
    more (the 200x100 demo: 17.2 s on one thread, 17.6 s on eight), and
    beside the suite's other workers more threads than cores slowed it
    up to 50x.
    '''
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jmesh(name):
    shape, names, _ = MESHES[name]
    n = int(np.prod(shape))
    if jax.device_count() < n:
        pytest.skip('needs %d JAX devices' % n)
    return JMesh(np.array(jax.devices()[:n]).reshape(shape), names)


def _mesh(name):
    shape, names, _ = MESHES[name]
    devs = np.empty(shape, dtype=object)
    devs[...] = 'cpu'
    return Mesh(devs, names)


@pytest.fixture(scope='module')
def planes():
    'The JAX test operator (hom 2000 m/s, 100 Hz, nPML 6) as numpy.'
    c = 2000. * jnp.ones((NZ, NX), dtype=jnp.complex128)
    rho = jnp.ones((NZ, NX))
    jc = JConfig(**CFG)
    P0 = j_planes(c, rho, FREQ, nPML=6)[None, None]
    PP = j_planes(j_shift(c, jc.shift), rho, FREQ, nPML=6,
                  pml_cap=jc.pml_cap)[None, None]
    return np.array(P0), np.array(PP)


def _field(seed, *shape):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def test_port_planes_equal_jax(planes):
    'The port builds the same planes (its DD forward builds its own).'
    c = torch.full((NZ, NX), 2000., dtype=torch.complex128)
    rho = torch.ones((NZ, NX), dtype=torch.float64)
    p = minizephyr_planes(c, rho, FREQ, nPML=6)[None, None].numpy()
    assert np.allclose(p, planes[0], rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize('name', list(MESHES))
def test_sharded_apply_matches_jax(planes, name):
    u = _field(0, 1, NZ, NX)
    kw = MESHES[name][2]
    ref = np.asarray(jsp.make_sharded_apply(_jmesh(name), **kw)(
        jnp.asarray(planes[0]), jnp.asarray(u)))
    out = sp.make_sharded_apply(_mesh(name), **kw)(planes[0], u).numpy()
    assert np.abs(out - ref).max() <= 1e-12
    glob = apply_block_stencil(torch.as_tensor(planes[0]),
                               torch.as_tensor(u)).numpy()
    assert np.abs(out - glob).max() <= 1e-12


@pytest.mark.parametrize('name', list(MESHES))
def test_apply_stencil_sharded_batched(planes, name):
    'The plain sharded apply on a (R, B, nz, nx) batch, shard by shard.'
    mesh, kw = _mesh(name), MESHES[name][2]
    u = _field(1, 3, 1, NZ, NX)
    ps = Sharding(mesh, (None, None, None, kw.get('axis_z'), 'x'))
    us = Sharding(mesh, (None, None, kw.get('axis_z'), 'x'))
    out = us.gather(sp.apply_stencil_sharded(ps.split(planes[0]),
                                             us.split(u), mesh, **kw))
    ref = apply_block_stencil(torch.as_tensor(planes[0]), torch.as_tensor(u))
    assert float(torch.abs(out - ref).max()) <= 1e-12


def _j_extend(jmesh, kw, a, width, edge):
    'JAX _extend_overlap in shard_map: the grown blocks side by side.'
    spec = P(*((None,) * (a.ndim - 2) + (kw.get('axis_z'), 'x')))
    f = jax.jit(shard_map(lambda x: jsp._extend_overlap(
        x, kw.get('axis_z'), 'x', width, edge),
        mesh=jmesh, in_specs=(spec,), out_specs=spec))
    return np.asarray(f(jnp.asarray(a)))


@pytest.mark.parametrize('edge', ['zero', 'mirror'])
@pytest.mark.parametrize('name', list(MESHES))
def test_extend_overlap_matches_jax(planes, name, edge):
    'Halos of width 8: neighbour strips, zero or mirror fill at the edges.'
    mesh, kw = _mesh(name), MESHES[name][2]
    for a in (_field(2, 2, 1, NZ, NX), planes[1]):
        s = Sharding(mesh, (None,) * (a.ndim - 2) + (kw.get('axis_z'), 'x'))
        out = s.gather(sp._extend_overlap(s.split(a), mesh, kw.get('axis_z'),
                                          'x', 8, edge)).numpy()
        ref = _j_extend(_jmesh(name), kw, a, 8, edge)
        assert out.shape == ref.shape
        assert np.array_equal(out, ref)


def test_closure_mask():
    '''
    The closure rows of an overlapped slab: the mirror band and the global
    ring row at the global edges only (zephyr_tpu/parallel/spatial.py:
    302-316).
    '''
    n_ext, ov = 20, 4
    for i, n, lo, hi in ((0, 3, True, False), (1, 3, False, False),
                         (2, 3, False, True), (0, 1, True, True)):
        m = sp._closure_mask_1d(n_ext, i, n, ov, torch.float64, 'cpu')
        want = np.ones(n_ext)
        if lo:
            want[:ov + 1] = 0
        if hi:
            want[n_ext - 1 - ov:] = 0
        assert np.array_equal(m.numpy(), want)


@pytest.mark.parametrize('name', list(MESHES))
def test_local_hybrid_precond_matches_jax(planes, name):
    '''
    One application of the shard-local hybrid preconditioner with RAS
    overlap 8 (engaged: shards of 32 x 64 >= 4 x 8 on 2x2 tiles), so the
    mirror-filled coefficient halos and the closure mask reach
    prepare_operator, against the JAX package's in shard_map.
    '''
    mesh, kw = _mesh(name), MESHES[name][2]
    az = kw.get('axis_z')
    r = _field(3, 1, NZ, NX)
    jc = JConfig(**CFG)
    pspec, uspec = P(None, None, None, az, 'x'), P(None, az, 'x')

    def local(pl, ppl, rl):
        M = jsp._local_hybrid_precond(pl, ppl, jc, axis_x='x', axis_z=az,
                                      overlap=8)
        return M(rl)

    ref = np.asarray(jax.jit(shard_map(local, mesh=_jmesh(name),
                                       in_specs=(pspec, pspec, uspec),
                                       out_specs=uspec))(
        jnp.asarray(planes[0]), jnp.asarray(planes[1]), jnp.asarray(r)))
    ps = Sharding(mesh, (None, None, None, az, 'x'))
    rs = Sharding(mesh, (None, None, az, 'x'))
    M = sp._local_hybrid_precond(ps.split(planes[0]), ps.split(planes[1]),
                                 SolverConfig(**CFG), mesh, axis_x='x',
                                 axis_z=az, overlap=8)
    out = rs.gather(M(rs.split(r[None])))[0].numpy()
    assert np.linalg.norm(out - ref) <= 1e-10 * np.linalg.norm(ref)


def _sources():
    q = np.zeros((2, 1, NZ, NX), dtype=np.complex128)
    q[0, 0, NZ // 2, NX // 2] = 1.0
    q[1, 0, NZ // 3, 2 * NX // 3] = 1.0 - 0.5j
    return q


@pytest.fixture(scope='module')
def jax_dd_solve(planes):
    'JAX make_dd_solver on 2x2 tiles, overlap 8, batched RHS (one run).'
    x, it, rr = jsp.make_dd_solver(_jmesh('zx22'), JConfig(**CFG),
                                   axis_name='x', axis_z='z', overlap=8)(
        jnp.asarray(planes[0]), jnp.asarray(planes[1]),
        jnp.asarray(_sources()))
    return np.asarray(x), int(it), float(rr)


def test_dd_solve_2d_tiles_batched_rhs(planes, jax_dd_solve):
    '''
    DD over (z, x) tiles with a batched RHS: the JAX package and global;
    overlap 8 (32 x 64 shards: RAS with the closure mask engaged).
    '''
    q = _sources()
    cfg = SolverConfig(**CFG)
    x, iters, relres = sp.make_dd_solver(_mesh('zx22'), cfg, axis_name='x',
                                         axis_z='z', overlap=8)(
        planes[0], planes[1], q)
    x = x.numpy()
    assert relres < 1e-7
    xj, it_j, rr_j = jax_dd_solve
    assert abs(iters - it_j) <= 2, (iters, it_j)
    assert np.linalg.norm(x - xj) <= 1e-6 * np.linalg.norm(xj)
    op = prepare_operator(torch.as_tensor(planes[0]),
                          torch.as_tensor(planes[1]), cfg,
                          with_transpose=False)
    for r in range(2):
        x_ref = solve_info(op, torch.as_tensor(q[r:r + 1]), cfg)[0][0]
        x_ref = x_ref.numpy()
        assert np.linalg.norm(x[r] - x_ref) <= 1e-5 * np.linalg.norm(x_ref)


def test_dd_solve_restarts_on_true_residual():
    '''
    In complex64 the sharded BiCGStab's recursive residual drifts from
    the true one: on 128^2 layered (the bench's 4 layers, 93.75 Hz), 2
    point sources, the production config, 2x2 tiles, overlap 16, the
    JAX package's single run (``restarts=0``) stops at a recursive
    relres <= 1e-5 whose true relres is above it (sources where the bench
    draws them; on one thread 45 iterations, 9.74e-6 and 1.16e-5).
    ``DDOperator.solve`` restarts on the true residual and ends at or
    below 1e-5 (49 iterations, 5.97e-6), within 1e-4 of the global
    solve.
    '''
    n = 128
    c = np.zeros((n, n), np.float32)
    for i, v in enumerate([1500., 2000., 2500., 3000.]):
        c[i * n // 4:(i + 1) * n // 4] = v
    cfg = SolverConfig(tol=1e-5, maxiter=2000, mg_coarse='inv',
                       mg_min_size=32, fft_mode='strat', fft_scale=2,
                       hybrid_comp='fused', mg_nu1=2, mg_nu2=1)
    ct = torch.as_tensor(c).to(torch.complex64)
    rho = torch.ones((n, n))
    freq = 1500.0 / 16
    P0 = minizephyr_planes(ct, rho, freq)[None, None]
    PP = minizephyr_planes(shifted_velocity(ct, cfg.shift), rho, freq,
                           pml_cap=cfg.pml_cap)[None, None]
    pos = np.random.default_rng(0).integers(n // 8, 7 * n // 8, (2, 2))
    b = torch.zeros((2, 1, n, n), dtype=torch.complex64)
    b[[0, 1], 0, pos[:, 0], pos[:, 1]] = 1.0
    mesh = _mesh('zx22')
    ps = sp._grid_sharding(mesh, 5, 'x', 'z')
    bs = sp._grid_sharding(mesh, 4, 'x', 'z')
    op = sp.DDOperator(ps.split(P0), ps.split(PP), cfg, mesh, 'x', 'z', 16)
    bsh = bs.split(b)
    _, it_rec, rec = sp.sharded_bicgstab(op.apply, bsh, op.M, mesh,
                                         tol=cfg.tol, maxiter=cfg.maxiter)
    _, it1, rr1 = op.solve(bsh, restarts=0)
    assert it1 == it_rec and rec <= cfg.tol < rr1, (it1, it_rec, rec, rr1)
    x, iters, relres = op.solve(bsh)
    assert iters > it1 and relres <= cfg.tol, (it1, iters, relres)
    x = bs.gather(x)
    r = b - apply_block_stencil(P0, x)
    assert float(torch.linalg.vector_norm(r[1]) /
                 torch.linalg.vector_norm(b[1])) <= cfg.tol
    op_g = prepare_operator(P0, PP, cfg, with_transpose=False)
    x_ref = solve_info(op_g, b, cfg)[0]
    assert (torch.linalg.vector_norm(x - x_ref)
            <= 1e-4 * torch.linalg.vector_norm(x_ref))


def _dpred_inputs():
    'tests/test_spatial.py:122-154: layered 64x128, 2 freqs x 2 src x 3 rec.'
    freqs = np.array([80., 110.])
    c = 2000. * np.ones((NZ, NX))
    c[NZ // 2:] = 2600.
    rho = np.ones((NZ, NX))
    q = np.zeros((2, 2, NZ, NX), np.complex128)
    q[:, 0, 16, 20] = 1.0
    q[:, 1, 40, 90] = 1.0
    Rg = np.zeros((3, NZ, NX), np.complex128)
    Rg[0, 10, 40] = 1.0
    Rg[1, 30, 64] = 1.0
    Rg[2, 50, 100] = 1.0
    return freqs, c, rho, q, Rg


def test_dd_dpred_matches_jax():
    'The DD forward on 4 x slabs: the JAX package and multifreq_dpred.'
    freqs, c, rho, q, Rg = _dpred_inputs()
    d_j, info_j = jsp.make_dd_dpred(_jmesh('x4'), freqs, JConfig(**CFG),
                                    nPML=6)(
        jnp.asarray(c + 0j), jnp.asarray(rho), jnp.asarray(q),
        jnp.asarray(Rg))
    d_j = np.asarray(d_j)
    cfg = SolverConfig(**CFG)
    d, info = sp.make_dd_dpred(_mesh('x4'), freqs, cfg, nPML=6)(
        c + 0j, rho, q, Rg)
    d = d.numpy()
    for (it, rr), (it_j, _) in zip(info, info_j):
        assert rr < 1e-7
        assert abs(it - it_j) <= 0.1 * it_j, (info, info_j)
    assert np.linalg.norm(d - d_j) <= 1e-6 * np.linalg.norm(d_j)
    with torch.no_grad():
        d_ref = multifreq_dpred(c + 0j, rho, freqs, q,
                                Rg.reshape(3, NZ * NX), config=cfg, nPML=6,
                                device='cpu').numpy()
    assert np.linalg.norm(d - d_ref) <= 1e-5 * np.linalg.norm(d_ref)


def _layered(n):
    cl = np.zeros((n, n))
    for i, v in enumerate([1500., 2000., 2500., 3000.]):
        cl[i * n // 4:(i + 1) * n // 4] = v
    return cl


def _layered_planes(n, cfg, **kw):
    c = torch.as_tensor(_layered(n)).to(torch.complex128)
    rho = torch.ones((n, n), dtype=torch.float64)
    freq = 1500.0 / 16.0
    return (minizephyr_planes(c, rho, freq, **kw)[None, None],
            minizephyr_planes(shifted_velocity(c, cfg.shift), rho, freq,
                              pml_cap=cfg.pml_cap, **kw)[None, None])


@pytest.mark.slow
def test_dd_solve_matches_global(planes):
    'tests/test_spatial.py:77-97: 4 x slabs, one (B, nz, nx) RHS.'
    cfg = SolverConfig(**CFG)
    q = np.zeros((1, NZ, NX), dtype=np.complex128)
    q[0, NZ // 2, NX // 2] = 1.0
    x, iters, relres = sp.make_dd_solver(_mesh('x4'), cfg)(planes[0],
                                                           planes[1], q)
    assert relres < 1e-7
    op = prepare_operator(torch.as_tensor(planes[0]),
                          torch.as_tensor(planes[1]), cfg,
                          with_transpose=False)
    x_ref, it_ref, _ = solve_info(op, torch.as_tensor(q[None]), cfg)
    rel = torch.linalg.norm((x - x_ref[0]).flatten()) \
        / torch.linalg.norm(x_ref.flatten())
    assert float(rel) < 1e-5
    assert iters < 4 * max(int(it_ref[0]), 1)


@pytest.mark.slow
def test_dd_iteration_inflation_at_scale():
    '''
    tests/test_spatial.py:157-196: 512^2 layered on a 2x2 mesh (256^2
    shards, overlap 16 engaged) within 2x the global solve's iterations
    and within 1e-4 of its solution.
    '''
    n = 512
    cfg = SolverConfig(tol=1e-5, maxiter=1200, mg_coarse='inv',
                       mg_min_size=32, fft_mode='strat', fft_scale=2)
    P0, PP = _layered_planes(n, cfg)
    q = torch.zeros((1, 1, n, n), dtype=torch.complex128)
    q[0, 0, n // 2, n // 2] = 1.0
    op = prepare_operator(P0, PP, cfg, with_transpose=False)
    x_ref, it_ref, _ = solve_info(op, q, cfg)
    x, iters, relres = sp.make_dd_solver(_mesh('zx22'), cfg, axis_name='x',
                                         axis_z='z', overlap=16)(P0, PP, q)
    assert relres < 1e-5
    rel = float(torch.linalg.norm((x - x_ref).flatten())
                / torch.linalg.norm(x_ref.flatten()))
    assert rel < 1e-4, rel
    assert iters <= 2 * int(it_ref[0]), (iters, int(it_ref[0]))


@pytest.mark.slow
def test_dd_ras_overlap_reduces_iterations():
    '''
    tests/test_spatial.py:199-239: at 192^2 layered on 2x2 tiles (96^2
    shards) overlap 8 must match the global solve and take fewer outer
    iterations than overlap 0.
    '''
    n = 192
    cfg = SolverConfig(tol=1e-6, maxiter=600, mg_coarse='inv',
                       mg_min_size=16)
    P0, PP = _layered_planes(n, cfg, nPML=8)
    q = torch.zeros((1, 1, n, n), dtype=torch.complex128)
    q[0, 0, n // 2, n // 2] = 1.0
    mesh = _mesh('zx22')
    _, it0, _ = sp.make_dd_solver(mesh, cfg, axis_name='x', axis_z='z',
                                  overlap=0)(P0, PP, q)
    x8, it8, rr8 = sp.make_dd_solver(mesh, cfg, axis_name='x', axis_z='z',
                                     overlap=8)(P0, PP, q)
    assert rr8 < 1e-6
    assert it8 < it0, (it8, it0)
    op = prepare_operator(P0, PP, cfg, with_transpose=False)
    x_ref = solve_info(op, q, cfg)[0]
    rel = float(torch.linalg.norm((x8 - x_ref).flatten())
                / torch.linalg.norm(x_ref.flatten()))
    assert rel < 1e-5
