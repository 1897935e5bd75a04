'''
The spatial decomposition on the card: K1 on the halo-grown shards
(``make_sharded_apply``) against the plain sharded apply (the JAX
package's sum over the 9 offsets), on virtual meshes of one card, and a
DD solve at 128^2 against the global solve, complex64. Marked ``cuda``:
without an NVIDIA GPU and nvcc they skip. On a machine with one (where
jax is not installed, add ``--noconftest``):

    python -m pytest tests/test_torch_spatial_cuda.py -q

Tolerances: the apply 1e-6 of the plain result's largest magnitude
(float32 summed in another order); the DD solve's true relres <= 1e-5
and its solution within 1e-4 of the global one; a K1 operand that is
not contiguous is copied and counted.
'''

import numpy as np
import pytest
import torch

from zephyr_tpu_torch.ops import cuda_kernels as ck
from zephyr_tpu_torch.ops.minizephyr_coeff import minizephyr_planes
from zephyr_tpu_torch.parallel import spatial as sp
from zephyr_tpu_torch.parallel.mesh import Mesh, Sharding
from zephyr_tpu_torch.solver.helmholtz import (SolverConfig,
                                               prepare_operator, solve_info,
                                               shifted_velocity)

pytestmark = pytest.mark.cuda
MESHES = {'x4': ((4,), ('x',), None), 'zx22': ((2, 2), ('z', 'x'), 'z')}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels run on the card)')
    return torch.device('cuda', 0)


def _mesh(name, dev):
    shape, names, az = MESHES[name]
    devs = np.empty(int(np.prod(shape)), dtype=object)
    devs[:] = dev
    return Mesh(devs.reshape(shape), names), az


def _planes(n, dev, cfg):
    c = torch.full((n, n), 1500., dtype=torch.complex64, device=dev)
    c[n // 2:] = 2200.
    rho = torch.ones((n, n), dtype=torch.float32, device=dev)
    f = 1500. / 16
    return (minizephyr_planes(c, rho, f)[None, None].contiguous(),
            minizephyr_planes(shifted_velocity(c, cfg.shift), rho, f,
                              pml_cap=cfg.pml_cap)[None, None].contiguous())


@pytest.mark.parametrize('name', list(MESHES))
@pytest.mark.parametrize('n,R', [(128, 3), (96, 1)])
def test_k1_halo_grown_matches_plain(dev, name, n, R):
    mesh, az = _mesh(name, dev)
    planes = _planes(n, dev, SolverConfig())[0]
    gen = torch.Generator(device=dev).manual_seed(n + R)
    u = torch.complex(torch.randn((R, 1, n, n), generator=gen, device=dev),
                      torch.randn((R, 1, n, n), generator=gen, device=dev))
    ck.reset_launches()
    got = sp.make_sharded_apply(mesh, axis_name='x', axis_z=az)(planes, u)
    assert ck.LAUNCHES['apply_stencil'] == 4
    assert ck.COPIES['apply_stencil'] == 0
    ps = Sharding(mesh, (None, None, None, az, 'x'))
    us = Sharding(mesh, (None, None, az, 'x'))
    plain = us.gather(sp.apply_stencil_sharded(ps.split(planes),
                                               us.split(u), mesh,
                                               axis_x='x', axis_z=az))
    scale = float(torch.abs(plain).max())
    assert float(torch.abs(got - plain).max()) <= 1e-6 * scale


def test_k1_copies_non_contiguous(dev):
    planes = _planes(64, dev, SolverConfig())[0][0, 0]
    u = torch.randn((2, 64, 64), dtype=torch.complex64, device=dev)
    ck.reset_launches()
    out = ck.apply_stencil(planes, u.transpose(-1, -2))
    assert ck.COPIES['apply_stencil'] == 1
    ref = ck.apply_stencil(planes, u.transpose(-1, -2).contiguous())
    assert torch.equal(out, ref)


def test_dd_solve_matches_global(dev):
    n = 128
    cfg = SolverConfig(tol=1e-5, maxiter=600, mg_coarse='inv',
                       mg_min_size=16, fft_mode='strat', fft_scale=2,
                       hybrid_comp='fused', mg_nu1=2, mg_nu2=1)
    P0, PP = _planes(n, dev, cfg)
    b = torch.zeros((2, 1, n, n), dtype=torch.complex64, device=dev)
    b[0, 0, n // 2, n // 3] = 1.0
    b[1, 0, n // 4, n // 2] = 1.0
    op = prepare_operator(P0, PP, cfg, with_transpose=False)
    x_ref = solve_info(op, b, cfg)[0]
    mesh, az = _mesh('zx22', dev)
    x, iters, relres = sp.make_dd_solver(mesh, cfg, axis_name='x',
                                         axis_z=az, overlap=8)(P0, PP, b)
    assert relres <= 1e-5
    rel = float(torch.linalg.vector_norm(x - x_ref)
                / torch.linalg.vector_norm(x_ref))
    assert rel <= 1e-4, (rel, iters)
