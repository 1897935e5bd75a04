'''
The backward of a block (TTI) solve on the card: the gradient of a
receiver misfit w.r.t. c through ``solve_batched`` on a 128^2 Eurus
operator in complex64 (the bench's TTI solver options at mg_min_size 16,
so three levels), with the kernels (K8 for every operator and residual
apply on A, A^T and the line-smoothed levels, K7 for the transfers)
against the same backward with the plain torch twins in their place,
within 1e-5 relative (2-norm). Marked ``cuda``: without an NVIDIA GPU and
nvcc it skips. On a machine with one (where jax is not installed, add
``--noconftest``):

    python -m pytest tests/test_torch_tti_gradient_cuda.py -q
'''

import numpy as np
import pytest
import torch

from zephyr_tpu_torch.ops import cuda_kernels as ck
from zephyr_tpu_torch.ops import stencil
from zephyr_tpu_torch.ops.eurus_coeff import eurus_planes
from zephyr_tpu_torch.solver import multigrid
from zephyr_tpu_torch.solver.helmholtz import (SolverConfig,
                                               prepare_operator,
                                               shifted_velocity,
                                               solve_batched)

pytestmark = pytest.mark.cuda
TTI_OPTS = dict(tol=1e-5, maxiter=2000, mg_coarse='inv', mg_min_size=16,
                fft_mode='strat', fft_scale=2, hybrid_comp='fused',
                mg_nu1=1, mg_nu2=1, gmres_restart=20)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the backward runs on the card)')
    return 'cuda'


def _gradient(dev, n=128):
    cfg = SolverConfig(**TTI_OPTS)
    c = torch.full((n, n), 1500., device=dev)
    c[n // 2:] = 1800.
    c.requires_grad_(True)
    rho = torch.ones((n, n), device=dev)
    aniso = {k: torch.full((n, n), v, device=dev)
             for k, v in (('theta', 0.3), ('eps', 0.2), ('delta', 0.1))}
    cc = c.to(torch.complex64)
    planes = eurus_planes(cc, rho, 1500. / 16, **aniso)
    pplanes = eurus_planes(shifted_velocity(cc.detach(), cfg.shift), rho,
                           1500. / 16, pml_cap=cfg.pml_cap, **aniso)
    op = prepare_operator(planes.detach(), pplanes, cfg)
    b = torch.zeros((4, 2, n, n), dtype=torch.complex64, device=dev)
    for i, (z, x) in enumerate(((30, 30), (40, 90), (90, 60), (100, 20))):
        b[i, 0, z, x] = 1.
    x = solve_batched(op, b, cfg, planes=planes)
    d = x[:, 0, 16, 16:112:8]
    loss = 0.5 * torch.sum(torch.abs(d - 1e-3) ** 2)
    g, = torch.autograd.grad(loss, c)
    return g


def test_block_backward_kernels_match_twins(dev, monkeypatch):
    ck.reset_launches()
    g = _gradient(dev)
    assert ck.LAUNCHES['apply_block_stencil'] > 0
    assert ck.LAUNCHES['restrict'] > 0 and ck.LAUNCHES['prolong'] > 0
    assert bool(torch.isfinite(g).all()) and float(torch.norm(g)) > 0
    monkeypatch.setattr(ck, 'apply_block_stencil',
                        stencil.apply_block_stencil)
    monkeypatch.setattr(ck, 'restrict', multigrid._restrict_ref)
    monkeypatch.setattr(ck, 'prolong', multigrid._prolong_ref)
    ck.reset_launches()
    g_twin = _gradient(dev)
    assert ck.LAUNCHES['apply_block_stencil'] == 0
    assert float(torch.norm(g - g_twin) / torch.norm(g_twin)) <= 1e-5
