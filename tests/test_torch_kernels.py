'''
The CUDA kernels K1-K5 and K7 against their torch twins, on the card,
complex64, at small and odd shapes (chip_smoke.py runs the same checks
at the main path's shapes). Marked ``cuda``: without an NVIDIA GPU and
nvcc they skip. On a machine with one (where jax is not installed, add
``--noconftest``):

    python -m pytest tests/test_torch_kernels.py -q

Tolerance: 1e-5 relative to the twin's largest magnitude (float32, and
the kernels sum in another order, with FMA contraction).
'''

import pytest
import torch

from zephyr_tpu_torch.ops import cuda_kernels as ck
from zephyr_tpu_torch.ops import stencil
from zephyr_tpu_torch.solver import multigrid, stratified

pytestmark = pytest.mark.cuda
TOL = 1e-5
SHAPES = [(37, 53, 3), (64, 48, 2), (25, 50, 1), (3, 3, 1)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (kernel tests run on the card)')
    return torch.device('cuda')


def _rand(gen, dev, *shape):
    return torch.complex(torch.randn(shape, generator=gen),
                         torch.randn(shape, generator=gen)).to(dev)


def _operands(dev, nz, nx, R):
    gen = torch.Generator().manual_seed(nz * 1000 + nx)
    planes = _rand(gen, dev, 9, nz, nx)
    planes[4] += 8.0
    D = (0.5 / planes[4]).contiguous()
    mask = torch.ones((nz, nx), device=dev)
    mask[0] = mask[-1] = 0
    mask[:, 0] = mask[:, -1] = 0
    return (planes.contiguous(), D, mask, _rand(gen, dev, R, nz, nx),
            _rand(gen, dev, R, nz, nx),
            _rand(gen, dev, R, (nz + 1) // 2, (nx + 1) // 2))


def _close(out, ref):
    scale = float(torch.max(torch.abs(ref)))
    return float(torch.max(torch.abs(out - ref))) <= TOL * scale


@pytest.mark.parametrize('nz,nx,R', SHAPES)
def test_k1_k2_k4_match_twins(dev, nz, nx, R):
    planes, D, mask, b, u, ec = _operands(dev, nz, nx, R)
    assert _close(ck.apply_stencil(planes, u),
                  stencil.apply_stencil(planes, u))
    for ns, ref in ((1, stencil._ps1rr_ref), (2, stencil._ps2rr_ref)):
        u_k, rc_k = ck.presmooth_restrict(planes, D, mask, b, ns)
        u_r, rc_r = ref(planes, D, mask, b)
        assert _close(u_k, u_r) and _close(rc_k, rc_r)
    assert _close(ck.prolong_add_smooth(planes, D, mask, b, u, ec),
                  stencil._pas_ref(planes, D, mask, b, u, ec))


@pytest.mark.parametrize('nz,nx,R', SHAPES)
def test_k5_matches_twin(dev, nz, nx, R):
    planes, D, _, b, u, _ = _operands(dev, nz, nx, R)
    assert _close(ck.jacobi_sweep(planes, D, b, u),
                  stencil._jacobi_ref(planes, D, b, u))


@pytest.mark.parametrize('nz,nx,R', SHAPES + [(2, 7, 2), (1, 1, 1)])
def test_k7_matches_twins(dev, nz, nx, R):
    _, _, _, b, _, ec = _operands(dev, nz, nx, R)
    assert _close(ck.restrict(b), multigrid._restrict_ref(b))
    assert _close(ck.prolong(ec, nz, nx),
                  multigrid._prolong_ref(ec, nz, nx))
    # a crop of the interleaved grid below (2 nzc - 1, 2 nxc - 1)
    assert _close(ck.prolong(ec, max(1, nz - 2), nx),
                  multigrid._prolong_ref(ec, max(1, nz - 2), nx))


def test_transfer_dispatch_reshapes_leading_axes(dev):
    _, _, _, b, _, ec = _operands(dev, 12, 9, 3)
    v = b.reshape(3, 1, 12, 9)
    assert _close(multigrid.restrict(v),
                  multigrid._restrict_ref(v))
    vc = ec.reshape(3, 1, 6, 5)
    assert _close(multigrid.prolong(vc, 12, 9),
                  multigrid._prolong_ref(vc, 12, 9))
    with pytest.raises(ValueError):
        ck.prolong(ec, 13, 9)


@pytest.mark.parametrize('nz,nx,R', [(37, 29, 2), (64, 40, 3), (3, 5, 1)])
def test_k3_matches_twin(dev, nz, nx, R):
    gen = torch.Generator().manual_seed(nz)
    l, d, u = (_rand(gen, dev, nz, nx) for _ in range(3))
    pcr = stratified.pcr_precompute(l, d + 4.0, u)
    b = _rand(gen, dev, R, nz, nx)
    args = (pcr.alphas, pcr.gammas, pcr.dinv, b)
    assert _close(ck.pcr_sweep(*args),
                  stratified._pcr_sweep_bf16_ref(*args))


def test_wrappers_count_and_validate(dev):
    planes, D, mask, b, u, ec = _operands(dev, 16, 16, 2)
    n = ck.LAUNCHES['apply_stencil']
    ck.apply_stencil(planes, u)
    assert ck.LAUNCHES['apply_stencil'] == n + 1
    with pytest.raises(TypeError):
        ck.apply_stencil(planes, u.to(torch.complex128))
    with pytest.raises(ValueError):
        ck.apply_stencil(planes, u.transpose(1, 2))
