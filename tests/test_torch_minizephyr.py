'''
The port's forward-modelling API against the JAX package and the oracle:

- ``MiniZephyr(config) * q`` of zephyr_tpu_torch against zephyr_tpu's,
  both with the production solverOpts and tol 1e-9, complex128, rel 1e-6;
- the analytical-oracle flow of the verify recipe (c 2500, 200x100,
  freq 200, Kaiser source at (25, 25), window [40:180, 40:80]) in the
  port, error < 1e-2;
- sources, Kaiser injection/extraction, special functions and the
  analytical Green's function against the JAX package (rel 1e-12);
- importing the port loads no jax; CPU tensors run the torch twins and a
  request for a CUDA kernel without a usable card raises.
'''

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import zephyr_tpu.backend as jb
from zephyr_tpu.ops import kaiser as jk
from zephyr_tpu.ops import special as jsp
import zephyr_tpu_torch.backend as tb
from zephyr_tpu_torch.ops import cuda_kernels
from zephyr_tpu_torch.ops import kaiser as tk
from zephyr_tpu_torch.ops import special as tsp
from zephyr_tpu_torch.ops import stencil as tst

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRODUCTION = dict(tol=1e-5, maxiter=2000, mg_coarse='inv', mg_min_size=32,
                  fft_mode='strat', fft_scale=2, hybrid_comp='fused',
                  mg_nu1=2, mg_nu2=1)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel())


def _small_config(layered):
    nz, nx = 48, 40
    c = np.full((nz, nx), 2500.)
    if layered:
        c[nz // 2:] = 3200.
    return {'c': c, 'rho': 1., 'nx': nx, 'nz': nz, 'freq': 150.,
            'device': 'cpu', 'solverOpts': dict(PRODUCTION, tol=1e-9, mg_min_size=10)}


@pytest.mark.parametrize('cls', ['MiniZephyr', 'MiniZephyrHD'])
@pytest.mark.parametrize('layered', [False, True])
def test_minizephyr_mul_matches_jax(cls, layered):
    config = _small_config(layered)
    locs = np.array([[20., 16.], [11.3, 30.7]])
    q_t = tb.SparseKaiserSource(config)(locs)
    q_j = jb.SparseKaiserSource(config)(locs)
    assert abs(q_t - q_j).max() == 0
    u_t = getattr(tb, cls)(config) * q_t
    u_j = getattr(jb, cls)(config) * q_j
    assert u_t.shape == u_j.shape == (48 * 40, 2)
    assert _rel(u_t, u_j) < 1e-6


def test_oracle_flow():
    'The verify recipe, in the port, with the production solver options.'
    config = {'c': 2500., 'rho': 1., 'nx': 100, 'nz': 200, 'freq': 200.,
              'device': 'cpu', 'solverOpts': PRODUCTION}
    loc = np.array([[25., 25.]])
    u = tb.MiniZephyr(config) * tb.SparseKaiserSource(config)(loc)
    uAH = tb.AnalyticalHelmholtz(config)(loc)
    seg = (slice(40, 180), slice(40, 80))
    uM, uA = u.ravel().reshape(200, 100)[seg], uAH.reshape(200, 100)[seg]
    rel = (uA - uM) / abs(uA)
    err = np.sqrt((rel.conj() * rel).sum()).real / rel.size
    assert err < 1e-2


def test_factors_lifecycle_and_config():
    config = _small_config(False)
    mz = tb.MiniZephyr(config)
    assert not mz.factors
    assert mz.dtype == torch.complex128 and mz.device.type == 'cpu'
    assert mz.A.shape == (1, 1, 9, 48, 40)
    op = mz.Ainv
    assert mz.factors and mz.Ainv is op
    del mz.factors
    assert not mz.factors
    assert tb.MiniZephyr(dict(config, dtype='complex64')).solverConfig \
        .tol == 1e-9
    assert tb.MiniZephyr({'c': 2500., 'nx': 8, 'nz': 8, 'freq': 1.,
                          'dtype': 'complex64'}).solverConfig.tol == 1e-5
    with pytest.raises(ValueError, match='freq'):
        tb.MiniZephyr({'c': 2500., 'nx': 8, 'nz': 8})
    # the default SolverConfig ('mult', full-resolution stratified solve,
    # LU coarse solve) prepares a forward-only operator
    op = tb.MiniZephyr({'c': 2500., 'nx': 40, 'nz': 48, 'freq': 150.,
                        'device': 'cpu'}).Ainv
    assert op.strat.ldu.shape[-2:] == (48, 40) and op.cplanes is None
    assert op.hier.coarse_lu is not None and op.hierT is None


def test_complex64_cpu_solve_close_to_complex128():
    config = _small_config(True)
    config['solverOpts'] = dict(config['solverOpts'], tol=1e-5)
    q = tb.SparseKaiserSource(config)(np.array([[20., 16.]]))
    u64 = tb.MiniZephyr(dict(config, dtype='complex64')) * q
    u128 = tb.MiniZephyr(config) * q
    # both stop at relres <= 1e-5; the gap is bounded by the condition
    assert _rel(u64, u128) < 1e-3


def test_sources_and_kaiser_parity():
    config = {'nx': 30, 'nz': 25, 'dx': 1.5, 'dz': 1.5,
              'freeSurf': (True, False, False, True)}
    locs = np.array([[3.2, 2.1], [20.0, 30.4], [40.1, 17.7]])
    st, sj = tb.SparseKaiserSource(config), jb.SparseKaiserSource(config)
    for a_t, a_j in zip(st.stamps(locs), sj.stamps(locs)):
        assert np.array_equal(a_t, a_j)
    assert np.array_equal(tb.SimpleSource(config)(locs),
                          jb.SimpleSource(config)(locs))
    assert np.array_equal(tb.StackedSimpleSource(config)(locs),
                          jb.StackedSimpleSource(config)(locs))
    cols, vals = tk.pad_stamps(*st.stamps(locs), n=3)
    cj, vj = jk.pad_stamps(*sj.stamps(locs), n=3)
    assert np.array_equal(cols, cj) and np.array_equal(vals, vj)
    f_t = tk.inject(torch.from_numpy(cols), torch.from_numpy(vals), 25, 30)
    f_j = jk.inject(jnp.asarray(cj), jnp.asarray(vj), 25, 30)
    assert _rel(f_t, f_j) < 1e-12
    u = np.random.default_rng(0).standard_normal((2, 25, 30)) + 0j
    d_t = tk.extract(torch.from_numpy(u), torch.from_numpy(cols),
                     torch.from_numpy(vals))
    d_j = jk.extract(jnp.asarray(u), jnp.asarray(cj), jnp.asarray(vj))
    assert d_t.shape == (2, 3) and _rel(d_t, d_j) < 1e-12


def test_special_functions_parity():
    x = np.concatenate([np.linspace(0., 30., 601), [1e-6, 7.999, 8.0]])
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    assert np.max(np.abs(tsp.bessel_j0(xt).numpy()
                         - np.asarray(jsp.bessel_j0(xj)))) < 1e-12
    pos = x > 0
    yt = tsp.bessel_y0(xt).numpy()
    yj = np.asarray(jsp.bessel_y0(xj))
    assert np.max(np.abs(yt[pos] - yj[pos])) < 1e-12
    assert np.isneginf(yt[~pos]).all()
    h = tsp.hankel1_0(xt[pos]).numpy()
    assert _rel(h, np.asarray(jsp.hankel1_0(xj[pos]))) < 1e-12


@pytest.mark.parametrize('extra', [{}, {'eps': 0.2, 'theta': 0.3},
                                   {'3D': True}])
def test_analytical_oracle_parity(extra):
    config = dict({'c': 2500., 'rho': 1.2, 'nx': 30, 'nz': 20,
                   'freq': 200.}, **extra)
    loc = np.array([[10.3, 7.5]])
    g_t = tb.AnalyticalHelmholtz(config)(loc)
    g_j = np.asarray(jb.AnalyticalHelmholtz(config)(loc))
    assert _rel(g_t, g_j) < 1e-12


def test_import_loads_no_jax():
    code = ('import sys; import zephyr_tpu_torch, zephyr_tpu_torch.backend, '
            'zephyr_tpu_torch.solver, zephyr_tpu_torch.convert, '
            'zephyr_tpu_torch.parallel, zephyr_tpu_torch.ops.cuda_kernels, '
            'zephyr_tpu_torch.middleware, '
            'zephyr_tpu_torch.backend.distributors; '
            'assert "jax" not in sys.modules; '
            'assert "zephyr_tpu" not in sys.modules; print("ok")')
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'ok'
    # no source of the port, nor chip_smoke.py, names jax or the JAX
    # package in an import
    bad = re.compile(r'^\s*(import|from)\s+(jax\b|zephyr_tpu\b(?!_torch))',
                     re.M)
    pkg = os.path.join(REPO, 'zephyr_tpu_torch')
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
             if f.endswith('.py')] + [os.path.join(REPO, 'chip_smoke.py')]
    assert len(files) > 20
    for path in files:
        with open(path) as fh:
            assert not bad.search(fh.read()), path


def test_entry_points_default_to_the_card():
    '''
    The discretizations, fwi_misfit_grad_chunked and the convert
    functions run on the card unless the caller passes 'cpu'; without a
    card the default raises a RuntimeError naming device='cpu' (no quiet
    CPU fallback).
    '''
    from zephyr_tpu_torch import convert
    from zephyr_tpu_torch.core.device import resolve_device
    from zephyr_tpu_torch.parallel import fwi_misfit_grad_chunked
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default runs there')
    config = _small_config(False)
    del config['device']
    for cls in (tb.MiniZephyr, tb.MiniZephyrHD, tb.Eurus, tb.EurusHD):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(config).device
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tb.MiniZephyr(config) * np.zeros(48 * 40)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.tensor_from_numpy(np.zeros(3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.model_from_numpy(np.ones((2, 2)), np.ones((2, 2)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.operator_from_numpy(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fwi_misfit_grad_chunked(np.full((8, 8), 2000.), np.ones((8, 8)),
                                np.array([10.]), None, None,
                                np.zeros((1, 1, 1), complex))
    assert resolve_device('cpu') == torch.device('cpu')
    assert tb.Eurus(dict(config, device='cpu')).dtype == torch.complex128


def test_cpu_dispatch_runs_the_twins():
    rng = np.random.default_rng(3)
    planes = torch.from_numpy(rng.standard_normal((9, 9, 7)) + 0j)
    u = torch.from_numpy(rng.standard_normal((2, 9, 7)) + 0j)
    before = dict(cuda_kernels.LAUNCHES)
    out = tst.apply_stencil_batched(planes, u)
    assert torch.equal(out, tst.apply_stencil(planes, u))
    assert cuda_kernels.LAUNCHES == before


def test_cuda_kernel_requests_raise_without_a_card(monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the kernels run instead')
    planes = torch.zeros((9, 9, 7), dtype=torch.complex64)
    u = torch.zeros((2, 9, 7), dtype=torch.complex64)
    # a wrapper given CPU tensors refuses (no silent twin)
    with pytest.raises(ValueError, match='CUDA tensors'):
        cuda_kernels.apply_stencil(planes, u)
    # tensors on a device with no kernel raise in the dispatch
    with pytest.raises(RuntimeError, match='no kernel'):
        tst.apply_stencil_batched(planes.to('meta'), u.to('meta'))
    # a CUDA discretization cannot quietly run on the CPU
    config = dict(_small_config(False), device='cuda')
    with pytest.raises((RuntimeError, AssertionError)):
        tb.MiniZephyr(config).A
    # no nvcc: the build raises instead of falling back
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    monkeypatch.setenv('PATH', str(tmp_path))
    monkeypatch.setattr(cuda_kernels, 'BUILD_DIR', tmp_path / 'build')
    with pytest.raises(RuntimeError, match='nvcc'):
        cuda_kernels.build()
