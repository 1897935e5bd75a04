'''
The port's device meshes and sharded FWI step
(zephyr_tpu_torch.parallel.mesh, ``make_sharded_fwi_step``) against the
JAX package's (tests/test_parallel.py, tests/test_distributed_multiprocess.py):
virtual meshes of the CPU, ``torch.distributed`` with gloo across two
processes, complex128.

Tolerances: the sharded FWI step against the JAX package's and against
the single-device autograd gradient rtol 1e-6 (JAX's bar, its
tests/test_parallel.py:98-133; solver tol 1e-9, converged); the
two-process step equal to the one-process step within 1e-10 relative.
'''

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zephyr_tpu.parallel import (make_mesh as j_make_mesh,
                                 make_sharded_fwi_step as j_step)
from zephyr_tpu.solver.helmholtz import SolverConfig as JConfig

from zephyr_tpu_torch.parallel import (make_mesh, freq_src_sharding,
                                       replicated, make_sharded_fwi_step,
                                       fwi_misfit, multifreq_dpred)
from zephyr_tpu_torch.parallel.mesh import (Sharding,
                                            initialize_distributed,
                                            make_multihost_mesh)
from zephyr_tpu_torch.solver.helmholtz import SolverConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NZ, NX = 40, 32
FREQS = np.array([40., 60.])
CFG = dict(tol=1e-9, maxiter=500, mg_coarse='inv', mg_min_size=16)


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


def test_make_mesh_virtual():
    mesh = make_mesh(freq=4, src=2, devices=['cpu'] * 8)
    assert mesh.axis_names == ('freq', 'src')
    assert mesh.shape == {'freq': 4, 'src': 2}
    assert all(d == torch.device('cpu') for d in mesh.devices.ravel())
    assert len(mesh.coords()) == 8
    assert make_mesh(devices=['cpu'] * 3).shape == {'freq': 3, 'src': 1}
    assert make_mesh(src=2, devices=['cpu'] * 4).shape == {'freq': 2,
                                                           'src': 2}
    with pytest.raises(ValueError):
        make_mesh(freq=4, src=2, devices=['cpu'] * 4)


def test_make_mesh_refuses_without_card():
    'The default devices are the cards; without one it says so.'
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError):
        make_mesh()
    with pytest.raises(RuntimeError):
        make_multihost_mesh()


def test_sharding_split_gather():
    'freq_src_sharding splits axes 0 and 1 evenly; gather inverts it.'
    mesh = make_mesh(freq=2, src=2, devices=['cpu'] * 4)
    a = np.arange(4 * 6 * 3, dtype=np.float64).reshape(4, 6, 3)
    fs = freq_src_sharding(mesh)
    parts = fs.split(a)
    assert parts[(1, 0)].shape == (2, 3, 3)
    assert np.array_equal(parts[(1, 0)].numpy(), a[2:4, 0:3])
    assert np.array_equal(fs.gather(parts).numpy(), a)
    rep = replicated(mesh).split(a)
    assert all(np.array_equal(p.numpy(), a) for p in rep.values())
    with pytest.raises(ValueError):
        fs.split(np.zeros((3, 6)))
    joint = Sharding(mesh, (('freq', 'src'),))
    assert np.array_equal(joint.shard(a, (1, 0))[:, 0, 0].numpy(),
                          a[2:3, 0, 0])


def test_initialize_distributed_single_process_noop(monkeypatch):
    'Single-process bring-up is a no-op returning False.'
    for k in ('MASTER_ADDR', 'MASTER_PORT', 'WORLD_SIZE', 'RANK'):
        monkeypatch.delenv(k, raising=False)
    assert initialize_distributed() is False
    with pytest.raises(ValueError):
        initialize_distributed(num_processes=4)


def test_make_multihost_mesh_single_host():
    "('host', 'freq', 'src') degenerates to host=1 in one process."
    mesh = make_multihost_mesh(freq=2, src=2, devices=['cpu'] * 4)
    assert mesh.axis_names == ('host', 'freq', 'src')
    assert mesh.shape == {'host': 1, 'freq': 2, 'src': 2}
    parts = {c: torch.ones(()) for c in mesh.coords()}
    assert float(mesh.psum(parts)) == 4.0


def _problem():
    '''
    The dry-run's problem at 40x32 (__graft_entry__.py:21-32, 126-133):
    2 frequencies x 2 sources x 3 receivers, data at a perturbed model.
    '''
    nfreq, nsrc, nrec = len(FREQS), 2, 3
    c = 2000. * np.ones((NZ, NX))
    rho = np.ones((NZ, NX))
    q = np.zeros((nfreq, nsrc, NZ, NX), dtype=np.complex128)
    for s in range(nsrc):
        q[:, s, 10 + 5 * s, 8] = 1.0
    R = np.zeros((nrec, NZ * NX), dtype=np.complex128)
    for r in range(nrec):
        R[r, (12 + 8 * r) * NX + (NX - 8)] = 1.0
    c_true = c.copy()
    c_true[18:26, 12:20] -= 100.
    with torch.no_grad():
        dobs = multifreq_dpred(c_true, rho, FREQS, q, R,
                               config=SolverConfig(**CFG), nPML=8,
                               device='cpu').numpy()
    return c, rho, q, R, dobs


@pytest.fixture(scope='module')
def problem():
    return _problem()


@pytest.fixture(scope='module')
def jax_step(problem):
    'JAX make_sharded_fwi_step on a (freq=2, src=2) mesh (one run).'
    c, rho, q, R, dobs = problem
    if jax.device_count() < 4:
        pytest.skip('needs 4 JAX devices')
    step = j_step(j_make_mesh(freq=2, src=2, devices=jax.devices()[:4]),
                  rho, FREQS, q, R, dobs, lr=1e6, config=JConfig(**CFG),
                  nPML=8)
    c1, misfit, grad = step(jnp.asarray(c))
    return np.asarray(c1), float(misfit), np.asarray(grad)


def test_sharded_fwi_step_matches_jax_and_single_device(problem, jax_step):
    c, rho, q, R, dobs = problem
    mesh = make_mesh(freq=2, src=2, devices=['cpu'] * 4)
    step = make_sharded_fwi_step(mesh, rho, FREQS, q, R, dobs, lr=1e6,
                                 config=SolverConfig(**CFG), nPML=8)
    c1, misfit, grad = step(c)
    c1, misfit, grad = c1.numpy(), float(misfit), grad.numpy()
    c1_j, misfit_j, grad_j = jax_step
    assert np.isfinite(misfit) and misfit > 0
    assert np.isclose(misfit, misfit_j, rtol=1e-6)
    assert np.allclose(grad, grad_j, rtol=1e-6, atol=1e-6 * np.abs(
        grad_j).max())
    assert np.allclose(c1, c1_j, rtol=1e-6)

    # sharded gradient == single-device autograd gradient
    ct = torch.as_tensor(c).requires_grad_(True)
    m = fwi_misfit(ct, dobs, rho, FREQS, q, R, config=SolverConfig(**CFG),
                   nPML=8, device='cpu')
    g_single, = torch.autograd.grad(m, ct)
    g_single = g_single.numpy()
    assert np.isclose(misfit, float(m.detach()), rtol=1e-6)
    assert np.allclose(grad, g_single, rtol=1e-6,
                       atol=1e-6 * np.abs(g_single).max())


_WORKER = r'''
import sys
sys.path.insert(0, %(repo)r)
import numpy as np
import torch
import torch.distributed as dist
from zephyr_tpu_torch.parallel import make_mesh, make_sharded_fwi_step
from zephyr_tpu_torch.parallel.mesh import (initialize_distributed,
                                            make_multihost_mesh)
from zephyr_tpu_torch.solver.helmholtz import SolverConfig

pid = int(sys.argv[1])
port = sys.argv[2]
ok = initialize_distributed('localhost:' + port, 2, pid)
assert ok is True
assert initialize_distributed('localhost:' + port, 2, pid) is True
assert dist.get_world_size() == 2 and dist.get_backend() == 'gloo'

mesh = make_multihost_mesh(freq=2, src=1, devices=['cpu'] * 2)
assert mesh.axis_names == ('host', 'freq', 'src')
assert mesh.devices.shape == (2, 2, 1)
assert [c[0] for c in mesh.coords()] == [pid, pid]
# process 0 contributes 2 x 1.0, process 1 contributes 2 x 2.0
parts = {c: torch.full((), float(pid + 1)) for c in mesh.coords()}
assert float(mesh.psum(parts)) == 6.0

# the two-host sharded FWI step: each process its own frequency
p = np.load(%(problem)r)
args = (p['rho'], p['freqs'], p['q'], p['R'], p['dobs'])
cfg = SolverConfig(**%(cfg)r)
step = make_sharded_fwi_step(make_multihost_mesh(freq=1, src=2,
                                                 devices=['cpu'] * 2),
                             *args, lr=1e6, config=cfg, nPML=8)
c1, misfit, grad = step(p['c'])
# one process, the same blocks: a (freq=2, src=2) virtual mesh
one = make_sharded_fwi_step(make_mesh(freq=2, src=2, devices=['cpu'] * 4),
                            *args, lr=1e6, config=cfg, nPML=8)
c1_1, misfit_1, grad_1 = one(p['c'])
rel = float(torch.linalg.norm(grad - grad_1) / torch.linalg.norm(grad_1))
assert rel <= 1e-10, rel
assert abs(float(misfit) - float(misfit_1)) <= 1e-10 * float(misfit_1)
assert float(torch.abs(c1 - c1_1).max()) <= 1e-10 * 2000.
dist.destroy_process_group()
print('DIST_OK process %%d rel %%.3e' %% (pid, rel))
'''


def _free_port():
    s = socket.socket()
    s.bind(('localhost', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed(problem, tmp_path):
    '''
    Two OS processes on localhost form a gloo group
    (``initialize_distributed``), build the ('host', 'freq', 'src') mesh,
    all-reduce over it (6.0), and run the two-host sharded FWI step, each
    process one frequency, equal within 1e-10 to the one-process step on
    the same blocks (a (freq=2, src=2) virtual mesh: a different source
    batching moves the converged solves by ~2e-8).
    '''
    c, rho, q, R, dobs = problem
    path = str(tmp_path / 'problem.npz')
    np.savez(path, c=c, rho=rho, freqs=FREQS, q=q, R=R, dobs=dobs)
    code = _WORKER % {'repo': REPO, 'problem': path, 'cfg': CFG}
    port = str(_free_port())
    env = dict(os.environ)
    for k in ('MASTER_ADDR', 'MASTER_PORT', 'WORLD_SIZE', 'RANK'):
        env.pop(k, None)
    env['OMP_NUM_THREADS'] = '1'
    procs = [subprocess.Popen([sys.executable, '-c', code, str(pid), port],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail('distributed workers timed out')

    for pid, (rc, out, err) in enumerate(outs):
        assert rc == 0, 'worker %d failed:\n%s\n%s' % (pid, out,
                                                       err[-2000:])
        assert 'DIST_OK process %d' % pid in out
