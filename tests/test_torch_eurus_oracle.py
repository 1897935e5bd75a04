'''
The Eurus TTI oracles of the port (split from tests/test_torch_eurus.py,
whose long pole they were): ``Eurus * q`` against the analytical
Green's function at 200x100 (the reference's test_Eurus.py accuracy
test, complex128, the default SolverConfig; interior-window error
< 3e-2), and the port's AnalyticalHelmholtz against the JAX package's
with an array config (rel 1e-12).
'''

import numpy as np
import pytest
import torch

import zephyr_tpu.backend as jb
import zephyr_tpu_torch.backend as tb


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    '''
    One torch thread for this file: a 200x100 solve gains nothing from
    more, and beside the suite's other workers more threads than cores
    slowed the isotropic oracle to 429 s (about 10 s alone).
    '''
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel())


def _oracle_config(epsval, deltaval):
    nx, nz = 100, 200
    return {'c': 2000. * np.ones((nz, nx)), 'rho': np.ones((nz, nx)),
            'freq': 2e2, 'nx': nx, 'nz': nz, 'dx': 1., 'dz': 1.,
            'theta': np.zeros((nz, nx)), 'eps': epsval * np.ones((nz, nx)),
            'delta': deltaval * np.ones((nz, nx)), 'nPML': 10, 'cPML': 1e3,
            'freeSurf': (False, False, False, False), 'device': 'cpu'}


@pytest.mark.parametrize('aniso', [(0., 0.), (0.2, 0.2)],
                         ids=['isotropic', 'elliptical'])
def test_eurus_oracle(aniso):
    '''
    The reference's test_Eurus.py accuracy test in the port (default
    SolverConfig, complex128): interior-window error < 3e-2.
    '''
    config = _oracle_config(*aniso)
    sloc = np.array([[25, 25]])
    uE = (tb.Eurus(config) * tb.StackedSimpleSource(config)(sloc)).ravel()
    uAH = tb.AnalyticalHelmholtz(config)(sloc)
    segA = uAH.reshape((200, 100))[40:180, 40:80]
    segE = uE[:20000].reshape((200, 100))[40:180, 40:80]
    rel = (segA - segE) / abs(segA)
    assert np.sqrt((rel.conj() * rel).sum()).real / rel.size < 3e-2


def test_array_config_oracle_matches_jax():
    config = _oracle_config(0.2, 0.1)
    config['theta'] = 0.25 * np.ones((200, 100))
    loc = np.array([[25., 30.]])
    g_t = tb.AnalyticalHelmholtz(config)(loc)
    g_j = np.asarray(jb.AnalyticalHelmholtz(config)(loc))
    assert _rel(g_t, g_j) < 1e-12
