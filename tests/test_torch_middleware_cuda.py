'''
The 2D inverse-problem layer on the card: Helm2DProblem's adjoint dot
test at 128^2 in complex64 with the production config (mg_min_size 16),
within 1e-3. Marked ``cuda``: without an NVIDIA GPU and nvcc it skips.
On a machine with one (where jax is not installed, add
``--noconftest``):

    python -m pytest tests/test_torch_middleware_cuda.py -q
'''

import numpy as np
import pytest
import torch

from zephyr_tpu_torch.backend import MiniZephyr
from zephyr_tpu_torch.middleware import Helm2DProblem, Helm2DSurvey

pytestmark = pytest.mark.cuda
PRODUCTION = dict(tol=1e-5, maxiter=2000, mg_coarse='inv', mg_min_size=16,
                  fft_mode='strat', fft_scale=2, hybrid_comp='fused',
                  mg_nu1=2, mg_nu2=1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the problem runs on the card)')
    return 'cuda'


def test_problem_dot_test_128(dev):
    n = 128
    c = 2000. * np.ones((n, n))
    c[60:90, 40:80] = 2300.
    sc = {'Disc': MiniZephyr, 'nx': n, 'nz': n, 'c': c, 'rho': 1.,
          'freqs': [2000. / 16, 2000. / 12], 'nPML': 10, 'device': dev,
          'geom': {'src': np.array([[30., 30.], [90., 40.]]),
                   'rec': np.stack([np.linspace(16., 112., 8),
                                    np.full(8, 16.)], axis=1),
                   'mode': 'fixed'},
          'solverOpts': PRODUCTION}
    p, s = Helm2DProblem(sc), Helm2DSurvey(sc)
    p.pair(s)
    assert p.dtype == torch.complex64
    rng = np.random.default_rng(2)
    v = rng.standard_normal(n * n)
    w = rng.standard_normal(s.nD) + 1j * rng.standard_normal(s.nD)
    jv, jt = p.Jvec(v=v), p.Jtvec(v=w)
    assert np.isfinite(jv).all() and np.isfinite(jt).all()
    lhs = float(np.real(np.vdot(w, jv)))
    assert abs(lhs - float(np.dot(jt.astype(np.float64), v))) / abs(lhs) \
        < 1e-3
