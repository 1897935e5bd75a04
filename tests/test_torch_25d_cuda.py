'''
The 2.5D problem on the card: Helm25DProblem (the remDists chain over
MiniZephyr25D, nky 4) at 128^2 in complex64 with the production config
(mg_min_size 16) at tol 1e-6: survey.dpred() through the distributor
equals the problem's forward map within 1e-3, and the adjoint dot test
of Jvec and Jtvec holds within 1e-3. The tolerance is 1e-6, not the
production 1e-5, because here |Re<w, Jv>| is 1/20 of ||w|| ||Jv||: at
1e-5 the identity holds only to ~1.1e-3 in complex64 and in complex128
alike (5.5e-5 at 1e-6, 4.3e-8 at 1e-8 in complex128, on the CPU).
Marked ``cuda``: without an NVIDIA GPU and nvcc it skips. On a machine with one (where jax is not installed, add
``--noconftest``):

    python -m pytest tests/test_torch_25d_cuda.py -q
'''

import numpy as np
import pytest
import torch

from zephyr_tpu_torch.backend import MiniZephyr, MiniZephyr25D
from zephyr_tpu_torch.middleware import Helm25DProblem, Helm25DSurvey

pytestmark = pytest.mark.cuda
PRODUCTION = dict(tol=1e-6, maxiter=2000, mg_coarse='inv', mg_min_size=16,
                  fft_mode='strat', fft_scale=2, hybrid_comp='fused',
                  mg_nu1=2, mg_nu2=1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the problem runs on the card)')
    return 'cuda'


def test_25d_problem_dpred_and_dot_test_128(dev):
    n = 128
    c = 2000. * np.ones((n, n))
    c[60:90, 40:80] = 2300.
    sc = {'Disc': MiniZephyr, 'nx': n, 'nz': n, 'c': c, 'rho': 1.,
          'freqs': [2000. / 16], 'nPML': 10, 'device': dev,
          'remDists': [MiniZephyr25D], 'nky': 4, 'parallel': False,
          'cmin': 2000.,
          'geom': {'src': np.array([[30., 30.], [90., 40.]]),
                   'rec': np.stack([np.linspace(16., 112., 8),
                                    np.full(8, 16.)], axis=1),
                   'mode': 'fixed'},
          'solverOpts': PRODUCTION}
    p, s = Helm25DProblem(sc), Helm25DSurvey(sc)
    p.pair(s)
    assert p.dtype == torch.complex64 and p._discInfo()[3]
    d = s.dpred()
    with torch.no_grad():
        d_fn = p._dpred_fn()(p._baseTensor()).cpu().numpy().ravel()
    assert np.isfinite(d).all() and np.abs(d).max() > 0
    assert np.linalg.norm(d_fn - d) / np.linalg.norm(d) < 1e-3
    rng = np.random.default_rng(2)
    v = rng.standard_normal(n * n)
    w = rng.standard_normal(s.nD) + 1j * rng.standard_normal(s.nD)
    jv, jt = p.Jvec(v=v), p.Jtvec(v=w)
    assert np.isfinite(jv).all() and np.isfinite(jt).all()
    lhs = float(np.real(np.vdot(w, jv)))
    assert abs(lhs - float(np.dot(jt.astype(np.float64), v))) / abs(lhs) \
        < 1e-3
