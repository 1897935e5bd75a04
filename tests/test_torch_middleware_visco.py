'''
Port parity of the 2D inverse-problem layer, continued (split from
tests/test_torch_middleware.py, whose helpers, configs and tolerances it
uses, so that the two files' JAX compiles run on separate test workers):
Helm2DViscoProblem and Helm2DViscoMultiGridProblem against zephyr_tpu
under the default and the production configs (dpred and Jtvec, rel
1e-6), and the Eurus problem's Jvec at 24x20 (rel 1e-6). CPU,
complex128.
'''

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import zephyr_tpu.backend as jb
# _one_thread is the shared module's autouse fixture: importing it applies
# it here too
from test_torch_middleware import (FREQS, NX, NZ, _config, _jax_refs,
                                   _one_thread, _pair, _rel, _torch_problem,
                                   _torch_product)  # noqa: F401


@pytest.mark.parametrize('name', ['default', 'production'])
@pytest.mark.parametrize('kind', ['visco', 'visco_mg'])
def test_visco_problems_match_jax(kind, name):
    '''
    Helm2DViscoProblem (Q 40, freqBase 100: the dispersed velocity) and
    Helm2DViscoMultiGridProblem (MiniZephyrHD, each frequency on its own
    grid, the model resampled inside the map): dpred and Jtvec.
    '''
    p, s = _torch_problem(kind, name)
    ref = _jax_refs(kind, name)
    assert _rel(_torch_product(kind, name, 'dpred'), ref['dpred_dist']) \
        < 1e-6
    d_fn = p._dpred_fn()(p._baseTensor())
    assert _rel(d_fn.numpy().ravel(), ref['dpred']) < 1e-6
    assert _rel(_torch_product(kind, name, 'jtvec'), ref['jtvec']) < 1e-6
    if kind == 'visco_mg':
        shapes = {(int(p.survey.scScales[p.survey.buildSC(i)]['nz']),
                   int(p.survey.scScales[p.survey.buildSC(i)]['nx']))
                  for i in range(len(FREQS))}
        assert len(shapes) == 2 and (NZ, NX) not in shapes


def test_eurus_jvec_matches_jax():
    '''
    The Eurus (TTI) problem's Jvec at 24x20, one frequency (the block
    solve's forward-mode rule, dA x through the block apply; the V-cycle
    preconditioner with Jacobi smoothing keeps the JAX side quick to
    build); its Jtvec raises the TTI-gradient message.
    '''
    nz, nx = 24, 20
    sc = _config(nz=nz, nx=nx, c=2000. * np.ones((nz, nx)), Disc=jb.Eurus,
                 theta=0.1 * np.ones((nz, nx)), eps=0.1 * np.ones((nz, nx)),
                 delta=0.05 * np.ones((nz, nx)), cPML=1e3, nPML=4,
                 freqs=[150.],
                 geom={'src': np.array([[6., 6.], [14., 8.]]),
                       'rec': np.array([[4., 18.], [10., 18.], [16., 18.]]),
                       'mode': 'fixed'},
                 solverOpts=dict(tol=1e-10, maxiter=600, mg_min_size=8,
                                 precond='mg', mg_smoother='jacobi'))
    (jp, _), (tp, ts) = (_pair(pkg, 'Helm2DProblem', 'Helm2DSurvey',
                               dict(sc)) for pkg in ('jax', 'torch'))
    v = np.random.default_rng(8).standard_normal(nz * nx)
    _, ref = jax.jvp(jp._dpred_fn(), (jnp.asarray(jp.baseVelocity),),
                     (jnp.asarray(v.reshape(nz, nx)),))
    assert _rel(tp.Jvec(v=v), np.asarray(ref).ravel()) < 1e-6
    with pytest.raises(NotImplementedError, match='8b'):
        tp.Jtvec(v=np.ones(ts.nD, complex))
