'''
Port parity of the inversion drivers: zephyr_tpu_torch.middleware's
copies of ``l2_DataMisfit``, ``BaseInvProblem``, ``BaseInversion`` and
``FrequencyContinuation`` driving the port's Helm2DProblem, against the
JAX package's drivers driving its own problem, on the same observed data,
on the CPU in complex128: a 32x28 transmission survey (4 sources, 6
receivers) over a slow box, two frequencies, the default solver config
cut to three multigrid levels at tol 1e-10, two optimizer iterations.

The JAX problem's ``misfit_and_gradient`` is value_and_grad of
0.5 ||forward(c) - dobs||^2 over its forward map, run eagerly, which
traces and compiles every call (minutes here). The reference problem
below computes the same value and gradient of the same forward map
compiled once for each distinct survey and configuration.

Tolerances: the misfit after each block and the final model, relative,
within 1e-6 (every evaluation agrees to ~1e-9; the optimizers' line
searches take the same steps).
'''

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import zephyr_tpu.backend as jb
import zephyr_tpu.middleware as jm
from zephyr_tpu_torch import convert
import zephyr_tpu_torch.middleware as tm

NZ, NX = 32, 28
FREQS = [150., 220.]
C0 = 2000.
TOL = 1e-6


def _config():
    return {'Disc': jb.MiniZephyr, 'nx': NX, 'nz': NZ, 'dx': 1., 'dz': 1.,
            'c': C0 * np.ones((NZ, NX)), 'rho': 1., 'freqs': list(FREQS),
            'geom': {'src': np.array([[4., z] for z in (4., 12., 20., 28.)]),
                     'rec': np.array([[24., z] for z in
                                      np.linspace(4., 28., 6)]),
                     'mode': 'fixed'},
            'nPML': 6, 'solverOpts': {'tol': 1e-10, 'mg_min_size': 10}}


def _observed():
    '''
    The data of the true model (a slow box) by the port's survey,
    (nrec, nsrc, nfreq): both packages invert the same data.
    '''
    c = C0 * np.ones((NZ, NX))
    c[12:20, 10:18] -= 150.
    sc = convert.system_config(dict(_config(), c=c), device='cpu')
    p, s = tm.Helm2DProblem(sc), tm.Helm2DSurvey(sc)
    p.pair(s)
    return s.dpred().reshape((s.nrec, s.nsrc, s.nfreq))


class _CompiledJaxProblem(jm.Helm2DProblem):
    '''
    The JAX Helm2DProblem with ``misfit_and_gradient`` compiled: the same
    value and gradient of its own forward map, one compile for each
    distinct survey and configuration (class-wide).
    '''

    compiled = {}

    def misfit_and_gradient(self, m, dobs):
        self.updateModel(m)
        key = (self._surveyFingerprint()[1], self.solverConfig)
        if key not in self.compiled:
            forward = self._dpred_fn()

            def objective(c, dobs):
                return 0.5 * jnp.sum(jnp.abs(forward(c) - dobs) ** 2)

            with jax.ensure_compile_time_eval():
                self.compiled[key] = jax.jit(jax.value_and_grad(objective))
        shape = (self.survey.nrec, self.survey.nsrc, self.survey.nfreq)
        val, grad = self.compiled[key](
            jnp.asarray(self.baseVelocity),
            jnp.asarray(np.asarray(dobs).reshape(shape)))
        return float(val), np.asarray(grad).ravel()


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    'One torch thread: at these sizes more are no faster.'
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _packages():
    'Per package: its middleware, problem class and config converter.'
    return (('jax', jm, _CompiledJaxProblem, lambda sc: sc),
            ('torch', tm, tm.Helm2DProblem,
             lambda sc: convert.system_config(sc, device='cpu')))


def test_base_inversion_matches_jax():
    '''
    l2_DataMisfit + BaseInvProblem + BaseInversion with L-BFGS, two
    iterations over both frequencies from the homogeneous start.
    '''
    dobs = _observed()
    out = {}
    for name, mw, problem_cls, conv in _packages():
        sc = conv(_config())
        p, s = problem_cls(sc), mw.Helm2DSurvey(sc)
        p.pair(s)
        dmisfit = mw.l2_DataMisfit(s, dobs)
        opt = mw.LBFGS(maxIter=2, print_progress=False)
        m = mw.BaseInversion(mw.BaseInvProblem(dmisfit, opt=opt)).run(
            C0 * np.ones(NZ * NX))
        out[name] = (opt.f, m)
    (fj, mj), (ft, mt) = out['jax'], out['torch']
    assert 0 < ft and abs(ft - fj) / fj < TOL
    assert np.abs(mt - C0).max() > 1.
    assert np.linalg.norm(mt - mj) / np.linalg.norm(mj - C0) < TOL


def test_frequency_continuation_matches_jax():
    '''
    FrequencyContinuation over blocks [[0], [1]] (low frequency first,
    each block warm-started), two ProjectedGradient iterations a block:
    the per-block misfit history and the final model.
    '''
    dobs = _observed()
    out = {}
    for name, mw, problem_cls, conv in _packages():
        driver = mw.FrequencyContinuation(
            problem_cls, mw.Helm2DSurvey, conv(_config()), dobs,
            blocks=[[0], [1]],
            optFactory=lambda mw=mw: mw.ProjectedGradient(
                maxIter=2, print_progress=False))
        m = driver.run(C0 * np.ones(NZ * NX))
        out[name] = (driver.history, m)
    (hj, mj), (ht, mt) = out['jax'], out['torch']
    assert [h['block'] for h in ht] == [[0], [1]]
    for a, b in zip(ht, hj):
        assert abs(a['f'] - b['f']) / b['f'] < TOL
    assert np.linalg.norm(mt - mj) / np.linalg.norm(mj - C0) < TOL


def test_frequency_continuation_refuses_the_cpu_by_default(monkeypatch):
    '''
    Without a card, FrequencyContinuation over a systemConfig without a
    ``device`` key raises RuntimeError (nothing falls back to the CPU).
    '''
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    sc = convert.system_config(_config(), device='cpu')
    del sc['device'], sc['dtype']
    driver = tm.FrequencyContinuation(
        tm.Helm2DProblem, tm.Helm2DSurvey, sc,
        np.zeros((6, 4, 2), complex), blocks=[[0]])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        driver.run(C0 * np.ones(NZ * NX))
