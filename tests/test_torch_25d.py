'''
Port parity of 2.5D modelling: zephyr_tpu_torch's ``MiniZephyr25D``,
``parallel.multifreq_dpred_25d`` and the 2.5D problems
(``Helm25DProblem``, ``Helm25DViscoProblem``) against zephyr_tpu on the
same inputs, on the CPU in complex128, the default solver config cut to
three multigrid levels (mg_min_size=10) at tol 1e-10 unless stated.

The port sums over cross-line wavenumbers ky in one host loop, one
prepared operator at a time. The JAX package has two paths: it vmaps the
ky axis for nky <= 8 and scans it above. So the port is held against the
vmap path at nky 3 and against the scan path at nky 9.

The JAX problem's references (data, jax.jvp for Jvec, jax.vjp of
conj(w) for Jtvec, and 0.5 ||r||^2 of the residual against seeded data
with its gradient) come from one compiled program over its forward map
(``_dpred_fn``), as in tests/test_torch_middleware.py.

Tolerances (relative, 2-norm): wavefields, data, Jvec, Jtvec, misfit and
gradient within 1e-6 (both packages solve to 1e-9 or 1e-10); the port's
adjoint dot test within 1e-8; the reference's analytical oracle (slow)
below 1e-2, as tests/test_minizephyr.py:88-115.
'''

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import zephyr_tpu.backend as jb
import zephyr_tpu.middleware as jm
from zephyr_tpu.parallel import multifreq as jmf
from zephyr_tpu.solver.helmholtz import SolverConfig as JaxConfig
from zephyr_tpu_torch import convert
import zephyr_tpu_torch.backend as tb
import zephyr_tpu_torch.middleware as tm
from zephyr_tpu_torch.parallel import multifreq as tmf
from zephyr_tpu_torch.solver.helmholtz import SolverConfig

NZ, NX = 32, 28
SRC = np.array([[8., 8.], [20., 10.]])
REC = np.array([[6., 26.], [14., 27.], [22., 26.]])
OPTS = {'tol': 1e-10, 'mg_min_size': 10}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel())


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    'One torch thread: at these sizes more are no faster.'
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- MiniZephyr25D and multifreq_dpred_25d ----------------------------------

def _compat_config(nky, **kw):
    sc = {'c': 2500. * np.ones((48, 40)), 'rho': 1., 'nx': 40, 'nz': 48,
          'freq': 80., 'nky': nky, 'parallel': False,
          'solverOpts': {'tol': 1e-9, 'maxiter': 600, 'mg_min_size': 10}}
    sc.update(kw)
    return sc


@pytest.mark.parametrize('nky', [3, 9])
def test_minizephyr25d_matches_jax(nky):
    '''
    MiniZephyr25D * q (the ky subproblems looped serially, weighted and
    scaled) against the JAX package's, and its reference attributes.
    '''
    sc = _compat_config(nky)
    q = jb.SimpleSource(sc)(np.array([[10., 12.]]))
    jz = jb.MiniZephyr25D(sc)
    tz = tb.MiniZephyr25D(dict(sc, device='cpu'))
    u = tz * q
    assert u.shape == (48 * 40, 1) and u.dtype == np.complex128
    assert _rel(u, jz * q) < 1e-6
    assert np.allclose(tz.pkys, jz.pkys) and tz.nky == nky
    assert tz.spUpdates == jz.spUpdates
    assert tz.scaleTerm == jz.scaleTerm
    assert len(tz.subProblems) == nky and tz.factors
    assert all(s.device.type == 'cpu' for s in tz.subProblems)
    del tz.factors
    assert not tz.factors


def test_multifreq_dpred_25d_matches_jax_and_compat():
    '''
    The ky summation of parallel.multifreq against the JAX package's
    (its vmap path, nky 3) and against the port's MiniZephyr25D, full
    wavefield extracted (mirrors tests/test_parallel.py:137-163).
    '''
    nky, freq = 3, 80.
    sc = _compat_config(nky)
    c = sc['c']
    qvec = jb.SimpleSource(sc)(np.array([[10., 12.]]))
    u_compat = (tb.MiniZephyr25D(dict(sc, device='cpu')) * qvec).ravel()
    q = qvec.T.reshape((1, 1, 48, 40))
    R = np.eye(48 * 40, dtype=np.complex128)
    kw = dict(nky=nky, cmin=2500., config=SolverConfig(
        tol=1e-9, maxiter=600, mg_min_size=10))
    d = tmf.multifreq_dpred_25d(c + 0j, np.ones((48, 40)), [freq], q, R,
                                device='cpu', **kw)
    kw['config'] = JaxConfig(tol=1e-9, maxiter=600, mg_min_size=10)
    d_jax = jax.jit(functools.partial(jmf.multifreq_dpred_25d, **kw))(
        jnp.asarray(c + 0j), jnp.ones((48, 40)), jnp.asarray([freq]),
        jnp.asarray(q), jnp.asarray(R))
    assert d.shape == (1, 1, 48 * 40)
    assert _rel(d.numpy()[0, 0], np.asarray(d_jax)[0, 0]) < 1e-6
    assert _rel(d.numpy()[0, 0], u_compat) < 1e-6


# --- the 2.5D problems -------------------------------------------------------

def _model():
    c = 2000. * np.ones((NZ, NX))
    c[14:22, 8:18] = 2200.
    return c


def _problem_config(nky=3, **kw):
    sc = {'Disc': jb.MiniZephyr, 'nx': NX, 'nz': NZ, 'dx': 1., 'dz': 1.,
          'c': _model(), 'rho': 1., 'freqs': [180.],
          'geom': {'src': SRC.copy(), 'rec': REC.copy(), 'mode': 'fixed'},
          'nPML': 6, 'solverOpts': dict(OPTS),
          'remDists': [jb.MiniZephyr25D], 'nky': nky, 'parallel': False,
          'cmin': 2000.}
    sc.update(kw)
    return sc


def _pair(pkg, sc, problem='Helm25DProblem', survey='Helm25DSurvey'):
    if pkg == 'jax':
        p, s = getattr(jm, problem)(sc), getattr(jm, survey)(sc)
    else:
        sc = convert.system_config(sc, device='cpu')
        p, s = getattr(tm, problem)(sc), getattr(tm, survey)(sc)
    p.pair(s)
    return p, s


def _vectors(nd):
    'The seeded model perturbation v, data vector w and observed data.'
    rng = np.random.default_rng(8)
    v = rng.standard_normal(NZ * NX)
    w = rng.standard_normal(nd) + 1j * rng.standard_normal(nd)
    dobs = 1e-3 * (rng.standard_normal(nd) + 1j * rng.standard_normal(nd))
    return v, w, dobs


@functools.lru_cache(maxsize=None)
def _jax_refs():
    '''
    The JAX Helm25DProblem's data, Jvec(v), Jtvec(w), misfit against dobs
    and its gradient (nky 3: the vmap path), one compiled program.
    '''
    p, s = _pair('jax', _problem_config())
    v, w, dobs = _vectors(s.nD)
    shape = (s.nrec, s.nsrc, s.nfreq)
    fwd = p._dpred_fn()

    def refs(c, v, w, dobs):
        d, vjp = jax.vjp(fwd, c)
        r = d - dobs
        return {'dpred': d, 'jvec': jax.jvp(fwd, (c,), (v,))[1],
                'jtvec': jnp.real(vjp(jnp.conj(w))[0]),
                'misfit': 0.5 * jnp.sum(jnp.abs(r) ** 2),
                'grad': jnp.real(vjp(jnp.conj(r))[0])}

    with jax.ensure_compile_time_eval():
        out = jax.jit(refs)(jnp.asarray(p.baseVelocity),
                            jnp.asarray(v.reshape(NZ, NX)),
                            jnp.asarray(w.reshape(shape)),
                            jnp.asarray(dobs.reshape(shape)))
    return {k: np.asarray(a).ravel() for k, a in out.items()}


@functools.lru_cache(maxsize=None)
def _torch_products():
    'The port\'s survey.dpred(), Jvec(v) and Jtvec(w), nky 3.'
    p, s = _pair('torch', _problem_config())
    v, w, _ = _vectors(s.nD)
    return {'dpred': s.dpred(), 'jvec': p.Jvec(v=v), 'jtvec': p.Jtvec(v=w)}


def test_helm25d_problem_dpred_matches_jax():
    '''
    survey.dpred() through the nested distributor chain (MultiFreq over
    MiniZephyr25D over MiniZephyr) and the problem's forward map, against
    the JAX problem's data.
    '''
    p, s = _pair('torch', _problem_config())
    ref = _jax_refs()['dpred']
    d = _torch_products()['dpred']
    assert d.shape == (s.nD,) and d.dtype == np.complex128
    assert _rel(d, ref) < 1e-6
    d_fn = p._dpred_fn()(p._baseTensor()).numpy().ravel()
    assert _rel(d_fn, ref) < 1e-6


@pytest.mark.parametrize('what', ['jvec', 'jtvec'])
def test_helm25d_jacobian_products_match_jax(what):
    'Jvec (a tangent solve a ky) and Jtvec (a transpose solve a ky).'
    out = _torch_products()[what]
    assert out.dtype == (np.complex128 if what == 'jvec' else np.float64)
    assert _rel(out, _jax_refs()[what]) < 1e-6


def test_helm25d_adjoint_dot_test():
    'The port alone: Re<w, J v> == <J^T w, v> to 1e-8.'
    v, w, _ = _vectors(2 * 3)
    lhs = np.real(np.vdot(w, _torch_products()['jvec']))
    rhs = float(np.dot(_torch_products()['jtvec'], v))
    assert abs(lhs - rhs) / abs(lhs) < 1e-8


def test_helm25d_misfit_and_gradient_match_jax():
    'Value and gradient at the model against seeded observed data.'
    p, s = _pair('torch', _problem_config())
    _, _, dobs = _vectors(s.nD)
    ref = _jax_refs()
    f, g = p.misfit_and_gradient(_model(), dobs)
    assert abs(f - ref['misfit'][0]) / ref['misfit'][0] < 1e-6
    assert g.shape == (NZ * NX,) and _rel(g, ref['grad']) < 1e-6


def test_solve_25d_matches_jax_scan_path():
    '''
    nky 9, above the JAX package's scan threshold: the port's one loop
    against its lax.scan summation, on the same velocity and sources.
    '''
    sc = _problem_config(nky=9)
    pj, _ = _pair('jax', sc)
    pt, _ = _pair('torch', sc)
    qf = np.zeros((NZ * NX, 2), np.complex128)
    qf[16 * NX + 10, 0] = 1.
    qf[8 * NX + 20, 1] = 1.
    ci = pj.baseVelocity + 0j
    kw = pj._planeKwargs()
    solve = jax.jit(lambda c, rho, q: pj._solve_25d(c, rho, 180., q,
                                                    pj.solverConfig, kw))
    u_jax = np.asarray(solve(jnp.asarray(ci), jnp.ones((NZ, NX)),
                             jnp.asarray(qf)))           # (nrow, nsrc)
    u = pt._solve_25d(torch.from_numpy(ci), torch.ones((NZ, NX),
                                                       dtype=torch.float64),
                      180., torch.from_numpy(qf.T.reshape(2, 1, NZ, NX)),
                      pt.solverConfig, pt._planeKwargs())
    assert u.shape == (2, NZ, NX)
    assert _rel(u.numpy().reshape(2, -1).T, u_jax) < 1e-6


def test_disc_minizephyr25d_nky1_is_25d_as_in_jax():
    '''
    Disc=MiniZephyr25D with nky 1 is 2.5D in both packages: one ky = 0
    term scaled by exp(i pi) / 4 pi, i.e. -1/(4 pi) times the 2D data.
    '''
    sc = _problem_config(nky=1, Disc=jb.MiniZephyr25D, remDists=[])
    pj, _ = _pair('jax', sc)
    pt, _ = _pair('torch', sc)
    assert pj._discInfo()[1:] == pt._discInfo()[1:] == (False, False, True)
    with jax.ensure_compile_time_eval():
        d_jax = np.asarray(jax.jit(pj._dpred_fn())(
            jnp.asarray(pj.baseVelocity))).ravel()
    d = pt._dpred_fn()(pt._baseTensor()).numpy().ravel()
    assert _rel(d, d_jax) < 1e-6
    p2, _ = _pair('torch', _problem_config(nky=1, remDists=[]))
    assert not p2._discInfo()[3]
    d2 = p2._dpred_fn()(p2._baseTensor()).numpy().ravel()
    assert _rel(d, -d2 / (4 * np.pi)) < 1e-12


def test_helm25d_visco_problem_dpred_is_its_forward_map():
    '''
    Helm25DViscoProblem (Q 40, freqBase): survey.dpred() through the
    ViscoMultiFreq chain equals the problem's forward map, and the
    attenuation changes the data.
    '''
    sc = _problem_config(Q=40., freqBase=100.)
    p, s = _pair('torch', sc, problem='Helm25DViscoProblem')
    d = s.dpred()
    assert _rel(p._dpred_fn()(p._baseTensor()).numpy().ravel(), d) < 1e-6
    assert _rel(d, _torch_products()['dpred']) > 1e-3


def test_nested_distributor_chain_matches_jax():
    '''
    remDists chaining (reference distributors.py:38-53; mirrors
    tests/test_middleware.py:356-380): each frequency subproblem of the
    outer MultiFreq is a ky-summing MiniZephyr25D; both packages, the same
    chain, the same wavefields.
    '''
    sc = {'Disc': jb.MiniZephyr, 'nx': 30, 'nz': 24,
          'c': 2000. * np.ones((24, 30)), 'rho': 1., 'freqs': [60., 90.],
          'remDists': [jb.MiniZephyr25D], 'nky': 2, 'parallel': False,
          'cmin': 2000., 'solverOpts': {'tol': 1e-9, 'maxiter': 300}}
    q = np.zeros((24 * 30, 1), dtype=np.complex128)
    q[12 * 30 + 15] = 1.0
    outs = []
    for pkg, cfg in ((jb, sc), (tb, convert.system_config(sc,
                                                          device='cpu'))):
        outer = pkg.MultiFreq(cfg)
        subs = outer.subProblems
        assert all(isinstance(s, pkg.MiniZephyr25D) for s in subs)
        assert all(s.Disc is pkg.MiniZephyr for s in subs)
        fields = outer * q
        assert len(fields) == 2
        outs.append([np.asarray(u) for u in fields])
    for uj, ut in zip(*outs):
        assert ut.shape == (24 * 30, 1) and np.isfinite(ut).all()
        assert _rel(ut, uj) < 1e-6


def test_system_config_maps_2p5d_and_refuses_multigrid():
    '''
    convert.system_config carries MiniZephyr25D over; the 2.5D problem no
    longer raises, but on a MultiGrid survey it does, as in the JAX
    package.
    '''
    sc = convert.system_config(_problem_config(), device='cpu')
    assert sc['remDists'] == [tb.MiniZephyr25D]
    p = tm.Helm25DProblem(sc)
    assert p.SystemWrapper is tb.MultiFreq
    assert tm.Helm25DViscoProblem(sc).SystemWrapper is tb.ViscoMultiFreq
    s = tm.Helm25DMultiGridSurvey(dict(sc, cMin=2000., targetGPW=6.25))
    p.pair(s)
    with pytest.raises(NotImplementedError, match='scalar 2D'):
        p._dpred_fn()


@pytest.mark.slow
def test_compare_analytical_25d():
    '''
    The reference's 2.5D oracle (tests/test_minizephyr.py:88-115):
    MiniZephyr25D * q at 200x100, nky 20, against AnalyticalHelmholtz
    (3D), interior-window element-norm error below 1e-2.
    '''
    sc = {'c': 2500., 'rho': 1., 'nx': 100, 'nz': 200, 'freq': 2e2,
          'nky': 20, '3D': True, 'device': 'cpu'}
    sloc = np.array([25, 25]).reshape((1, 2))
    u = (tb.MiniZephyr25D(sc) * tb.SimpleSource(sc)(sloc)).ravel()
    uA = np.asarray(tb.AnalyticalHelmholtz(sc)(sloc))
    seg = (slice(40, 180), slice(40, 80))
    rel = ((uA.reshape(200, 100)[seg] - u.reshape(200, 100)[seg])
           / abs(uA.reshape(200, 100)[seg]))
    error = np.sqrt((rel.conj() * rel).sum()).real / rel.size
    assert error < 1e-2


def test_2p5d_entry_points_refuse_the_cpu_by_default(monkeypatch):
    '''
    Without a card, MiniZephyr25D and the 2.5D problem without a
    ``device`` key raise RuntimeError (nothing falls back to the CPU).
    '''
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    sc = _compat_config(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tb.MiniZephyr25D(sc) * tb.SimpleSource(sc)(np.array([[10., 12.]]))
    psc = convert.system_config(_problem_config(), device='cpu')
    del psc['device'], psc['dtype']
    p, s = tm.Helm25DProblem(psc), tm.Helm25DSurvey(psc)
    p.pair(s)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        s.dpred()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        p.Jtvec(v=np.ones(s.nD, complex))
