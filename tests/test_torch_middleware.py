'''
Port parity of the 2D inverse-problem layer: zephyr_tpu_torch.middleware
(surveys, Helm2DProblem and its visco and multigrid variants), the
MultiFreq distributors and the solve's forward-mode rule, against
zephyr_tpu on the same inputs, on the CPU in complex128, at 40x32 with 2
sources, 3 receivers and 2 frequencies, under the default config and the
production config (both cut to three multigrid levels by mg_min_size=10,
solves at tol 1e-10); plus the distributors' contracts and the host-only
modules the port copies. The visco problems and the Eurus problem's Jvec
are in tests/test_torch_middleware_visco.py, on these helpers (two files,
so that their JAX compiles run on separate test workers).

The JAX references go through the JAX problem's own forward map
(``_dpred_fn``): its data, ``jax.jvp`` for Jvec, ``jax.vjp`` of conj(w)
for Jtvec (``Jtvec``'s formula, problem.py:476-478), and for
misfit_and_gradient 0.5 ||r||^2 of the residual against seeded observed
data with the same VJP of r (the gradient of that objective,
problem.py:492-497). The map is compiled once per problem (``jax.jit``,
traced under ``ensure_compile_time_eval`` so that the visco transform's
host-side guard sees concrete values); eager JAX rebuilds every solve and
is no faster. For per-frequency grids the JAX distributor's data is the
reference of the port's survey.dpred(): the distributor resamples the
model with the spline interpolator, the forward map with the cubic
resampler.

Tolerances:
- survey source and receiver matrices: abs 1e-14 (the same host code);
- dpred, Jvec, Jtvec, misfit value and gradient: rel 1e-6 (both
  packages solve to tol 1e-10; the trajectories differ by rounding);
- the port's adjoint dot test |Re<w, Jv> - <J^T w, v>| / |Re<w, Jv>|:
  1e-8; one central difference of the port's misfit (eps 0.5 on a unit
  direction) within 1e-3 relative, as tests/test_middleware.py:122-141;
- distributor wavefields against the same solves run directly: 1e-12.
'''

import functools
import os
import threading
import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

import zephyr_tpu.backend as jb
import zephyr_tpu.middleware as jm
from zephyr_tpu_torch import convert
import zephyr_tpu_torch.backend as tb
import zephyr_tpu_torch.middleware as tm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NZ, NX = 40, 32
FREQS = [150., 220.]
SRC = np.array([[8., 8.], [22., 10.]])
REC = np.array([[6., 32.], [16., 33.], [26., 32.]])
OPTS = {
    'default': dict(tol=1e-10, mg_min_size=10),
    'production': dict(tol=1e-10, maxiter=2000, mg_coarse='inv',
                       mg_min_size=10, fft_mode='strat', fft_scale=2,
                       hybrid_comp='fused', mg_nu1=2, mg_nu2=1),
}
#: the problems held against the JAX package, each with its survey and
#: the extra config keys
PROBLEMS = {
    '2d': ('Helm2DProblem', 'Helm2DSurvey', {}),
    'visco': ('Helm2DViscoProblem', 'Helm2DSurvey',
              {'Q': 40., 'freqBase': 100.}),
    'visco_mg': ('Helm2DViscoMultiGridProblem', 'Helm2DMultiGridSurvey',
                 {'Q': 40., 'freqBase': 100., 'cMin': 2000.,
                  'targetGPW': 6.25, 'Disc': jb.MiniZephyrHD}),
}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel())


def _model():
    c = 2000. * np.ones((NZ, NX))
    c[20:30, 10:20] = 2200.
    return c


def _config(name='default', **kw):
    sc = {'Disc': jb.MiniZephyr, 'nx': NX, 'nz': NZ, 'dx': 1., 'dz': 1.,
          'c': _model(), 'rho': 1., 'freqs': list(FREQS),
          'geom': {'src': SRC.copy(), 'rec': REC.copy(), 'mode': 'fixed'},
          'nPML': 6, 'solverOpts': dict(OPTS[name])}
    sc.update(kw)
    return sc


def _pair(pkg, problem, survey, sc):
    if pkg == 'jax':
        p, s = getattr(jm, problem)(sc), getattr(jm, survey)(sc)
    else:
        sc = convert.system_config(sc, device='cpu')
        p, s = getattr(tm, problem)(sc), getattr(tm, survey)(sc)
    p.pair(s)
    return p, s


def _pair_both(kind, name):
    problem, survey, extra = PROBLEMS[kind]
    sc = _config(name, **extra)
    return (_pair('jax', problem, survey, dict(sc)),
            _pair('torch', problem, survey, dict(sc)))


def _vectors(nd):
    '''
    The seeded model perturbation v, data vector w, observed data dobs
    and unit direction dm of the tests.
    '''
    rng = np.random.default_rng(5)
    v = rng.standard_normal(NZ * NX)
    w = rng.standard_normal(nd) + 1j * rng.standard_normal(nd)
    dobs = 1e-3 * (rng.standard_normal(nd) + 1j * rng.standard_normal(nd))
    dm = rng.standard_normal(NZ * NX)
    return v, w, dobs, dm / np.linalg.norm(dm)


@functools.lru_cache(maxsize=None)
def _jax_refs(kind, name):
    '''
    The JAX package's data at c0, Jtvec(w), and for the 2D problem
    Jvec(v) and the misfit against dobs with its gradient, for one problem
    kind and config: one compiled program over the JAX problem's forward
    map.
    '''
    (p, s), _ = _pair_both(kind, name)
    v, w, dobs, _ = _vectors(s.nD)
    shape = (s.nrec, s.nsrc, s.nfreq)
    fwd = p._dpred_fn()

    def refs(c, v, w, dobs):
        d, vjp = jax.vjp(fwd, c)
        out = {'dpred': d, 'jtvec': jnp.real(vjp(jnp.conj(w))[0])}
        if kind == '2d':
            out['jvec'] = jax.jvp(fwd, (c,), (v,))[1]
            r = d - dobs
            out['misfit'] = 0.5 * jnp.sum(jnp.abs(r) ** 2)
            out['grad'] = jnp.real(vjp(jnp.conj(r))[0])
        return out

    with jax.ensure_compile_time_eval():
        out = jax.jit(refs)(jnp.asarray(p.baseVelocity),
                            jnp.asarray(v.reshape(NZ, NX)),
                            jnp.asarray(w.reshape(shape)),
                            jnp.asarray(dobs.reshape(shape)))
    out = {k: np.asarray(a).ravel() for k, a in out.items()}
    # through the distributor: per-frequency grids resample the model
    # with the spline interpolator there, with the cubic resampler in the
    # forward map, so the two data differ by the interpolation
    out['dpred_dist'] = s.dpred() if kind == 'visco_mg' else out['dpred']
    return out


@functools.lru_cache(maxsize=None)
def _torch_problem(kind, name):
    return _pair_both(kind, name)[1]


@functools.lru_cache(maxsize=None)
def _torch_product(kind, name, what):
    '''
    The port's survey.dpred() ('dpred'), Jvec(v) ('jvec') or Jtvec(w)
    ('jtvec') for one problem kind and config.
    '''
    p, s = _torch_problem(kind, name)
    v, w = _vectors(s.nD)[:2]
    if what == 'dpred':
        return s.dpred()
    return p.Jvec(v=v) if what == 'jvec' else p.Jtvec(v=w)


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    '''
    One torch thread for this module: at these sizes more threads are no
    faster, and the test workers share the machine's cores.
    '''
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the survey ------------------------------------------------------------

@pytest.mark.parametrize('mode', ['fixed', 'relative'])
def test_survey_vectors_match_jax(mode):
    'sVecs, rVec and getSources of both packages, within 1e-14.'
    geom = {'src': SRC.copy(), 'rec': REC - [0., 20.] if mode == 'relative'
            else REC.copy(), 'mode': mode}
    sc = _config(geom=geom, sterms=np.array([1. + 0.5j, 0.8 - 0.1j]))
    js, ts = jm.Helm2DSurvey(sc), tm.Helm2DSurvey(
        convert.system_config(sc, device='cpu'))

    def close(a, b):
        assert sp.issparse(a) and a.shape == b.shape
        assert abs(a - b).max() <= 1e-14

    close(ts.sVecs(), js.sVecs())
    for isrc in range(len(SRC)):
        close(ts.rVec(isrc), js.rVec(isrc))
    qt, qj = ts.getSources(), js.getSources()
    assert len(qt) == len(qj) == len(FREQS)
    for a, b in zip(qt, qj):
        close(a, b)
    assert ts.nD == js.nD == 2 * 3 * 2


def test_multigrid_survey_vectors_match_jax():
    'The per-frequency grids and their source and receiver matrices.'
    _, survey, extra = PROBLEMS['visco_mg']
    sc = _config(**extra)
    js, ts = jm.Helm2DMultiGridSurvey(sc), tm.Helm2DMultiGridSurvey(
        convert.system_config(sc, device='cpu'))
    assert ts.mgHelper.scales == js.mgHelper.scales
    assert len(set(ts.mgHelper.scales)) == 2
    for i in range(len(FREQS)):
        assert abs(ts.sVecs(i) - js.sVecs(i)).max() <= 1e-14
        assert abs(ts.rVec(0, i) - js.rVec(0, i)).max() <= 1e-14


# --- the 2D problems against the JAX package --------------------------------

@pytest.mark.parametrize('name', ['default', 'production'])
def test_dpred_matches_jax(name):
    '''
    survey.dpred() through the port's MultiFreq against the JAX
    package's data, and the port's differentiable forward map against it.
    '''
    p, s = _torch_problem('2d', name)
    ref = _jax_refs('2d', name)['dpred']
    d = _torch_product('2d', name, 'dpred')
    assert d.shape == (s.nD,) and d.dtype == np.complex128
    assert _rel(d, ref) < 1e-6
    d_fn = p._dpred_fn()(p._baseTensor())
    assert _rel(d_fn.numpy().ravel(), d) < 1e-6


@pytest.mark.parametrize('name', ['default', 'production'])
def test_jvec_matches_jax_jvp(name):
    jv = _torch_product('2d', name, 'jvec')
    assert jv.dtype == np.complex128 and jv.shape == (2 * 3 * 2,)
    assert _rel(jv, _jax_refs('2d', name)['jvec']) < 1e-6


@pytest.mark.parametrize('name', ['default', 'production'])
def test_jtvec_matches_jax_vjp(name):
    jt = _torch_product('2d', name, 'jtvec')
    assert jt.dtype == np.float64 and jt.shape == (NZ * NX,)
    assert _rel(jt, _jax_refs('2d', name)['jtvec']) < 1e-6


@pytest.mark.parametrize('name', ['default', 'production'])
def test_adjoint_dot_test(name):
    'The port alone: Re<w, J v> == <J^T w, v> to 1e-8.'
    v, w = _vectors(2 * 3 * 2)[:2]
    lhs = np.real(np.vdot(w, _torch_product('2d', name, 'jvec')))
    rhs = float(np.dot(_torch_product('2d', name, 'jtvec'), v))
    assert abs(lhs - rhs) / abs(lhs) < 1e-8


@pytest.mark.parametrize('name', ['default', 'production'])
def test_misfit_and_gradient_match_jax(name):
    '''
    Value and gradient at c0 against seeded observed data, against the
    JAX package's; then one central difference of the port's misfit.
    '''
    p, s = _torch_problem('2d', name)
    ref = _jax_refs('2d', name)
    _, _, dobs, dm = _vectors(s.nD)
    f, g = p.misfit_and_gradient(_model(), dobs)
    assert f > 0 and np.isfinite(g).all()
    assert abs(f - ref['misfit'][0]) / ref['misfit'][0] < 1e-6
    assert _rel(g, ref['grad']) < 1e-6
    eps = 0.5
    fwd = p._dpred_fn()

    def misfit(c):
        with torch.no_grad():
            r = fwd(torch.from_numpy(c)).numpy().ravel() - dobs
        return 0.5 * float(np.sum(np.abs(r) ** 2))

    fd = (misfit(_model() + eps * dm.reshape(NZ, NX))
          - misfit(_model() - eps * dm.reshape(NZ, NX))) / (2 * eps)
    assert abs(fd - float(np.dot(g, dm))) / abs(fd) < 1e-3


# --- the distributors, the cache and the problem's guards -------------------

def test_lazy_fields_contract(monkeypatch):
    '''
    MultiFreq * q is a LazyFields: len without solving, nothing solved
    before a field is consumed, indexing and re-iteration solve again
    (nothing cached), each entry the subproblem's own solve.
    '''
    sc = convert.system_config(_config(), device='cpu')
    mf = tb.MultiFreq(sc)
    calls = []
    orig = tb.BaseDiscretization._dispatch_rhs

    def counting(self, rhs):
        calls.append(float(np.real(self.freq)))
        return orig(self, rhs)

    monkeypatch.setattr(tb.BaseDiscretization, '_dispatch_rhs', counting)
    q = tb.SparseKaiserSource(sc)(SRC)
    fields = mf * q
    assert isinstance(fields, tb.distributors.LazyFields)
    assert len(fields) == 2 and calls == []
    u1 = fields[1]
    assert calls == [FREQS[1]] and u1.shape == (NZ * NX, 2)
    first = list(fields)
    second = list(fields)
    assert calls == [FREQS[1]] + FREQS + FREQS
    assert np.array_equal(first[1], u1) and np.array_equal(second[0],
                                                           first[0])
    assert fields[0:2][1].shape == u1.shape
    assert _rel(first[0], mf.subProblems[0] * q) < 1e-12


def test_parallel_dispatch_runs_every_solve_at_once(monkeypatch):
    '''
    With more than one worker the distributor starts every plain solve
    at once, one thread a subproblem, before any field is consumed; the
    LazyFields collects them, equal to the serial path's wavefields.
    '''
    sc = convert.system_config(_config(), device='cpu')
    q = tb.SparseKaiserSource(sc)(SRC)
    serial = list(tb.MultiFreq(dict(sc, parallel=False)) * q)
    monkeypatch.setattr(tb.BaseMPDist, 'nWorkers', property(lambda s: 2))
    threads = []
    orig = tb.BaseDiscretization._dispatch_rhs

    def recording(self, rhs):
        threads.append(threading.current_thread())
        return orig(self, rhs)

    monkeypatch.setattr(tb.BaseDiscretization, '_dispatch_rhs', recording)
    fields = tb.MultiFreq(sc) * q
    deadline = time.monotonic() + 120
    while len(threads) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(threads) == 2
    assert threading.main_thread() not in threads
    for a, b in zip(fields, serial):
        assert _rel(a, b) < 1e-12
    assert len(threads) == 2


def test_nested_distributor_chain_matches_jax():
    '''
    remDists chaining (reference distributors.py:38-53): the outer
    MultiFreq pops the next distributor off the chain, so each frequency
    subproblem is itself a distributor wrapping the leaf discretization;
    both packages, the same chain (a premul split defined here for each).
    '''

    def splitter(base):
        class PremulSplit(base):
            @property
            def spUpdates(self):
                return [dict(self.addFields, premul=p) for p in (1., 0.5j)]
        return PremulSplit

    sc = dict(_config(), remDists=[splitter(jb.BaseMPDist)],
              parallel=False)
    tsc = dict(convert.system_config(dict(sc, remDists=[]), device='cpu'),
               remDists=[splitter(tb.BaseMPDist)])
    q = np.zeros((NZ * NX, 1), complex)
    q[20 * NX + 16] = 1.
    outs = []
    for pkg, cfg in ((jb, sc), (tb, tsc)):
        outer = pkg.MultiFreq(cfg)
        subs = outer.subProblems
        assert [type(s).__name__ for s in subs] == ['PremulSplit'] * 2
        assert all(s.Disc is pkg.MiniZephyr for s in subs)
        fields = outer * q
        assert len(fields) == 2 and all(len(f) == 2 for f in fields)
        outs.append([[np.asarray(u) for u in f] for f in fields])
    for fj, ft in zip(*outs):
        for uj, ut in zip(fj, ft):
            assert ut.shape == (NZ * NX, 1) and _rel(ut, uj) < 1e-6
        # the FT convention conjugates (A^-1 premul q)
        assert _rel(ft[1], -0.5j * ft[0]) < 1e-12


def test_update_model_guard_and_dpred_fn_rebuild():
    '''
    updateModel clears the caches only when the model moves by more than
    EPS; _dpred_fn is kept while the survey is unchanged and rebuilt
    after a re-pairing with another geometry (tests/test_multigrid_freq.
    py:139).
    '''
    p, s = _pair('torch', 'Helm2DProblem', 'Helm2DSurvey', _config())
    system = p.system
    fn = p._dpred_fn()
    p.updateModel(_model() + 1e-17)
    assert p.system is system and p._dpred_fn() is fn
    p.updateModel(_model() + 1.)
    assert p.system is not system and p._dpred_fn() is not fn
    fn = p._dpred_fn()
    s2 = tm.Helm2DSurvey(convert.system_config(
        _config(geom={'src': np.array([[12., 14.]]), 'rec': REC[:2],
                      'mode': 'fixed'}), device='cpu'))
    p.pair(s2)
    assert p._dpred_fn() is not fn
    with pytest.raises(TypeError):
        p.updateModel('c')


def test_25d_problems_and_unported_classes_raise():
    sc = convert.system_config(_config(), device='cpu')
    for cls in (tm.Helm25DProblem, tm.Helm25DViscoProblem):
        with pytest.raises(NotImplementedError, match='item 13'):
            cls(sc)
    with pytest.raises(NotImplementedError, match='item 13'):
        convert.system_config(dict(_config(), remDists=[jb.MiniZephyr25D]),
                              device='cpu')


def test_system_config_carries_the_classes():
    sc = _config(SystemWrapper=jb.ViscoMultiFreq, remDists=[jb.MultiFreq])
    sc['geom'] = dict(sc['geom'], GeneratorClass=jb.KaiserSource)
    out = convert.system_config(sc, device='cpu')
    assert out['Disc'] is tb.MiniZephyr
    assert out['SystemWrapper'] is tb.ViscoMultiFreq
    assert out['remDists'] == [tb.MultiFreq]
    assert out['geom']['GeneratorClass'] is tb.KaiserSource
    assert out['device'] == 'cpu' and out['dtype'] == torch.complex128
    assert sc['Disc'] is jb.MiniZephyr and 'device' not in sc
    assert convert.system_config(sc, device='cpu',
                                 dtype='complex64')['dtype'] \
        == torch.complex64


def test_sources_match_jax():
    'FakeSource and KaiserSource (dense) of both packages.'
    sc = _config()
    loc = np.array([[10.3, 7.5], [20., 30.2]])
    assert tb.FakeSource(sc)(loc) is loc
    kt, kj = tb.KaiserSource(sc)(loc), jb.KaiserSource(sc)(loc)
    assert isinstance(kt, np.ndarray) and kt.shape == (NZ * NX, 2)
    assert np.abs(kt - kj).max() <= 1e-14


def test_new_entry_points_default_to_the_card():
    '''
    The problem, the distributor and system_config run on the card unless
    'cpu' is asked for; without a card they raise (no quiet fallback).
    '''
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default runs there')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.system_config(_config())
    tsc = dict(_config(), Disc=tb.MiniZephyr)
    tp = tm.Helm2DProblem(tsc)
    tp.pair(tm.Helm2DSurvey(tsc))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.Jvec(v=np.ones(NZ * NX))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tb.MultiFreq(tsc).nWorkers


# --- the copied host-only modules --------------------------------------------

def test_mesh_and_maps_match_jax():
    mt, mj = tm.TensorMesh2D(NX, NZ), jm.TensorMesh2D(NX, NZ)
    assert (mt.nN, mt.nC) == (mj.nN, mj.nC)
    assert abs(mt.aveN2CC - mj.aveN2CC).max() == 0
    rng = np.random.default_rng(1)
    vec = 1500. + rng.uniform(0., 500., mt.nN)
    for name in ('NodalIdentityMap', 'SquaredSlownessMap'):
        a, b = getattr(tm, name)(mt), getattr(jm, name)(mj)
        assert np.array_equal(a * vec, b * vec)
    assert np.array_equal(tm.IdentityMap(mt) * vec, vec)


def test_fields_alias_machinery():
    '''
    Alias fields (reference fields.py:50-117): a declared alias reads as
    func(stored panels) per frequency and is read-only.
    '''

    class Mesh:
        nN = 6

    class Survey:
        nSrc = 2
        nfreq = 3
        srcList = ['s0', 's1']

    class AliasedFields(tm.HelmFields):
        aliasFields = {'phi': ('u', 'N', '_phi')}

        def _phi(self, u, srcs, ifreq):
            return (int(ifreq) + 1.0) * u

    f = AliasedFields(Mesh(), Survey())
    rng = np.random.default_rng(0)
    data = rng.standard_normal((6, 2, 3)) \
        + 1j * rng.standard_normal((6, 2, 3))
    f[:, 'u', :] = data
    assert np.allclose(f[:, 'u', :], data)
    assert np.allclose(f[:, 'phi', 1], 2.0 * data[:, :, 1])
    expected = np.stack([(i + 1.0) * data[:, :, i] for i in range(3)],
                        axis=2)
    assert np.allclose(f[:, 'phi', :], expected)
    assert np.allclose(f['s1', 'phi', 0].ravel(), data[:, 1, 0])
    with pytest.raises(KeyError):
        f[:, 'phi', 0] = 0.


def test_time_dft_roundtrip():
    rng = np.random.default_rng(3)
    ns = 64
    a = rng.standard_normal((2, ns))
    tmc = tm.TimeMachine({'freqs': list(np.arange(1, ns // 2 + 1))})
    A = tmc.dft(a)
    assert A.shape == (2, ns)
    a2 = tmc.idft(A[:, 1:ns // 2 + 1])
    assert np.allclose(a2, a - a.mean(axis=1, keepdims=True), atol=1e-10)
    assert np.array_equal(A, jm.TimeMachine({'freqs': list(
        np.arange(1, ns // 2 + 1))}).dft(a))


@pytest.mark.parametrize('fmt', [1, 5])
def test_segy_roundtrip(tmp_path, fmt):
    'The port\'s SEG-Y writer and reader (IBM and IEEE), read by both.'
    rng = np.random.default_rng(fmt)
    traces = (rng.standard_normal((7, 120)) * 1000).astype(np.float32)
    fn = str(tmp_path / 'port.sgy')
    tm.writeSEGY(fn, traces, format=fmt)
    sf = tm.SEGYFile(fn)
    assert (sf.ntr, sf.ns, sf.format) == (7, 120, fmt)
    assert np.allclose(sf[:], traces, rtol=1e-6, atol=1e-6)
    assert np.array_equal(sf[:], jm.SEGYFile(fn)[:])
    assert np.allclose(sf[2], traces[2], rtol=1e-6, atol=1e-6)


def test_segy_native_builds_its_own_library():
    '''
    The port's native codec builds under build/ with its own name (not
    the JAX package's native/libsegy_codec.so), or is absent: then
    decode_traces returns None and SEG-Y decodes in numpy.
    '''
    from zephyr_tpu_torch.middleware import segy_native
    assert segy_native._OUT.startswith(os.path.join(REPO, 'build'))
    assert os.path.basename(segy_native._OUT) != 'libsegy_codec.so'
    lib = segy_native.load()
    # two traces of one IEEE sample, each behind its 240-byte header
    payload = (b'\x00' * 240 + np.array([1.5], '>f4').tobytes()) * 2
    out = segy_native.decode_traces(payload, 2, 1, 5, True)
    if lib is None:
        assert out is None
    else:
        assert np.array_equal(out, [[1.5], [1.5]])
