'''
Port parity of TTI (Eurus 2x2 block) gradients: the reverse mode of the
block solve in zephyr_tpu_torch against zephyr_tpu on the same inputs, on
the CPU in complex128, at 24x20 (three multigrid levels by
mg_min_size=8), layered or boxed models, theta 0.3, eps 0.2, delta 0.1.

The JAX references are built once per module (module-scoped fixtures):
the JAX package's operators prepared ``with_transpose=True`` under the
default hybrid config (line-smoothed V-cycle) and under ``precond='mg',
mg_smoother='jacobi'``, with their transpose preconditioners applied to a
seeded residual batch; ``jax.value_and_grad`` of a TTI receiver misfit
through ``multifreq_dpred(eurus_params=...)``; and the Eurus
Helm2DProblem's data, Jtvec and misfit gradient from one compiled
``jax.vjp`` of its forward map.

Tolerances (relative, 2-norm, each test states its own):
- block plane products against ``jax.vjp`` of ``apply_block_stencil``:
  1e-12 (the same sums);
- the transposed block family and ``stratified_apply_block(transpose=
  True)`` against the JAX package's on the same ``ldu``: 1e-12 (the same
  reduction; the port runs it once, JAX on every application);
- the transposed hierarchy (levels, line states, coarse solve) and the
  B=2 transpose preconditioner of a JAX operator carried over by
  ``convert.operator_from_numpy``: 1e-10 (the block PCR's clamped
  inverses amplify complex128 rounding, as in tests/test_torch_eurus.py);
- gradients, Jtvec and misfits: 1e-6 (both packages solve to tol 1e-10;
  the trajectories differ by rounding); the port's adjoint dot test
  1e-8.
'''

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import zephyr_tpu.backend as jb
from zephyr_tpu.ops import stencil as jst
from zephyr_tpu.ops.eurus_coeff import eurus_planes as jplanes
from zephyr_tpu.parallel import multifreq as jmf
from zephyr_tpu.solver import helmholtz as jh
from zephyr_tpu.solver import stratified as jsr
from zephyr_tpu_torch import convert
from zephyr_tpu_torch.ops import stencil as tst
from zephyr_tpu_torch.parallel import multifreq as tmf
from zephyr_tpu_torch.solver import helmholtz as th
from zephyr_tpu_torch.solver import multigrid as tmg
from zephyr_tpu_torch.solver import stratified as tsr
# _one_thread is the shared module's autouse fixture: importing it applies
# it here too
from test_torch_middleware import _config, _one_thread, _pair  # noqa: F401

NZ, NX, FREQ, NPML = 24, 20, 200., 6
ANISO = dict(theta=0.3, eps=0.2, delta=0.1)
CONFIGS = {
    'hybrid': dict(tol=1e-10, maxiter=600, mg_min_size=8),
    'mg_jacobi': dict(tol=1e-10, maxiter=600, mg_min_size=8, precond='mg',
                      mg_smoother='jacobi', mg_coarse='inv'),
}


def _rel(a, b):
    a, b = (np.asarray(v.detach() if torch.is_tensor(v) else v)
            for v in (a, b))
    return np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel())


def _rand(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _model(medium='layered'):
    c = np.full((NZ, NX), 2000.)
    if medium == 'layered':
        c[NZ // 2:] = 2300.
    elif medium == 'box':
        c[8:16, 6:14] = 2200.
    return c


def _aniso():
    return {k: v * np.ones((NZ, NX)) for k, v in ANISO.items()}


@functools.lru_cache(maxsize=None)
def _plane_pair(medium):
    '(true, shifted) Eurus planes as numpy complex128, from the JAX package.'
    c = jnp.asarray(_model(medium) + 0j)
    rho = jnp.ones((NZ, NX))
    kw = dict(**_aniso(), nPML=NPML, cPML=1e3)
    return (np.array(jplanes(c, rho, FREQ, **kw)),
            np.array(jplanes(jh.shifted_velocity(c, 0.5j), rho, FREQ,
                             pml_cap=1.0, **kw)))


# --- module 1: block plane products ----------------------------------------

def test_block_plane_products_match_jax_vjp():
    '''
    d Re sum_r <w_r, A x_r> / d planes (no conjugation: the bilinear
    pairing) against jax.vjp of the JAX apply_block_stencil, 1e-12; at B=1
    the block products are the scalar ``plane_products``.
    '''
    rng = np.random.default_rng(0)
    planes = _rand(rng, 2, 2, 9, NZ, NX)
    w, x = _rand(rng, 3, 2, NZ, NX), _rand(rng, 3, 2, NZ, NX)
    _, vjp = jax.vjp(lambda p: jax.vmap(
        lambda u: jst.apply_block_stencil(p, u))(jnp.asarray(x)),
        jnp.asarray(planes))
    # jax.vjp pairs without conjugation: the cotangent w gives sum w A x
    ref, = vjp(jnp.asarray(w))
    g = tst.block_plane_products(torch.from_numpy(w), torch.from_numpy(x))
    assert g.shape == (2, 2, 9, NZ, NX)
    assert _rel(g, ref) < 1e-12
    g1 = tst.block_plane_products(torch.from_numpy(w[:, :1]),
                                  torch.from_numpy(x[:, :1]))
    assert torch.equal(g1[0, 0], tst.plane_products(
        torch.from_numpy(w[:, 0]), torch.from_numpy(x[:, 0])))


# --- module 2: the transposed block family ----------------------------------

@pytest.mark.parametrize('medium', ['hom', 'layered'])
def test_transposed_block_family_matches_jax(medium):
    '''
    transpose_strat_block / transpose_pcr_block on the ldu of the block
    stratified coefficients, and the transposed block apply, against the
    JAX package's (which reduces the transposed family on every call),
    1e-12; P^T is the algebraic (bilinear) transpose of P.
    '''
    p, pp = _plane_pair(medium)
    ldu = jsr.stratified_coeffs_block(jnp.asarray(p), jnp.asarray(pp),
                                      0.5j, 'auto')
    s_j = jsr.pcr_precompute_block(*ldu)
    s_t = convert._block_pcr_from_numpy(
        jax.tree.map(np.asarray, s_j), 'cpu')
    for a_t, a_j in zip(tsr.transpose_strat_block(s_t.ldu),
                        jsr.transpose_strat_block(s_j.ldu)):
        assert _rel(a_t, a_j) < 1e-12
    sT = tsr.transpose_pcr_block(s_t)
    assert sT.alphas.dtype == torch.complex128
    rng = np.random.default_rng(1)
    r, s = _rand(rng, 2, 2, NZ, NX), _rand(rng, 2, 2, NZ, NX)
    x_j = jsr.stratified_apply_block(s_j, jnp.asarray(r), transpose=True)
    x_t = tsr.stratified_apply_block(sT, torch.from_numpy(r),
                                     transpose=True)
    assert _rel(x_t, x_j) < 1e-12
    Ps = tsr.stratified_apply_block(s_t, torch.from_numpy(s)).numpy()
    lhs, rhs = np.sum(s * x_t.numpy()), np.sum(Ps * r)
    assert abs(lhs - rhs) / abs(lhs) < 1e-12


def test_transposed_block_family_complex64_is_full_precision():
    '''
    A complex64 block state (bf16 factors) reduces its transposed family
    from ldu in complex64, unpacked, as the JAX package's transpose solve
    does; its transposed apply is within 1e-5 of the JAX package's.
    '''
    p, pp = (a.astype(np.complex64) for a in _plane_pair('layered'))
    ldu = jsr.stratified_coeffs_block(jnp.asarray(p), jnp.asarray(pp),
                                      0.5j, 'auto')
    s_j = jsr.pcr_precompute_block(*ldu)
    s_t = convert._block_pcr_from_numpy(
        jax.tree.map(np.asarray, s_j), 'cpu')
    assert s_t.alphas.dtype == torch.bfloat16
    sT = tsr.transpose_pcr_block(s_t)
    assert sT.alphas.dtype == sT.dinv.dtype == torch.complex64
    r = _rand(np.random.default_rng(2), 2, 2, NZ, NX).astype(np.complex64)
    x_j = jsr.stratified_apply_block(s_j, jnp.asarray(r), transpose=True)
    x_t = tsr.stratified_apply_block(sT, torch.from_numpy(r),
                                     transpose=True)
    assert _rel(x_t, x_j) < 1e-5


# --- modules 3, 4, 7: the transposed hierarchy and preconditioner -----------

@pytest.fixture(scope='module')
def jax_ops():
    '''
    Per config: the JAX package's TTI operator on the layered model,
    prepared with_transpose=True (one compiled preparation), carried to
    the port by convert.operator_from_numpy, and the JAX transpose
    preconditioner applied to a seeded residual batch (R=2).
    '''
    p, pp = _plane_pair('layered')
    r = _rand(np.random.default_rng(3), 2, 2, NZ, NX)
    out = {}
    for name, opts in CONFIGS.items():
        cfg = jh.SolverConfig(**opts)
        op = jax.jit(lambda a, b: jh.prepare_operator(
            a, b, cfg, with_transpose=True))(jnp.asarray(p), jnp.asarray(pp))
        mt = jax.jit(jax.vmap(jh._make_precond(op, cfg, transpose=True)))(
            jnp.asarray(r))
        tree = jax.tree.map(np.asarray, op)
        out[name] = (tree, convert.operator_from_numpy(tree, device='cpu'),
                     r, np.asarray(mt))
    return out


@pytest.mark.parametrize('name', list(CONFIGS))
def test_eurus_operator_with_transpose_round_trips(jax_ops, name):
    '''
    convert.operator_from_numpy of a JAX Eurus operator prepared
    with_transpose=True: the transposed planes and every transposed level
    bit for bit, line states included (the hybrid config's).
    '''
    tree, op, _, _ = jax_ops[name]
    assert op.hierT is not None
    assert len(op.hierT.levels) == len(tree.hierT.levels) == 3
    if name == 'hybrid':
        assert np.array_equal(op.planesT.numpy(), tree.planesT)
        assert op.strat.ldu.shape == (3, 2, 2, NZ, NX)
    else:
        assert op.planesT is None and op.strat is None
    for lt, lj in zip(op.hierT.levels, tree.hierT.levels):
        assert np.array_equal(lt.planes.numpy(), lj.planes)
        assert (lt.linez is None) == (lj.linez is None) == (name != 'hybrid')
        if lt.linez is not None:
            for st, sj in ((lt.linez, lj.linez), (lt.linex, lj.linex)):
                for a_t, a_j in zip(st, sj):
                    assert np.array_equal(a_t.numpy(), a_j)


@pytest.mark.parametrize('name', list(CONFIGS))
def test_transpose_hierarchy_matches_jax(jax_ops, name):
    '''
    The port's transpose_hierarchy of the carried forward hierarchy
    against the JAX operator's hierT: level planes, block-diagonal
    inverses and line states within 1e-10, the coarse solve ('lu'
    refactorized, 'inv' transposed) within 1e-10.
    '''
    _, op, _, _ = jax_ops[name]
    hT = tmg.transpose_hierarchy(op.hier)
    for lt, lj in zip(hT.levels, op.hierT.levels):
        assert _rel(lt.planes, lj.planes) < 1e-12
        assert _rel(lt.dinv, lj.dinv) < 1e-10
        if lj.linez is not None:
            for st, sj in ((lt.linez, lj.linez), (lt.linex, lj.linex)):
                for a_t, a_j in zip(st, sj):
                    assert _rel(a_t, a_j) < 1e-10
    nzc, nxc = hT.levels[-1].planes.shape[-2:]
    b = torch.from_numpy(_rand(np.random.default_rng(4), 2, 2, nzc, nxc))
    assert _rel(tmg._coarse_solve(hT, b), tmg._coarse_solve(op.hierT, b)) \
        < 1e-10


@pytest.mark.parametrize('name', list(CONFIGS))
def test_block_transpose_preconditioner_matches_jax(jax_ops, name):
    '''
    _make_precond(op, cfg, transpose=True) for B=2 on the carried
    operator against the JAX package's on the same residual batch, 1e-10:
    the default hybrid config (P^T + V^T (I - A^T P^T) with the
    transposed line-smoothed V-cycle) and the plain block-Jacobi V-cycle.
    '''
    _, op, r, ref = jax_ops[name]
    cfg = th.SolverConfig(**CONFIGS[name])
    out = th._make_precond(op, cfg, transpose=True)(torch.from_numpy(r))
    assert _rel(out, ref) < 1e-10


# --- module 5: the TTI data map under autograd ------------------------------

def _misfit_inputs():
    '''
    Two point sources (nfreq 1), a receiver matrix with three two-tap
    receivers, seeded observed data.
    '''
    q = np.zeros((1, 2, NZ, NX), np.complex128)
    q[0, 0, 10, 8] = q[0, 1, 5, 12] = 1.
    R = np.zeros((3, NZ * NX), np.complex128)
    for i, (z, x) in enumerate(((6, 14), (16, 14), (20, 5))):
        R[i, z * NX + x], R[i, z * NX + x + 1] = 0.7, 0.3
    rng = np.random.default_rng(6)
    dobs = 1e-3 * _rand(rng, 1, 2, 3)
    return q, R, dobs


@pytest.fixture(scope='module')
def jax_tti_grad():
    '''
    jax.value_and_grad of 0.5 ||multifreq_dpred(c, eurus_params) - dobs||^2
    at the boxed model, the default hybrid config: one compile.
    '''
    q, R, dobs = _misfit_inputs()
    cfg = jh.SolverConfig(**CONFIGS['hybrid'])
    aniso = {k: jnp.asarray(v) for k, v in _aniso().items()}

    def misfit(c):
        d = jmf.multifreq_dpred(c + 0j, jnp.ones((NZ, NX)), jnp.asarray(
            [FREQ]), jnp.asarray(q), jnp.asarray(R), config=cfg,
            eurus_params=dict(aniso, cPML=1e3), nPML=NPML)
        return 0.5 * jnp.sum(jnp.abs(d - jnp.asarray(dobs)) ** 2)

    f, g = jax.jit(jax.value_and_grad(misfit))(jnp.asarray(_model('box')))
    return float(f), np.asarray(g)


def test_tti_misfit_gradient_matches_jax_grad(jax_tti_grad):
    '''
    The torch autograd gradient of the TTI receiver misfit through
    fwi_misfit (multifreq_dpred with eurus_params: GMRES forward and
    transpose solves, the block hybrid preconditioner and its transpose)
    against jax.grad, rel 1e-6; the operators carry their transposed
    parts only while a gradient can be asked for.
    '''
    f_ref, g_ref = jax_tti_grad
    q, R, dobs = _misfit_inputs()
    kw = dict(config=th.SolverConfig(**CONFIGS['hybrid']),
              eurus_params=dict(_aniso(), cPML=1e3), device='cpu',
              nPML=NPML)
    ct = torch.tensor(_model('box'), requires_grad=True)
    f = tmf.fwi_misfit(ct, dobs, np.ones((NZ, NX)), [FREQ], q, R, **kw)
    g, = torch.autograd.grad(f, ct)
    assert abs(float(f.detach()) - f_ref) / f_ref < 1e-6
    assert g.shape == (NZ, NX) and bool(torch.isfinite(g).all())
    assert _rel(g, g_ref) < 1e-6
    ops = tmf.build_multifreq_ops(ct, np.ones((NZ, NX)), [FREQ],
                                  kw['config'],
                                  eurus_params=kw['eurus_params'],
                                  device='cpu', nPML=NPML)
    assert ops[0].hierT is not None and ops[0].planesT is not None
    with torch.no_grad():
        ops = tmf.build_multifreq_ops(ct, np.ones((NZ, NX)), [FREQ],
                                      kw['config'],
                                      eurus_params=kw['eurus_params'],
                                      device='cpu', nPML=NPML)
    assert ops[0].hierT is None and ops[0].planesT is None


# --- module 6: the Eurus problem's reverse mode -----------------------------

def _eurus_sc():
    c = np.full((NZ, NX), 2000.)
    c[8:16, 6:14] = 2150.
    return _config(nz=NZ, nx=NX, c=c, Disc=jb.Eurus,
                   theta=0.1 * np.ones((NZ, NX)),
                   eps=0.1 * np.ones((NZ, NX)),
                   delta=0.05 * np.ones((NZ, NX)), cPML=1e3, nPML=4,
                   freqs=[150.],
                   geom={'src': np.array([[6., 6.], [14., 8.]]),
                         'rec': np.array([[4., 18.], [10., 18.],
                                          [16., 18.]]),
                         'mode': 'fixed'},
                   solverOpts=dict(CONFIGS['mg_jacobi']))


def _problem_vectors(nd):
    rng = np.random.default_rng(8)
    v = rng.standard_normal(NZ * NX)
    w = rng.standard_normal(nd) + 1j * rng.standard_normal(nd)
    dobs = 1e-3 * (rng.standard_normal(nd) + 1j * rng.standard_normal(nd))
    return v, w, dobs


@pytest.fixture(scope='module')
def eurus_problems():
    '''
    The paired Eurus Helm2DProblem of both packages (the block-Jacobi
    V-cycle keeps the JAX side quick to build), and the JAX problem's
    Jtvec(w), misfit and gradient against seeded observed data from one
    compiled jax.vjp of its forward map.
    '''
    jp, js = _pair('jax', 'Helm2DProblem', 'Helm2DSurvey', _eurus_sc())
    tp, ts = _pair('torch', 'Helm2DProblem', 'Helm2DSurvey', _eurus_sc())
    _, w, dobs = _problem_vectors(ts.nD)
    shape = (js.nrec, js.nsrc, js.nfreq)
    fwd = jp._dpred_fn()

    def refs(c, w, dobs):
        d, vjp = jax.vjp(fwd, c)
        r = d - dobs
        return {'jtvec': jnp.real(vjp(jnp.conj(w))[0]),
                'misfit': 0.5 * jnp.sum(jnp.abs(r) ** 2),
                'grad': jnp.real(vjp(jnp.conj(r))[0])}

    with jax.ensure_compile_time_eval():
        out = jax.jit(refs)(jnp.asarray(jp.baseVelocity),
                            jnp.asarray(w.reshape(shape)),
                            jnp.asarray(dobs.reshape(shape)))
    return tp, ts, {k: np.asarray(a).ravel() for k, a in out.items()}


def test_eurus_problem_jtvec_matches_jax(eurus_problems):
    '''
    The Eurus Helm2DProblem's Jtvec (the block solve's backward: one
    GMRES transpose solve a frequency) against the JAX problem's VJP, rel
    1e-6, and the port's adjoint dot test against its own Jvec, 1e-8.
    '''
    tp, ts, ref = eurus_problems
    v, w, _ = _problem_vectors(ts.nD)
    jt = tp.Jtvec(v=w)
    assert jt.dtype == np.float64 and jt.shape == (NZ * NX,)
    assert _rel(jt, ref['jtvec']) < 1e-6
    lhs = np.real(np.vdot(w, tp.Jvec(v=v)))
    assert abs(lhs - np.dot(jt, v)) / abs(lhs) < 1e-8


def test_eurus_problem_misfit_and_gradient_matches_jax(eurus_problems):
    '''
    misfit_and_gradient of the Eurus problem against the JAX problem's
    0.5 ||d - dobs||^2 and its VJP, rel 1e-6.
    '''
    tp, ts, ref = eurus_problems
    _, _, dobs = _problem_vectors(ts.nD)
    f, g = tp.misfit_and_gradient(tp.baseVelocity.ravel(), dobs)
    assert abs(f - float(ref['misfit'][0])) / float(ref['misfit'][0]) \
        < 1e-6
    assert np.isfinite(g).all() and _rel(g, ref['grad']) < 1e-6


# --- fault F8: the tangent solve in complex64 --------------------------------

@pytest.mark.slow
def test_eurus_tangent_stall_matches_jax(capsys):
    '''
    Fault F8: on a 64^2 `eurus`-row operator (c 1500, theta 0.3, eps 0.2,
    delta 0.1, freq 1500/16, the bench's TTI solver options at
    mg_min_size 16 and maxiter 600), the tangent right-hand side of a
    Jvec, -dA x for a smooth seeded direction, stalls GMRES(20) above tol
    1e-5 in complex64 in the JAX package on XLA:CPU and in the port
    alike, while in complex128 both converge, so the stall is float32
    rounding in the method, not the port. Iterations and relres printed.
    '''
    import torch.autograd.forward_ad as fwAD
    from zephyr_tpu_torch.ops.eurus_coeff import eurus_planes as tplanes
    n, freq = 64, 1500. / 16
    opts = dict(tol=1e-5, maxiter=600, mg_coarse='inv', mg_min_size=16,
                fft_mode='strat', fft_scale=2, hybrid_comp='fused',
                mg_nu1=1, mg_nu2=1, gmres_restart=20)
    rng = np.random.default_rng(17)
    v = rng.standard_normal((n, n))
    for ax in (0, 1):
        v = np.apply_along_axis(np.convolve, ax, v, np.ones(9) / 9, 'same')
    aniso = {k: val * np.ones((n, n)) for k, val in ANISO.items()}
    one = np.ones((n, n))
    b = np.zeros((4, 2, n, n), complex)
    for i, (z, x) in enumerate(((12, 20), (30, 44), (50, 16), (40, 30))):
        b[i, 0, z, x] = 1.
    # the tangent right-hand side in complex128: -dA x, x to tol 1e-10
    cfg128 = th.SolverConfig(**dict(opts, tol=1e-10))
    ct = torch.full((n, n), 1500. + 0j, dtype=torch.complex128)
    tan = {k: torch.from_numpy(a) for k, a in aniso.items()}
    pp = tplanes(th.shifted_velocity(ct, 0.5j), torch.from_numpy(one), freq,
                 pml_cap=1.0, **tan)
    with fwAD.dual_level():
        dual = tplanes(fwAD.make_dual(ct, torch.from_numpy(v + 0j)),
                       torch.from_numpy(one), freq, **tan)
        p, dp = fwAD.unpack_dual(dual)
    op = th.prepare_operator(p, pp, cfg128, with_transpose=False)
    x = th.solve_info(op, torch.from_numpy(b), cfg128)[0]
    rhs = -tst.apply_block_stencil(dp, x).numpy()
    out = {}
    for dtype in (np.complex128, np.complex64):
        rdt = np.float64 if dtype == np.complex128 else np.float32
        jcfg, tcfg = jh.SolverConfig(**opts), th.SolverConfig(**opts)
        jan = {k: jnp.asarray(a.astype(rdt)) for k, a in aniso.items()}
        cj = jnp.asarray(np.full((n, n), 1500., dtype))
        op_j = jax.jit(lambda a, q: jh.prepare_operator(
            a, q, jcfg, with_transpose=False))(
            jplanes(cj, jnp.asarray(one.astype(rdt)), freq, **jan),
            jplanes(jh.shifted_velocity(cj, jcfg.shift),
                    jnp.asarray(one.astype(rdt)), freq, pml_cap=1.0,
                    **jan))
        _, it_j, rr_j = jax.jit(jax.vmap(lambda bb: jh.solve_info(
            op_j, bb, jcfg)))(jnp.asarray(rhs.astype(dtype)))
        c_t = torch.full((n, n), 1500., dtype=torch.float64).to(
            torch.complex128 if dtype == np.complex128
            else torch.complex64)
        tn = {k: torch.from_numpy(a.astype(rdt)) for k, a in aniso.items()}
        o = torch.from_numpy(one.astype(rdt))
        op_t = th.prepare_operator(
            tplanes(c_t, o, freq, **tn),
            tplanes(th.shifted_velocity(c_t, tcfg.shift), o, freq,
                    pml_cap=1.0, **tn), tcfg, with_transpose=False)
        _, it_t, rr_t = th.solve_info(op_t, torch.from_numpy(
            rhs.astype(dtype)), tcfg)
        out[np.dtype(dtype).name] = (np.asarray(it_j), np.asarray(rr_j),
                                     it_t.numpy(), rr_t.numpy())
    with capsys.disabled():
        for name, (it_j, rr_j, it_t, rr_t) in out.items():
            print('\nF8 %s tangent GMRES(20) iterations / worst relres: '
                  'JAX %s / %.3e, port %s / %.3e'
                  % (name, it_j.tolist(), rr_j.max(), it_t.tolist(),
                     rr_t.max()))
    for pkg in (0, 2):
        it64, rr64 = out['complex64'][pkg:pkg + 2]
        it128, rr128 = out['complex128'][pkg:pkg + 2]
        assert rr128.max() <= 1e-5 and it128.max() < opts['maxiter']
        assert rr64.max() > 1e-5 and it64.max() == opts['maxiter']
