'''
Port parity of the solver configurations added beside the production
one: the 2D-FFT symbol solve (``fft_mode='2d'``, B=1 and B=2), the
additive hybrid (``hybrid_comp='add'``), the iterative coarse solve
(``mg_coarse='iterative'``) and ``interior_mask``, zephyr_tpu_torch on
the CPU against zephyr_tpu on XLA:CPU, complex128, on inputs made from
numpy seeds.

Tolerances:
- the inverse interior symbol: rel 1e-10 (its clamped near-resonant
  modes amplify the ulp-level difference of the two exp/sin/cos
  implementations by up to 1 / fft_delta);
- preconditioner applications, forward and transpose, and the V-cycle
  of an interior-masked hierarchy: rel 1e-10 (two LAPACK builds for the
  dense coarsest level; the symbol as above);
- masks at every level: equal; coarse planes: rel 1e-12;
- the iterative coarse solve, lane by lane: rel 1e-10 at 4 steps; from
  8 steps the coarse BiCGStab amplifies complex128 rounding (on the
  layered coarse operator to ~1e-6 at the default 12, in either package
  when its input moves by one ulp), so there the bound is 4x that
  one-ulp change of the JAX package's own result; the device loop's
  lane freezing: equal per-lane counts, rel 1e-10;
- solves (point sources, tol 1e-5): both below tol, solutions within
  rel 1e-4 (as ``test_torch_helmholtz.test_ported_configs_match_jax``),
  and equal BiCGStab / GMRES iteration counts where the trajectory is
  not rounding-bound (``EQUAL_COUNTS``; the others are printed);
- gradients through ``solve`` at tol 1e-10: rel 1e-6 against jax.grad.
'''

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import zephyr_tpu.backend as jb
from zephyr_tpu.ops.eurus_coeff import eurus_planes as jeplanes
from zephyr_tpu.ops.minizephyr_coeff import minizephyr_planes as jplanes
from zephyr_tpu.solver import helmholtz as jh
from zephyr_tpu.solver import krylov as jk
from zephyr_tpu.solver import multigrid as jmg
from zephyr_tpu.ops.stencil import (apply_block_stencil as japply,
                                    block_diag_matvec as jbdm)
from zephyr_tpu_torch import convert
import zephyr_tpu_torch.backend as tb
from zephyr_tpu_torch.ops.eurus_coeff import eurus_planes as teplanes
from zephyr_tpu_torch.ops.minizephyr_coeff import minizephyr_planes as tplanes
from zephyr_tpu_torch.ops.stencil import (apply_block_stencil_fast as tapply,
                                          block_diag_matvec as tbdm)
from zephyr_tpu_torch.solver import helmholtz as th
from zephyr_tpu_torch.solver import krylov as tk
from zephyr_tpu_torch.solver import multigrid as tmg

NZ, NX, FREQ = 48, 40, 150.
PRODUCTION = dict(tol=1e-5, maxiter=2000, mg_coarse='inv', mg_min_size=10,
                  fft_mode='strat', fft_scale=2, hybrid_comp='fused',
                  mg_nu1=2, mg_nu2=1)
SOURCES = ((16, 28), (30, 10))
TOL = 1e-10


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    '''
    The port's side on one intra-op thread for this module (its tensors
    are small; the parallel test run shares the cores), restored after.
    '''
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = (np.asarray(v.detach().resolve_conj() if torch.is_tensor(v)
                       else v) for v in (a, b))
    return np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel())


def _configs(**kw):
    opts = dict(PRODUCTION, **kw)
    return jh.SolverConfig(**opts), th.SolverConfig(**opts)


def _model(medium):
    c = np.full((NZ, NX), 1500. + 0j)
    if medium == 'layered':
        c[NZ // 2:] = 2400.
    return c


def _closure_mask(nz=NZ, nx=NX, overlap=4):
    '''
    The closure mask of an overlapped-Schwarz slab: the first and last
    ``overlap + 1`` columns zeroed (the JAX package's
    ``parallel/spatial.py`` builds it so for a slab with x-overlap).
    '''
    m = np.ones((nz, nx))
    m[:, :overlap + 1] = 0.
    m[:, nx - overlap - 1:] = 0.
    return m


def _rhs(B=1):
    q = np.zeros((len(SOURCES), B, NZ, NX), complex)
    for i, (z, x) in enumerate(SOURCES):
        q[i, 0, z, x] = 1.0
    return q


def _rand(seed, *shape):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@functools.lru_cache(maxsize=None)
def _plane_pair(medium, block=False):
    '(true, shifted) planes as numpy complex128, from the JAX package.'
    c = jnp.asarray(_model(medium))
    rho = jnp.ones((NZ, NX))
    if block:
        aniso = dict(theta=0.3 * jnp.ones((NZ, NX)),
                     eps=0.2 * jnp.ones((NZ, NX)),
                     delta=0.1 * jnp.ones((NZ, NX)))
        return (np.array(jeplanes(c, rho, FREQ, **aniso)),
                np.array(jeplanes(jh.shifted_velocity(c, 0.5j), rho, FREQ,
                                  pml_cap=1.0, **aniso)))
    return (np.array(jplanes(c, rho, FREQ)[None, None]),
            np.array(jplanes(jh.shifted_velocity(c, 0.5j), rho, FREQ,
                             pml_cap=1.0)[None, None]))


def _jax_op(cfg, medium, block=False, mask=None, with_transpose=True):
    '''The JAX package's prepared operator, one compiled preparation.'''
    p, pp = _plane_pair(medium, block)
    im = None if mask is None else jnp.asarray(mask)
    return jax.jit(lambda a, b, m: jh.prepare_operator(
        a, b, cfg, with_transpose=with_transpose, interior_mask=m))(
            jnp.asarray(p), jnp.asarray(pp), im)


def _torch_op(cfg, medium, block=False, mask=None, with_transpose=True):
    '''
    The port's own preparation from its own planes (the plane functions
    are held against each other in tests/test_torch_minizephyr_coeff.py
    and tests/test_torch_eurus.py).
    '''
    c, rho = convert.model_from_numpy(_model(medium), np.ones((NZ, NX)),
                                      device='cpu')
    if block:
        aniso = {k: torch.full((NZ, NX), v, dtype=torch.float64)
                 for k, v in (('theta', 0.3), ('eps', 0.2), ('delta', 0.1))}
        p = teplanes(c, rho, FREQ, **aniso)
        pp = teplanes(th.shifted_velocity(c, cfg.shift), rho, FREQ,
                      pml_cap=cfg.pml_cap, **aniso)
    else:
        p = tplanes(c, rho, FREQ)[None, None]
        pp = tplanes(th.shifted_velocity(c, cfg.shift), rho, FREQ,
                     pml_cap=cfg.pml_cap)[None, None]
    im = None if mask is None else torch.from_numpy(mask)
    return th.prepare_operator(p, pp, cfg, with_transpose=with_transpose,
                               interior_mask=im)


# --- the inverse interior symbol -----------------------------------------

@pytest.mark.parametrize('medium,block,fft_shift', [
    ('hom', False, 'auto'), ('layered', False, 'auto'),
    ('layered', False, 0.1j), ('layered', True, 'auto')],
    ids=['B1-hom-auto', 'B1-layered-auto', 'B1-layered-0.1j', 'B2-auto'])
def test_fft_symbol_inverse_matches_jax(medium, block, fft_shift):
    '''
    _fft_symbol_inverse at B=1 (the 'auto' shift picks 0.03j on the
    homogeneous and 0.25j on the layered model) and B=2 (always 0.25j),
    from the same planes, rel 1e-10.
    '''
    jcfg, cfg = _configs(fft_shift=fft_shift, fft_delta=1e-3)
    p, pp = _plane_pair(medium, block)
    ref = np.asarray(jh._fft_symbol_inverse(jnp.asarray(p), jnp.asarray(pp),
                                            jcfg))
    out = th._fft_symbol_inverse(torch.from_numpy(p), torch.from_numpy(pp),
                                 cfg)
    assert out.shape == ref.shape == (2 if block else 1,) * 2 + (NZ, NX)
    assert _rel(out, ref) < TOL
    means = th._mean_interior_coeffs(torch.from_numpy(p))
    assert _rel(means, jh._mean_interior_coeffs(jnp.asarray(p))) < 1e-14


# --- the 2D preconditioner ------------------------------------------------

PRECONDS = {
    'scale1-mult': dict(fft_mode='2d', fft_scale=1, hybrid_comp='mult'),
    'scale1-add': dict(fft_mode='2d', fft_scale=1, hybrid_comp='add'),
    'scale2-mult': dict(fft_mode='2d', fft_scale=2, hybrid_comp='mult'),
    'scale2-add': dict(fft_mode='2d', fft_scale=2, hybrid_comp='add'),
    'scale2-fused': dict(fft_mode='2d', fft_scale=2, hybrid_comp='fused'),
    'strat-add': dict(hybrid_comp='add'),
}


@pytest.mark.parametrize('name', list(PRECONDS))
def test_preconditioner_matches_jax(name):
    '''
    Forward and transpose preconditioner applications on the layered
    model, rel 1e-10, of the port's own preparation and of the JAX state
    carried over by ``operator_from_numpy`` (``fft_sinv``, hierT and
    planesT included).
    '''
    jcfg, cfg = _configs(**PRECONDS[name])
    op_j = _jax_op(jcfg, 'layered')
    op_t = _torch_op(cfg, 'layered')
    op_c = convert.operator_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                              op_j),
                                       device='cpu')
    if cfg.fft_mode == '2d':
        assert op_t.strat is None and op_c.strat is None
        assert _rel(op_c.fft_sinv, op_j.fft_sinv) == 0
        assert _rel(op_t.fft_sinv, op_j.fft_sinv) < TOL
    assert (op_t.cplanes is None) == (cfg.hybrid_comp != 'fused')
    r = _rand(3, 2, 1, NZ, NX)
    for transpose in (False, True):
        ref = jax.jit(jax.vmap(jh._make_precond(op_j, jcfg,
                                                transpose=transpose)))(
            jnp.asarray(r))
        for op in (op_t, op_c):
            out = th._make_precond(op, cfg, transpose=transpose)(
                torch.from_numpy(r))
            assert _rel(out, ref) < TOL


# --- interior_mask ---------------------------------------------------------

def test_build_hierarchy_interior_mask_matches_jax():
    '''
    build_hierarchy with a slab's closure mask: every level's mask equal
    to JAX's (the mask decimated down the hierarchy, times the ring),
    the coarse planes rel 1e-12, the V-cycle rel 1e-10; and
    prepare_operator with the mask: the Galerkin-coarsened true planes
    rel 1e-12 and the fused preconditioner rel 1e-10.
    '''
    mask = _closure_mask()
    _, pp = _plane_pair('layered')
    hj = jmg.build_hierarchy(jnp.asarray(pp), min_size=10, coarse='inv',
                             interior_mask=jnp.asarray(mask))
    ht = tmg.build_hierarchy(torch.from_numpy(pp), min_size=10,
                             coarse='inv',
                             interior_mask=torch.from_numpy(mask))
    plain = tmg.build_hierarchy(torch.from_numpy(pp), min_size=10,
                                coarse='inv')
    assert len(ht.levels) == len(hj.levels) == 3
    for lt, lj, lp in zip(ht.levels, hj.levels, plain.levels):
        assert np.array_equal(lt.mask.numpy(), np.asarray(lj.mask))
        # zeros inside the grid, not only on the ring
        assert float(lt.mask.sum()) < float(lp.mask.sum())
        assert _rel(lt.planes, lj.planes) < 1e-12
    r = _rand(4, 2, 1, NZ, NX)
    ref = jax.vmap(lambda b: jmg.v_cycle(hj, b, omega=0.5, nu1=2,
                                         nu2=1))(jnp.asarray(r))
    assert _rel(tmg.v_cycle(ht, torch.from_numpy(r), omega=0.5, nu1=2,
                            nu2=1), ref) < TOL

    jcfg, cfg = _configs()
    op_j = _jax_op(jcfg, 'layered', mask=mask)
    op_t = _torch_op(cfg, 'layered', mask=mask)
    assert _rel(op_t.cplanes, op_j.cplanes) < 1e-12
    ref = jax.vmap(jh._make_precond(op_j, jcfg))(jnp.asarray(r))
    assert _rel(th._make_precond(op_t, cfg)(torch.from_numpy(r)), ref) < TOL


# --- the iterative coarse solve --------------------------------------------

@pytest.fixture(scope='module')
def iterative_hiers():
    '''
    Iterative hierarchies (no LU, no inverse) of the shifted operator in
    both packages, hom and layered, and the port's from the JAX tree.
    '''
    out = {}
    for medium in ('hom', 'layered'):
        _, pp = _plane_pair(medium)
        hj = jmg.build_hierarchy(jnp.asarray(pp), min_size=10,
                                 coarse='iterative')
        ht = tmg.build_hierarchy(torch.from_numpy(pp), min_size=10,
                                 coarse='iterative')
        hc = convert._hier_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                             hj), 'cpu')
        out[medium] = hj, ht, hc
    return out


@pytest.mark.parametrize('medium', ['hom', 'layered'])
@pytest.mark.parametrize('coarse_iters', [4, 8, 12])
def test_iterative_coarse_solve_lane_by_lane(iterative_hiers, medium,
                                             coarse_iters):
    '''
    _coarse_solve of an iterative hierarchy on a batch against the JAX
    package's vmapped one, lane by lane, for the port's own hierarchy and
    the converted JAX one: rel 1e-10 per right-hand side, or, where the
    coarse BiCGStab amplifies rounding past that (8 steps on the layered
    operator, 12 on both), within 4x the change that one ulp of b makes
    in the JAX package's own result. The transposed hierarchy stays
    iterative (no re-factorisation).
    '''
    hj, ht, hc = iterative_hiers[medium]
    for h in (ht, hc):
        assert h.coarse_lu is None and h.coarse_inv is None
    hT = tmg.transpose_hierarchy(ht)
    assert hT.coarse_lu is None and hT.coarse_inv is None
    nz, nx = ht.levels[-1].planes.shape[-2:]
    b = _rand(5, 3, 1, nz, nx)

    def ref_of(bb):
        return np.asarray(jax.vmap(lambda v: jmg._coarse_solve(
            hj, v, coarse_iters))(jnp.asarray(bb)))
    ref, ref_ulp = ref_of(b), ref_of(b * (1 + 2.0 ** -52))
    for h in (ht, hc):
        out = tmg._coarse_solve(h, torch.from_numpy(b), coarse_iters)
        for lane in range(3):
            bound = max(TOL, 4 * _rel(ref_ulp[lane], ref[lane]))
            assert _rel(out[lane], ref[lane]) < bound
            if coarse_iters == 4:
                assert _rel(out[lane], ref[lane]) < TOL


def test_bicgstab_fixed_freezes_lanes_as_jax_vmap(iterative_hiers):
    '''
    The device loop of the coarse solve: lanes that meet tol at
    different steps (a zero right-hand side at step 0) freeze as the JAX
    package's vmapped while_loop freezes them: equal per-lane iteration
    counts and relres, x rel 1e-10 per lane; and it makes no host sync
    (it runs on meta tensors, where any sync raises, while ``bicgstab``
    does not).
    '''
    hj, ht, _ = iterative_hiers['hom']
    lj, lt = hj.levels[-1], ht.levels[-1]
    nz, nx = lt.planes.shape[-2:]
    b = _rand(6, 3, 1, nz, nx)
    b[1] = 0.
    res_j = jax.vmap(lambda bb: jk.bicgstab(
        lambda x: japply(lj.planes, x), bb,
        M=lambda r: jbdm(lj.dinv, r), tol=0.2, maxiter=30))(jnp.asarray(b))
    res_t = tk.bicgstab_fixed(lambda x: tapply(lt.planes, x),
                              torch.from_numpy(b),
                              M=lambda r: tbdm(lt.dinv, r), tol=0.2,
                              maxiter=30)
    its = np.asarray(res_j.iters)
    assert res_t.iters.tolist() == its.tolist()
    assert its[1] == 0 and len(set(its.tolist())) > 1 and its.max() < 30
    for lane in (0, 2):
        assert _rel(res_t.x[lane], res_j.x[lane]) < TOL
    assert not bool(res_t.x[1].abs().sum())
    assert np.allclose(res_t.relres.numpy(), np.asarray(res_j.relres),
                       rtol=1e-10)
    # the host-synced loop gives the same result
    res_s = tk.bicgstab(lambda x: tapply(lt.planes, x), torch.from_numpy(b),
                        M=lambda r: tbdm(lt.dinv, r), tol=0.2, maxiter=30)
    assert torch.equal(res_s.x, res_t.x)
    assert torch.equal(res_s.iters, res_t.iters)

    d = torch.ones((1, 8, 8), dtype=torch.complex64, device='meta')
    bm = torch.ones((2, 1, 8, 8), dtype=torch.complex64, device='meta')
    res_m = tk.bicgstab_fixed(lambda x: 2 * x, bm, M=lambda r: d * r,
                              maxiter=3)
    assert res_m.x.device.type == 'meta'
    with pytest.raises((NotImplementedError, RuntimeError)):
        tk.bicgstab(lambda x: 2 * x, bm, M=lambda r: d * r, maxiter=3)


# --- solves ----------------------------------------------------------------

SOLVES = {
    '2d': dict(fft_mode='2d'),
    '2d-mult': dict(fft_mode='2d', fft_scale=1, hybrid_comp='mult'),
    'add': dict(hybrid_comp='add'),
    'iterative': dict(mg_coarse='iterative'),
    'interior-mask': dict(),
}
#: (config, medium) whose iteration counts equal the JAX package's; in
#: the others a count moves by rounding: 'add' (the weakest of the
#: compositions; on the layered model the JAX package itself takes 23 or
#: 26 iterations for the first source as its preparation is compiled or
#: not), the interior mask on the layered model (there 38 or 39) and
#: 'iterative' on the layered model, whose coarse BiCGStab is
#: rounding-bound (see the module docstring)
EQUAL_COUNTS = {('2d', 'hom'), ('2d', 'layered'), ('2d-mult', 'hom'),
                ('2d-mult', 'layered'), ('iterative', 'hom'),
                ('interior-mask', 'hom')}


@pytest.mark.parametrize('medium', ['hom', 'layered'])
@pytest.mark.parametrize('name', list(SOLVES))
def test_solve_info_matches_jax(name, medium):
    '''
    solve_info of two point sources under each new configuration (the
    interior mask with the production config), both packages: the
    port's relres <= tol, the solutions within rel 1e-4, and iteration
    counts equal where ``EQUAL_COUNTS`` says.
    '''
    jcfg, cfg = _configs(**SOLVES[name])
    mask = _closure_mask() if name == 'interior-mask' else None
    op_j = _jax_op(jcfg, medium, mask=mask, with_transpose=False)
    x_j, it_j, _ = jax.jit(jax.vmap(lambda b: jh.solve_info(op_j, b,
                                                            jcfg)))(
        jnp.asarray(_rhs()))
    x_t, it_t, rr_t = th.solve_info(
        _torch_op(cfg, medium, mask=mask, with_transpose=False),
        torch.from_numpy(_rhs()), cfg)
    print(name, medium, 'iterations jax', np.asarray(it_j).tolist(),
          'port', it_t.tolist())
    assert bool((rr_t <= cfg.tol).all())
    assert _rel(x_t, x_j) < 1e-4
    if (name, medium) in EQUAL_COUNTS:
        assert it_t.tolist() == np.asarray(it_j).tolist()


TTI_2D = {'scale1-mult': dict(fft_scale=1, hybrid_comp='mult'),
          'scale2-fused': dict(fft_scale=2, hybrid_comp='fused')}


def _tti_2d_configs(name):
    return _configs(fft_mode='2d', tol=1e-8, mg_nu1=1, mg_nu2=1,
                    gmres_restart=20, mg_min_size=12, **TTI_2D[name])


@functools.lru_cache(maxsize=None)
def _tti_2d_ops(name):
    '''
    Both packages' prepared Eurus operators (with transposes) under
    TTI_2D[name], shared by the tests below. The JAX block preparation
    (~20 s, its line states) runs once: the 'mult' operator at full
    resolution is the fused one with the fine-grid symbol and no
    coarsened true planes, which is what JAX's prepare_operator builds
    for it (the same hierarchies).
    '''
    jcfg, cfg = _tti_2d_configs(name)
    if name == 'scale2-fused':
        op_j = _jax_op(jcfg, 'layered', block=True)
    else:
        p, pp = _plane_pair('layered', True)
        op_j = _tti_2d_ops('scale2-fused')[0]._replace(
            cplanes=None, fft_sinv=jh._fft_symbol_inverse(
                jnp.asarray(p), jnp.asarray(pp), jcfg))
    return op_j, _torch_op(cfg, 'layered', block=True)


@pytest.mark.parametrize('name', list(TTI_2D))
def test_tti_2d_preconditioner_matches_jax(name):
    '''
    The Eurus (B=2) operator with the 2x2 block symbol solve, on the
    layered model (line-smoothed hierarchy): the preconditioner forward
    and transpose rel 1e-10, at full resolution ('mult') and in the fused
    cycle at half resolution.
    '''
    jcfg, cfg = _tti_2d_configs(name)
    op_j, op_t = _tti_2d_ops(name)
    assert op_t.fft_sinv.shape[:2] == (2, 2)
    assert (op_t.cplanes is None) == (name == 'scale1-mult')
    r = _rand(7, 2, 2, NZ, NX)
    for transpose in (False, True):
        ref = jax.jit(jax.vmap(jh._make_precond(op_j, jcfg,
                                                transpose=transpose)))(
            jnp.asarray(r))
        out = th._make_precond(op_t, cfg, transpose=transpose)(
            torch.from_numpy(r))
        assert _rel(out, ref) < TOL


def test_tti_2d_solve_matches_jax():
    '''
    GMRES solve_info of the Eurus operator with the block symbol in the
    fused cycle, layered model, tol 1e-8: iterations equal, solutions
    rel 1e-6.
    '''
    jcfg, cfg = _tti_2d_configs('scale2-fused')
    op_j, op_t = _tti_2d_ops('scale2-fused')
    x_j, it_j, _ = jax.jit(jax.vmap(lambda b: jh.solve_info(op_j, b,
                                                            jcfg)))(
        jnp.asarray(_rhs(2)))
    x_t, it_t, rr_t = th.solve_info(op_t, torch.from_numpy(_rhs(2)), cfg)
    assert it_t.tolist() == np.asarray(it_j).tolist()
    assert bool((rr_t <= cfg.tol).all())
    assert _rel(x_t, x_j) < 1e-6


# --- gradients -------------------------------------------------------------

@pytest.mark.parametrize('kw', [dict(fft_mode='2d'),
                                dict(mg_coarse='iterative',
                                     hybrid_comp='mult')],
                         ids=['2d-fused', 'iterative'])
def test_solve_gradient_matches_jax_grad(kw):
    '''
    d/dc of sum |u|^2 through ``solve`` (the backward's transpose solve
    runs the transposed symbol solve fft2(S^T ifft2 r) or the transposed
    iterative hierarchy), on the layered model, solves at tol 1e-10: rel
    1e-6 against jax.grad through the JAX package's ``solve``.
    '''
    jcfg, cfg = _configs(tol=1e-10, **kw)
    c0 = _model('layered').real
    rho = np.ones((NZ, NX))

    def loss_jax(c):
        c = c.astype(jnp.complex128)
        p = jplanes(c, jnp.asarray(rho), FREQ)[None, None]
        pp = jplanes(jh.shifted_velocity(c, jcfg.shift), jnp.asarray(rho),
                     FREQ, pml_cap=jcfg.pml_cap)[None, None]
        op = jh.prepare_operator(p, pp, jcfg, with_transpose=True)
        u = jax.vmap(lambda b: jh.solve(op, b, jcfg))(jnp.asarray(_rhs()))
        return jnp.sum(jnp.abs(u) ** 2)

    g_j = np.asarray(jax.jit(jax.grad(loss_jax))(jnp.asarray(c0)))
    c = torch.from_numpy(c0).requires_grad_(True)
    ct = c.to(torch.complex128)
    rt = torch.from_numpy(rho)
    p = tplanes(ct, rt, FREQ)[None, None]
    pp = tplanes(th.shifted_velocity(ct.detach(), cfg.shift), rt, FREQ,
                 pml_cap=cfg.pml_cap)[None, None]
    op = th.prepare_operator(p, pp, cfg)
    u = th.solve_batched(op, torch.from_numpy(_rhs()), cfg)
    g_t, = torch.autograd.grad(torch.sum(torch.abs(u) ** 2), c)
    assert _rel(g_t, g_j) < 1e-6


# --- the backend ------------------------------------------------------------

def test_minizephyr_solver_opts_reach_the_solve():
    '''
    ``solverOpts`` with the new keys reach the prepared operator and the
    solve unchanged: ``MiniZephyr(config) * q`` with the 2D symbol solve
    and the iterative coarse solve, against the JAX package's (rel 1e-6,
    tol 1e-9).
    '''
    opts = dict(tol=1e-9, mg_min_size=10, fft_mode='2d',
                mg_coarse='iterative', mg_coarse_iters=8)
    config = {'c': np.where(np.arange(48)[:, None] < 24, 2500., 3200.)
              * np.ones((48, 40)), 'rho': 1., 'nx': 40, 'nz': 48,
              'freq': 150., 'solverOpts': opts}
    locs = np.array([[20., 16.], [11.3, 30.7]])
    disc = tb.MiniZephyr(dict(config, device='cpu'))
    assert disc.solverConfig.fft_mode == '2d'
    assert disc.solverConfig.mg_coarse_iters == 8
    assert disc.Ainv.fft_sinv is not None and disc.Ainv.strat is None
    assert disc.Ainv.hier.coarse_lu is None
    u_t = disc * tb.SparseKaiserSource(dict(config, device='cpu'))(locs)
    u_j = jb.MiniZephyr(config) * jb.SparseKaiserSource(config)(locs)
    assert _rel(u_t, u_j) < 1e-6
