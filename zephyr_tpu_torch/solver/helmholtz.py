'''
The zephyr_tpu_torch Helmholtz solve: the port of
``zephyr_tpu.solver.helmholtz`` for the forward scalar solve.

A prepared operator (``prepare_operator``) holds the coefficient planes,
the multigrid hierarchy of the complex-shifted operator, the precomputed
stratified interior solve and the Galerkin-coarsened true planes. The
solve is BiCGStab preconditioned by the fused hybrid cycle
(``hybrid_comp='fused'``): fine pre-smooth and restrict (K2), the
stratified PCR interior solve at half resolution (cuFFT + K3), the
half-grid true-operator residual (K1), a V-cycle from level 1 (K2/K4 per
level, a dense inverse at the coarsest), and the fine upstroke (K4).
``precond='mg'`` (one V-cycle) is the other supported preconditioner.

Configurations whose path needs a kernel that is not ported yet raise
NotImplementedError naming it, on every device; gradients (``solve`` as
an autograd Function) are not ported yet.
'''

from typing import NamedTuple, Any

import numpy as np
import torch

from ..ops.stencil import apply_block_stencil_fast
from .krylov import bicgstab, _norm
from .multigrid import (build_hierarchy, v_cycle, presmooth_restrict,
                        prolong_add_smooth, _mask_ring_planes, _ring_mask,
                        _fix_empty_rows, galerkin_coarsen)
from .stratified import stratified_coeffs, pcr_precompute, stratified_apply


class SolverConfig(NamedTuple):
    '''
    Static configuration of the iterative Helmholtz solver: the same
    fields and defaults as ``zephyr_tpu.solver.helmholtz.SolverConfig``
    (see there for what each one does). The port runs a subset; see
    ``check_config``.
    '''
    tol: float = 1e-7
    maxiter: int = 500
    mg_omega: float = 0.5
    mg_nu1: int = 2
    mg_nu2: int = 2
    mg_min_size: int = 32
    mg_coarse_iters: int = 12
    shift: complex = 0.5j
    mg_coarse: str = 'lu'
    pml_cap: float = 1.0
    krylov: str = 'auto'
    gmres_restart: int = 40
    fgmres_inner: int = 4
    precond: str = 'hybrid'
    mg_smoother: str = 'auto'
    fft_shift: Any = 'auto'
    fft_delta: float = 1e-3
    fft_scale: int = 1
    hybrid_comp: str = 'mult'
    strat_panels: int = 0
    strat_overlap: int = 16
    strat_taper: str = 'in'
    strat_dft: str = 'fft'
    fft_mode: str = 'strat'


def check_config(config, block_size=1):
    '''
    Raise NotImplementedError for any configuration whose path needs a
    part of the JAX package that is not ported yet. Called on every
    device, so no configuration quietly runs plain torch on the card.
    '''

    def no(what, why):
        raise NotImplementedError('%s: %s' % (what, why))

    if block_size != 1:
        no('block (B=2, TTI) operators', 'K8, the line smoother and the '
           'block stratified family are ROADMAP Slice D')
    if config.krylov not in ('auto', 'bicgstab'):
        no('krylov=%r' % (config.krylov,), 'GMRES/FGMRES are not ported '
           'yet (ROADMAP Slice D)')
    if config.mg_coarse not in ('inv', 'lu'):
        no('mg_coarse=%r' % (config.mg_coarse,), "the port has 'inv' and "
           "'lu' coarse solves")
    if config.mg_nu1 not in (1, 2):
        no('mg_nu1=%d' % config.mg_nu1, 'the downstroke kernel K2 takes 1 '
           'or 2 sweeps; more need K6 (ROADMAP Queue 2)')
    if config.mg_nu2 != 1:
        no('mg_nu2=%d' % config.mg_nu2, 'the upstroke kernel K4 carries '
           'one sweep; more need K5/K6 (ROADMAP Queue 2: K5 and the '
           'default SolverConfig path)')
    if config.precond == 'mg':
        return
    if config.precond != 'hybrid':
        no('precond=%r' % (config.precond,), "use 'hybrid' or 'mg'")
    if config.fft_mode != 'strat':
        no('fft_mode=%r' % (config.fft_mode,), 'the 2D-FFT symbol solve '
           'is not ported yet')
    if config.hybrid_comp != 'fused' or config.fft_scale != 2:
        no('hybrid_comp=%r, fft_scale=%r' % (config.hybrid_comp,
                                             config.fft_scale),
           "the port runs hybrid_comp='fused' with fft_scale=2; "
           "'mult'/'add' need the standalone transfer kernel K7")
    if config.strat_panels > 1:
        no('strat_panels=%d' % config.strat_panels, 'the x-panel family '
           'is not ported yet (ROADMAP Queue 1: x-panels)')
    if config.strat_dft != 'fft':
        no('strat_dft=%r' % (config.strat_dft,), 'the DFT-matmul '
           'x-transform is not ported yet (ROADMAP Queue 3, F2)')


def resolve_solver_config(opts=None, dtype=torch.complex128):
    '''
    A SolverConfig from a user options dict with the precision-aware
    default tolerance: 1e-5 for complex64, SolverConfig's 1e-7 for
    complex128.
    '''

    opts = dict(opts or {})
    if dtype == torch.complex64:
        opts.setdefault('tol', 1e-5)
    return SolverConfig(**opts)


def resolve_panels(config, c, nx=None, core=256, overlap=32,
                   contrast_threshold=1.02):
    '''
    Host-side resolution of ``strat_panels=0`` ('auto'): measure the
    lateral (within-row) relative velocity contrast over the interior
    window; laterally heterogeneous media get ~nx/core x-panels, layered
    and homogeneous media keep the global per-row solve
    (strat_panels=1). Explicit values pass through unchanged.
    '''

    cfg = config
    if cfg.strat_panels != 0:
        return cfg
    c = np.abs(np.asarray(c, dtype=np.complex128))
    nz, nxc = c.shape[-2:]
    nx = int(nx or nxc)
    zi = slice(nz // 8, nz - nz // 8)
    xi = slice(nxc // 8, nxc - nxc // 8)
    w = c[..., zi, xi]
    rm = np.maximum(w.mean(axis=-1, keepdims=True), 1e-30)
    rn = w / rm
    contrast = float(rn.max() / max(rn.min(), 1e-30))
    P = int(max(1, round(nx / core)))
    if contrast < contrast_threshold or P < 2:
        return cfg._replace(strat_panels=1)
    return cfg._replace(strat_panels=P, strat_overlap=overlap)


def shifted_velocity(c, shift=0.5j):
    '''
    Velocity substitution implementing the complex-shifted-Laplacian
    preconditioner: c' = c / sqrt(1 - i beta) turns the mass term
    omega^2/c^2 into (1 - i beta) omega^2/c^2.
    '''

    return c / complex(np.sqrt(1.0 - shift))


class HelmholtzOperator(NamedTuple):
    '''
    A prepared forward Helmholtz system: coefficient planes, the
    multigrid hierarchy of the shifted operator, the stratified interior
    solve (hybrid preconditioner) and the Galerkin-coarsened true planes
    (the fused cycle's level-1 residual operator).
    '''

    planes: Any            # (B, B, 9, nz, nx)
    hier: Any              # MGHierarchy of the shifted operator
    strat: Any = None      # StratPCR (precond='hybrid')
    cplanes: Any = None    # (B, B, 9, nzc, nxc)


def prepare_operator(planes, precond_planes=None, config=SolverConfig()):
    '''
    Build a HelmholtzOperator from true planes and the planes of the
    complex-shifted operator (default: the true planes). The multigrid
    hierarchy comes from the shifted planes; the hybrid preconditioner's
    stratified solve is built from the Galerkin-coarsened true and
    shifted operators (fft_scale=2).
    '''

    check_config(config, planes.shape[0])
    if precond_planes is None:
        precond_planes = planes
    pp = precond_planes.detach()
    tp = planes.detach()
    hier = build_hierarchy(pp, min_size=config.mg_min_size,
                           coarse=config.mg_coarse)
    if config.precond == 'mg':
        return HelmholtzOperator(planes, hier)
    if len(hier.levels) < 2:
        raise NotImplementedError(
            'the fused hybrid cycle needs a second multigrid level: the '
            'grid is already at mg_min_size, where the JAX package falls '
            "back to the unported 'mult' composition")

    nz, nx = tp.shape[-2:]
    mask = _ring_mask(nz, nx, tp.real.dtype, tp.device)
    ctrue = _fix_empty_rows(galerkin_coarsen(_mask_ring_planes(tp, mask)))
    cpp = hier.levels[1].planes
    l, d, u = stratified_coeffs(ctrue, cpp, config.shift, config.fft_shift)
    strat = pcr_precompute(l, d, u)
    return HelmholtzOperator(planes, hier, strat, ctrue)


def _make_precond(op, config):
    '''
    The preconditioner application r -> M r on a batch (R, 1, nz, nx).

    'mg': one V-cycle on the shifted hierarchy.
    'hybrid' (fused): ONE cycle in which the stratified PCR interior
        solve is the level-1 coarse-grid boost — fine pre-smooth and
        restricted residual, xc = P rc, the residual against the
        Galerkin-coarsened TRUE operator, a V-cycle from level 1, then
        prolong, add and the fine post-smooth.
    '''

    check_config(config, op.planes.shape[0])
    hier = op.hier
    omega, nu1, nu2 = config.mg_omega, config.mg_nu1, config.mg_nu2
    if config.precond == 'mg' or op.strat is None:
        if config.precond != 'mg':
            raise ValueError("operator was prepared without the hybrid "
                             "solve; use precond='mg'")
        return lambda r: v_cycle(hier, r, omega=omega, nu1=nu1, nu2=nu2)

    lvl0 = hier.levels[0]
    cpl = op.cplanes

    def M(r):
        u, rc = presmooth_restrict(lvl0, r, omega, nu1)
        xc = stratified_apply(op.strat, rc)
        rc2 = rc - apply_block_stencil_fast(cpl, xc)
        xc = xc + v_cycle(hier, rc2, omega=omega, nu1=nu1, nu2=nu2,
                          level=1)
        return prolong_add_smooth(lvl0, u, r, xc, omega, nu2)

    return M


def solve_info(op, b, config=SolverConfig()):
    '''
    Forward solve of a batch b (R, B, nz, nx) to ``config.tol`` in one
    BiCGStab run. Returns (x, iters (R,), relres (R,)). Not
    differentiable.
    '''

    def mv(x):
        return apply_block_stencil_fast(op.planes, x)

    M = _make_precond(op, config)
    res = bicgstab(mv, b, M=M, tol=config.tol, maxiter=config.maxiter)
    return res.x, res.iters, res.relres


def solve_batched(op, b, config=SolverConfig()):
    'Forward solve of a batch b (R, B, nz, nx); returns x.'

    return solve_info(op, b, config)[0]


def make_chunked_solver(config=SolverConfig(), chunk=64):
    '''
    Host-driven restarted solve: BiCGStab runs in chunks of at most
    ``chunk`` iterations; between chunks the TRUE residual is recomputed
    and the iteration restarts from the current iterate (which removes
    the recursive-residual drift of single-precision BiCGStab).

    Returns ``solve(op, b_batch, max_chunks=None) -> (x, iters, relres)``
    with b_batch (R, B, nz, nx) a tensor on the operator's device, iters
    the summed per-chunk maximum iteration count and relres the worst
    true relative residual over the batch.

    The chunk tolerance is rescaled so the stop target stays
    tol * ||b|| globally (with a 0.7 margin for recursive-vs-true residual
    drift). If a restart makes the true residual non-finite or more than
    4x worse than the best so far, the best iterate is kept; a non-finite
    FIRST chunk keeps the pre-chunk iterate (zeros) and returns its
    non-finite relres.
    '''

    margin = 0.7

    def chunk_step(op, b, x, M):
        def mv(v):
            return apply_block_stencil_fast(op.planes, v)

        r = b - mv(x)
        bnorm0 = _norm(b)
        rnorm = _norm(r)
        tiny = torch.finfo(rnorm.dtype).tiny
        tol_c = margin * config.tol * bnorm0 / torch.clamp(rnorm, min=tiny)
        res = bicgstab(mv, r, M=M, tol=tol_c, maxiter=chunk)
        x = x + res.x
        bnorm = torch.where(bnorm0 > 0, bnorm0, torch.ones_like(bnorm0))
        rr = _norm(b - mv(x)) / bnorm
        return x, torch.max(rr), torch.max(res.iters)

    def solve_chunked(op, b_batch, max_chunks=None):
        if max_chunks is None:
            max_chunks = max(1, config.maxiter // chunk)
        M = _make_precond(op, config)
        x = torch.zeros_like(b_batch)
        iters = 0
        worst = None
        best = None
        for i in range(max_chunks):
            x_new, rr, its = chunk_step(op, b_batch, x, M)
            worst = float(rr)
            iters += int(its)
            if not np.isfinite(worst) or (best is not None
                                          and worst > 4.0 * best[1]):
                # the restart made the TRUE residual materially worse or
                # non-finite: keep the best iterate (or, on the first
                # chunk, the pre-chunk iterate) and stop
                if best is not None:
                    x, worst = best
                break
            x = x_new
            if best is None or worst < best[1]:
                best = (x, worst)
            if worst <= config.tol:
                break
        return x, iters, worst

    return solve_chunked
