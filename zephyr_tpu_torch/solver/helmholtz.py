'''
The zephyr_tpu_torch Helmholtz solve: the port of
``zephyr_tpu.solver.helmholtz`` for scalar (B=1) operators and for the
2x2 block (B=2) Eurus TTI operators.

A prepared operator (``prepare_operator``) holds the coefficient planes,
the multigrid hierarchy of the complex-shifted operator, the precomputed
stratified interior solve, the Galerkin-coarsened true planes and, with
``with_transpose=True``, the transposed planes and hierarchy. The Krylov
method is BiCGStab for scalar operators and restarted GMRES for block
ones (``krylov='auto'``; 'bicgstab', 'gmres' and 'fgmres' on request). A
scalar solve is preconditioned by one of:

- the fused hybrid cycle (``hybrid_comp='fused'``, ``fft_scale=2``): fine
  pre-smooth and restrict (K2), the stratified PCR interior solve at half
  resolution (cuFFT + K3), the half-grid true-operator residual (K1), a
  V-cycle from level 1 (K2/K4 per level, a dense inverse or LU at the
  coarsest), and the fine upstroke (K4);
- the multiplicative hybrid (``hybrid_comp='mult'``, the default
  SolverConfig): the stratified solve P at full resolution
  (``fft_scale=1``) or between the transfer operators (K7) at half
  resolution, the residual against the true operator (K1) and one
  V-cycle (K2, K4 and at ``mg_nu2=2`` K5 per level);
- the additive hybrid (``hybrid_comp='add'``): M r = P r + V r;
- one V-cycle (``precond='mg'``).

The spectral solve P is the stratified PCR interior solve
(``fft_mode='strat'``) or the 2D-FFT symbol solve (``fft_mode='2d'``):
ifft2(S fft2 r) with S the regularised pointwise inverse of the mean
interior stencil's Fourier symbol (``_fft_symbol_inverse``; cuFFT through
``torch.fft``), at full resolution or, at ``fft_scale=2``, from the
Galerkin-coarsened planes (where the fused cycle takes it as its level-1
boost). The coarsest level is a dense inverse, an LU, or
(``mg_coarse='iterative'``) ``mg_coarse_iters`` steps of
block-Jacobi-preconditioned BiCGStab that stay on the device (K1, or K8
for a block operator). ``interior_mask`` keeps extra rows (an
overlapped-Schwarz slab's closure band) out of every coarse-grid
correction.

Every V-cycle takes any sweep counts ``mg_nu1``, ``mg_nu2`` >= 0 (more
than two sweeps run the two-sweep kernel K6). The stratified solve is
global or, for laterally heterogeneous media (``strat_panels > 1``, which
``resolve_panels`` picks for them), x-panelled; its x-transform is cuFFT
or (``strat_dft``) a DFT matmul.

A block solve's stratified hybrid preconditioner is always 'mult' or
'add' at full resolution: the block stratified PCR interior solve built
from the fine planes (cuFFT and plain torch), the residual against the
true operator (K8) and one V-cycle smoothed by alternating z/x lines (K8
for every residual, K7 for the transfers, plain-torch block PCR for the
lines). With ``fft_mode='2d'`` the block symbol solve takes the scalar
path's compositions, the fused cycle included.

``solve``/``solve_batched`` are differentiable (``torch.autograd``) with
respect to the planes and the right-hand side, as
``lax.custom_linear_solve`` makes them in the JAX package, for scalar and
block operators: forward mode (``torch.autograd.forward_ad``) runs one
more solve with the same operator; the backward runs one transpose solve
(BiCGStab, or GMRES for a block operator) with the transpose
preconditioner (the fused cycle falls back to 'mult' there, which runs
K7; a block operator's is 'mult' from the transposed block stratified
family, K8 for the residuals and the transposed line-smoothed V-cycle).

Configurations whose path needs a part that is not ported yet raise
NotImplementedError naming it, on every device.

With tracing on (``utils.profiling.recording``) the solve opens spans at
its layer boundaries: ``helmholtz.prepare_operator`` (children
``multigrid.build_hierarchy``, ``helmholtz.coarsen_true``,
``stratified.precompute``; it closes after a device synchronise), the
chunked solve's ``helmholtz.solve``, ``helmholtz.chunk`` (its iterations,
worst relres and, per right-hand side, iterations and true relres) and
``helmholtz.true_residual``, and a preconditioner application's
``precond.apply`` (children ``precond.fine``, ``precond.spectral``,
``precond.coarse``, or ``precond.vcycle`` in the 'add' and 'mult' forms).
The chunked solve's host reads count in ``solver.syncs``.
'''

from typing import NamedTuple, Any

import numpy as np
import torch

from ..utils.profiling import add, enabled, span
from ..ops.stencil import (CENTER, OFFSETS, apply_block_stencil_fast,
                           block_plane_products, transpose_block_planes)
from .krylov import (bicgstab, fgmres, fgmres_cycle, gmres, gmres_cycle,
                     _norm)
from .multigrid import (build_hierarchy, v_cycle, presmooth_restrict,
                        prolong_add_smooth, _mask_ring_planes, _ring_mask,
                        _fix_empty_rows, galerkin_coarsen, restrict, prolong,
                        transpose_hierarchy)
from .stratified import (stratified_coeffs, pcr_precompute,
                         stratified_apply, transpose_pcr,
                         stratified_coeffs_panels, panel_layout,
                         panel_solver, stratified_coeffs_block,
                         pcr_precompute_block, stratified_apply_block,
                         transpose_pcr_block)


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

    if block_size not in (1, 2):
        no('block size B=%d' % block_size, 'the port has scalar (B=1) and '
           '2x2 block (B=2, TTI) operators')
    if config.krylov not in ('auto', 'bicgstab', 'gmres', 'fgmres'):
        no('krylov=%r' % (config.krylov,), "use 'auto', 'bicgstab', "
           "'gmres' or 'fgmres'")
    if config.mg_coarse not in ('inv', 'lu', 'iterative'):
        no('mg_coarse=%r' % (config.mg_coarse,), "use 'inv', 'lu' or "
           "'iterative'")
    if config.mg_smoother not in ('auto', 'line', 'jacobi'):
        no('mg_smoother=%r' % (config.mg_smoother,), "use 'auto', 'line' "
           "or 'jacobi'")
    if config.mg_nu1 < 0 or config.mg_nu2 < 0:
        raise ValueError('mg_nu1=%d, mg_nu2=%d: sweep counts must be >= 0'
                         % (config.mg_nu1, config.mg_nu2))
    if config.precond == 'mg':
        return
    if config.precond != 'hybrid':
        no('precond=%r' % (config.precond,), "use 'hybrid' or 'mg'")
    if config.fft_mode not in ('strat', '2d'):
        no('fft_mode=%r' % (config.fft_mode,), "use 'strat' or '2d'")
    if config.hybrid_comp not in ('fused', 'mult', 'add'):
        no('hybrid_comp=%r' % (config.hybrid_comp,), "use 'fused', "
           "'mult' or 'add'")
    if config.fft_scale not in (1, 2):
        no('fft_scale=%r' % (config.fft_scale,), 'the spectral solve runs '
           'at full (1) or half (2) resolution')
    if block_size == 2:
        # the block family ignores the x-panel and DFT options, as in the
        # JAX package
        return
    if config.strat_dft not in ('fft', 'dft', 'auto'):
        no('strat_dft=%r' % (config.strat_dft,), "use 'fft', 'dft' or "
           "'auto'")
    if config.strat_taper not in ('in', 'out', 'sym', 'dst'):
        no('strat_taper=%r' % (config.strat_taper,), "use 'in', 'out', "
           "'sym' or 'dst'")


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
    A prepared Helmholtz system: coefficient planes, the multigrid
    hierarchy of the shifted operator, the spectral interior solve
    (precond='hybrid': the stratified state, or the inverse interior
    symbol at fft_mode='2d'), the Galerkin-coarsened true planes (the
    fused cycle's level-1 residual operator) and, for transpose solves,
    the transposed hierarchy and planes.
    '''

    planes: Any            # (B, B, 9, nz, nx)
    hier: Any              # MGHierarchy of the shifted operator
    strat: Any = None      # StratPCR, or StratPCRBlock at B=2
                           # (precond='hybrid', fft_mode='strat')
    cplanes: Any = None    # (B, B, 9, nzc, nxc) (hybrid_comp='fused')
    hierT: Any = None      # MGHierarchy of the transposed shifted operator
    planesT: Any = None    # (B, B, 9, nz, nx) transposed true planes
    fft_sinv: Any = None   # (B, B, nz', nx') inverse interior symbol
                           # (precond='hybrid', fft_mode='2d')


def _interior_window(nz, nx):
    '''The central quarter window (z0, z1, x0, x1) of an nz x nx grid.'''
    return (nz // 4, max(nz // 4 + 1, (3 * nz) // 4),
            nx // 4, max(nx // 4 + 1, (3 * nx) // 4))


def _mean_interior_coeffs(planes):
    '''
    Mean stencil coefficients (B, B, 9) over the central quarter window,
    which excludes the boundary ring, the PML frame and free-surface rows
    for any sensible nPML < min(nz, nx) / 4.
    '''

    z0, z1, x0, x1 = _interior_window(*planes.shape[-2:])
    return torch.mean(planes[..., z0:z1, x0:x1], dim=(-2, -1))


def _fft_symbol_inverse(planes, precond_planes, config):
    '''
    Regularised inverse Fourier symbol of the constant-coefficient
    interior operator at the spectral CSLP shift ``config.fft_shift``
    (B <= 2): the port of the JAX package's function.

    With mean interior coefficients c0 of the true planes and cP of the
    ``config.shift``-shifted planes, the mass coefficients are
    cM = (c0 - cP) / shift and the symbol at the spectral shift is
    assembled from c0 - fft_shift * cM. ``fft_shift='auto'`` is 0.03j
    when the interior mass term's contrast is below 1.05 (near
    homogeneous media), else 0.25j, and always 0.25j for B=2. The symbol
    (its determinant for B=2) is clamped to ``fft_delta`` times its
    largest magnitude. The symbol is built by explicit multiply-add in
    the working dtype. Returns (B, B, nz, nx) pointwise inverse blocks.
    '''

    B = planes.shape[0]
    c0 = _mean_interior_coeffs(planes)
    cP = _mean_interior_coeffs(precond_planes)
    cdtype, rdtype = c0.dtype, c0.real.dtype
    dev = c0.device
    shift = torch.tensor(complex(config.shift), dtype=cdtype, device=dev)
    cM = (c0 - cP) / shift

    fft_shift = config.fft_shift
    if isinstance(fft_shift, str):      # 'auto'
        if B > 1:
            fs = torch.tensor(0.25j, dtype=cdtype, device=dev)
        else:
            z0, z1, x0, x1 = _interior_window(*planes.shape[-2:])
            mass = (planes[0, 0, CENTER, z0:z1, x0:x1]
                    - precond_planes[0, 0, CENTER, z0:z1, x0:x1]) / shift
            ma = torch.abs(mass)
            tiny = torch.finfo(rdtype).tiny
            contrast = torch.sqrt(torch.max(ma)
                                  / torch.clamp(torch.min(ma), min=tiny))
            im = torch.where(contrast < 1.05,
                             torch.tensor(0.03, dtype=rdtype, device=dev),
                             torch.tensor(0.25, dtype=rdtype, device=dev))
            fs = torch.complex(torch.zeros_like(im), im)
    else:
        fs = torch.tensor(complex(fft_shift), dtype=cdtype, device=dev)
    cF = c0 - fs * cM

    nz, nx = planes.shape[-2:]
    kz = (2 * np.pi) * torch.fft.fftfreq(nz, dtype=torch.float64,
                                         device=dev).to(rdtype)
    kx = (2 * np.pi) * torch.fft.fftfreq(nx, dtype=torch.float64,
                                         device=dev).to(rdtype)
    KZ, KX = torch.meshgrid(kz, kx, indexing='ij')
    sym = torch.zeros((B, B, nz, nx), dtype=cdtype, device=dev)
    for k, (dz, dx) in enumerate(OFFSETS):
        phase = torch.exp(1j * (KZ * dz + KX * dx)).to(cdtype)
        sym = sym + cF[:, :, k, None, None] * phase

    def clamp(d):
        a = torch.abs(d)
        dmin = config.fft_delta * torch.max(a)
        scale = torch.where(a < dmin, dmin / torch.clamp(a, min=1e-30),
                            torch.ones_like(a))
        return d * scale.to(d.dtype)

    if B == 1:
        return (1.0 / clamp(sym[0, 0]))[None, None]
    a, bb, c, d = sym[0, 0], sym[0, 1], sym[1, 0], sym[1, 1]
    det = clamp(a * d - bb * c)
    inv = torch.stack([torch.stack([d, -bb], 0), torch.stack([-c, a], 0)],
                      0)
    return inv / det


def _symbol_solver(sinv, transpose=False):
    '''
    The 2D-FFT spectral solve on a batch (R, B, nz, nx): ifft2(S fft2 r),
    or for the transpose fft2(S^T ifft2 r) with S^T = sinv with its block
    axes swapped (the DFT matrix is symmetric). The block product is an
    explicit multiply-add.
    '''

    if transpose:
        sinv = sinv.transpose(0, 1)
    fwd, inv = ((torch.fft.ifft2, torch.fft.fft2) if transpose
                else (torch.fft.fft2, torch.fft.ifft2))

    def P0(r):
        R = fwd(r)
        outs = []
        for i in range(sinv.shape[0]):
            acc = None
            for j in range(sinv.shape[1]):
                term = sinv[i, j] * R[:, j]
                acc = term if acc is None else acc + term
            outs.append(acc)
        return inv(torch.stack(outs, dim=1))
    return P0


def prepare_operator(planes, precond_planes=None, config=SolverConfig(),
                     with_transpose=True, interior_mask=None):
    '''
    Build a HelmholtzOperator from true planes and the planes of the
    complex-shifted operator (default: the true planes). The multigrid
    hierarchy comes from the shifted planes; the hybrid preconditioner's
    spectral solve (stratified or, at ``fft_mode='2d'``, the inverse
    interior symbol) is built from the fine true and shifted planes
    (fft_scale=1) or from their Galerkin-coarsened operators
    (fft_scale=2). ``with_transpose`` adds the transposed hierarchy and
    planes that the backward of ``solve`` needs. ``interior_mask``
    ((nz, nx) in {0, 1}) marks extra rows to keep out of the coarse-grid
    correction (see ``multigrid.build_hierarchy``), in the hierarchy and
    in the Galerkin-coarsened true planes. Everything but the planes
    themselves is built from detached tensors: the preconditioner takes
    no part in differentiation. With tracing on, the span of the
    preparation closes after a device synchronise, so it times the work.

    Block (B=2) operators smooth with alternating z/x lines unless
    ``mg_smoother='jacobi'``. Their stratified solve is the block
    family built from the FINE planes at every ``fft_scale`` (the JAX
    package measured the Galerkin-coarsened block symbol to stall the
    outer iteration), so there is no coarsened true operator and the
    fused composition falls through to 'mult'; their 2D-FFT symbol solve
    follows the scalar rules.
    '''

    with span('helmholtz.prepare_operator'):
        op = _prepare_operator(planes, precond_planes, config,
                               with_transpose, interior_mask)
        if enabled() and planes.is_cuda:
            torch.cuda.synchronize(planes.device)
    return op


def _prepare_operator(planes, precond_planes, config, with_transpose,
                      interior_mask):
    B = planes.shape[0]
    check_config(config, B)
    if precond_planes is None:
        precond_planes = planes
    pp = precond_planes.detach()
    tp = planes.detach()
    imask = None if interior_mask is None else interior_mask.detach()
    smoother = ('line' if B > 1 and config.mg_smoother in ('auto', 'line')
                else 'jacobi')
    with span('multigrid.build_hierarchy'):
        hier = build_hierarchy(pp, min_size=config.mg_min_size,
                               coarse=config.mg_coarse, smoother=smoother,
                               interior_mask=imask)
    hierT = transpose_hierarchy(hier) if with_transpose else None
    if config.precond == 'mg':
        return HelmholtzOperator(planes, hier, hierT=hierT)
    planesT = transpose_block_planes(tp) if with_transpose else None
    if B == 2 and config.fft_mode == 'strat':
        with span('stratified.precompute'):
            strat = pcr_precompute_block(*stratified_coeffs_block(
                tp, pp, config.shift, config.fft_shift))
        return HelmholtzOperator(planes, hier, strat, None, hierT, planesT)

    ctrue = None
    if config.fft_scale > 1 or config.hybrid_comp == 'fused':
        with span('helmholtz.coarsen_true'):
            nz, nx = tp.shape[-2:]
            mask = _ring_mask(nz, nx, tp.real.dtype, tp.device)
            if imask is not None:
                mask = mask * imask.to(mask.dtype)
            ctrue = _fix_empty_rows(galerkin_coarsen(
                _mask_ring_planes(tp, mask)))
            if len(hier.levels) > 1:
                cpp = hier.levels[1].planes
            else:
                cpp = _fix_empty_rows(galerkin_coarsen(
                    _mask_ring_planes(pp, mask)))
    if config.fft_scale > 1:
        src_true, src_pp = ctrue, cpp
    else:
        src_true, src_pp = tp, pp
    cplanes = ctrue if config.hybrid_comp == 'fused' else None
    if config.fft_mode == '2d':
        return HelmholtzOperator(
            planes, hier, None, cplanes, hierT, planesT,
            _fft_symbol_inverse(src_true, src_pp, config))
    with span('stratified.precompute'):
        if config.strat_panels > 1:
            l, d, u = stratified_coeffs_panels(
                src_true, src_pp, config.shift, config.fft_shift,
                config.strat_panels, config.strat_overlap,
                dst=config.strat_taper == 'dst')
            w_solve = panel_layout(src_true.shape[-1], config.strat_panels,
                                   config.strat_overlap)[1]
            if config.strat_taper == 'dst':
                w_solve *= 2
        else:
            l, d, u = stratified_coeffs(src_true, src_pp, config.shift,
                                        config.fft_shift)
            w_solve = src_true.shape[-1]
        use_dft = (config.strat_dft == 'dft'
                   or (config.strat_dft == 'auto' and w_solve <= 2048))
        strat = pcr_precompute(l, d, u, dft=w_solve if use_dft else None)
    return HelmholtzOperator(planes, hier, strat, cplanes, hierT, planesT)


def _make_precond(op, config, transpose=False):
    '''
    The preconditioner application r -> M r on a batch (R, B, nz, nx).

    'mg': one V-cycle on the shifted hierarchy.
    'hybrid', hybrid_comp='fused' (forward, two or more levels, spectral
        solve at half resolution): ONE cycle in which the spectral
        interior solve is the level-1 coarse-grid boost — fine pre-smooth
        and restricted residual, xc = P rc, the residual against the
        Galerkin-coarsened TRUE operator, a V-cycle from level 1, then
        prolong, add and the fine post-smooth.
    'hybrid', hybrid_comp='add': M r = P r + V r.
    'hybrid', otherwise ('mult'): M r = P r + V (r - A P r).
    In 'add' and 'mult' P is the spectral solve at full resolution or, at
    fft_scale=2, mask P_2h S_c R_2h mask between the transfer operators
    (K7). The spectral solve is the stratified one or, for an operator
    with ``fft_sinv``, the 2D-FFT symbol solve.

    With ``transpose=True`` the same construction from the transposed
    parts, e.g. P^T + V^T (I - A^T P^T): a preconditioner FOR the
    transposed operator (the JAX package's choice; the fused cycle falls
    back to 'mult'). P^T = F T^{-T} F^{-1}, the transposed tridiagonal
    (or, for a block operator, block-tridiagonal) family reduced once
    here in full precision; for the symbol solve fft2(S^T ifft2 r).
    Each application is a span ``precond.apply``.
    '''

    M = _compose_precond(op, config, transpose)

    def apply(r):
        with span('precond.apply'):
            return M(r)
    return apply


def _compose_precond(op, config, transpose):
    is_block = op.planes.shape[0] == 2
    check_config(config, op.planes.shape[0])
    hier = op.hierT if transpose else op.hier
    if hier is None:
        raise ValueError('operator was prepared with with_transpose=False: '
                         'it has no transpose preconditioner')
    omega, nu1, nu2 = config.mg_omega, config.mg_nu1, config.mg_nu2
    coarse_iters = config.mg_coarse_iters

    def mg(r):
        return v_cycle(hier, r, omega=omega, nu1=nu1, nu2=nu2,
                       coarse_iters=coarse_iters)

    has_spec = op.strat is not None or op.fft_sinv is not None
    if config.precond == 'mg' or not has_spec:
        if config.precond != 'mg':
            raise ValueError("operator was prepared without the hybrid "
                             "solve; use precond='mg'")
        return mg

    planes = (op.planesT if transpose else op.planes).detach()
    nzf, nxf = planes.shape[-2:]
    if op.fft_sinv is not None:
        spec_nz = op.fft_sinv.shape[-2]
        P0 = _symbol_solver(op.fft_sinv, transpose)
    else:
        strat = op.strat
        if transpose:
            strat = (transpose_pcr_block if is_block
                     else transpose_pcr)(strat)
        # the spectral solve runs on the fine grid or (fft_scale=2) the
        # Galerkin-coarsened one; panel bands are P*W wide, so key on nz
        spec_nz = op.strat.ldu.shape[-2]
        spec_nx = nxf if spec_nz == nzf else (nxf + 1) // 2
        if is_block:
            def P0(r):
                return stratified_apply_block(strat, r, transpose=transpose)
        elif config.strat_panels > 1:
            P0 = panel_solver(strat, spec_nx, config.strat_panels,
                              config.strat_overlap, transpose=transpose,
                              taper=config.strat_taper)
        else:
            def P0(r):
                return stratified_apply(strat, r, transpose=transpose)

    if (config.hybrid_comp == 'fused' and not transpose
            and op.cplanes is not None and len(hier.levels) > 1
            and spec_nz != nzf):
        lvl0 = hier.levels[0]
        cpl = op.cplanes

        def M(r):
            with span('precond.fine'):
                u, rc = presmooth_restrict(lvl0, r, omega, nu1)
            with span('precond.spectral'):
                xc = P0(rc)
            with span('precond.coarse'):
                rc2 = rc - apply_block_stencil_fast(cpl, xc)
                xc = xc + v_cycle(hier, rc2, omega=omega, nu1=nu1, nu2=nu2,
                                  level=1, coarse_iters=coarse_iters)
            with span('precond.fine'):
                return prolong_add_smooth(lvl0, u, r, xc, omega, nu2)

        return M

    if spec_nz == nzf:
        P = P0
    else:
        # the reduced-resolution spectral solve: Q = P_2h S_c R_2h, whose
        # transpose is P_2h S_c^T R_2h because R = (1/4) P^T exactly
        maskP = hier.levels[0].mask

        def P(r):
            return maskP * prolong(P0(restrict(maskP * r)), nzf, nxf)

    if config.hybrid_comp == 'add':
        def M(r):
            with span('precond.spectral'):
                x1 = P(r)
            with span('precond.vcycle'):
                return x1 + mg(r)
        return M

    def M(r):
        with span('precond.spectral'):
            x1 = P(r)
        with span('precond.vcycle'):
            r2 = r - apply_block_stencil_fast(planes, x1)
            return x1 + mg(r2)

    return M


def _effective_krylov(config, block_size):
    '''
    Resolve krylov='auto': BiCGStab for scalar (B=1) operators, GMRES for
    block systems (BiCGStab's short recurrence diverges on the Eurus TTI
    2x2 system in complex64; restarted GMRES is monotone).
    '''

    if config.krylov != 'auto':
        return config.krylov
    return 'gmres' if block_size > 1 else 'bicgstab'


def _inner_precond(matvec, M, config):
    '''
    The FGMRES variable preconditioner: ``fgmres_inner`` steps of inner
    GMRES on the same operator, preconditioned by the base M (0: M
    itself). Nonlinear in r, so legal only inside flexible GMRES.
    '''

    inner = int(config.fgmres_inner)
    if inner <= 0:
        return M

    def Mv(r):
        return gmres_cycle(matvec, r, M=M, m=inner).x
    return Mv


def _krylov_solve(matvec, b, M, config, block_size):
    '''
    One Krylov run of the configured method on a batch b (R, B, nz, nx)
    to ``config.tol``: BicgstabResult(x, iters (R,), relres (R,)).

    BiCGStab runs the eager recurrence here on the card too, not K11: an
    unrestarted run never checks its true residual, and in complex64 how
    far that drifts from the recursive one follows rounding, which K11's
    summation order changes (on a 512^2 2.5D Marmousi solve, two ky
    solves that the eager rounding ends near 1e-4 end at true relres 4.6e4
    and 1.7e5 with K11's). ``make_chunked_solver`` restarts on the true
    residual and takes K11.
    '''

    krylov = _effective_krylov(config, block_size)
    if krylov == 'fgmres':
        return fgmres(matvec, b, M=_inner_precond(matvec, M, config),
                      tol=config.tol, maxiter=config.maxiter,
                      restart=config.gmres_restart)
    if krylov == 'gmres':
        return gmres(matvec, b, M=M, tol=config.tol,
                     maxiter=config.maxiter, restart=config.gmres_restart)
    return bicgstab(matvec, b, M=M, tol=config.tol, maxiter=config.maxiter,
                    fused=False)


class _LinearSolve(torch.autograd.Function):
    '''
    x = A(planes)^{-1} b by the preconditioned Krylov method of the
    config, with the implicit derivatives of ``lax.custom_linear_solve``.

    Forward mode (``jvp``): dx = A^{-1} (db - dA x), one more solve with
    the same operator and forward preconditioner; dA x is the stencil
    apply of the tangent planes (K1, or K8 for a block operator).

    Reverse mode (``backward``): torch hands g = dL/d conj(x); the
    cotangent of b is w = A^{-H} g = conj(A^{-T} conj(g)), one transpose
    solve with the transpose preconditioner, and that of the block planes
    is -sum_r w_r[i] conj(x_r[j][. + s_k]) (``block_plane_products``).

    The solve reads ``op`` (prepared from detached planes); ``planes`` is
    the differentiable input that carries the derivatives.
    '''

    @staticmethod
    def forward(ctx, planes, b, op, config):
        x = solve_info(op, b, config)[0]
        ctx.op, ctx.config = op, config
        ctx.save_for_backward(x)
        ctx.save_for_forward(x)
        return x

    @staticmethod
    def jvp(ctx, dplanes, db, _op, _config):
        x, = ctx.saved_tensors
        op, config = ctx.op, ctx.config
        rhs = torch.zeros_like(x) if db is None else db.resolve_conj()
        if dplanes is not None:
            dp = dplanes.resolve_conj().contiguous()
            rhs = rhs - apply_block_stencil_fast(dp, x)
        return solve_info(op, rhs.contiguous(), config)[0]

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        op, config = ctx.op, ctx.config
        MT = _make_precond(op, config, transpose=True)
        planesT = transpose_block_planes(op.planes.detach())
        # conj_physical: the kernels read raw memory, never a conj view
        w = _krylov_solve(lambda v: apply_block_stencil_fast(planesT, v),
                          g.conj_physical(), MT, config,
                          op.planes.shape[0]).x.conj_physical()
        gp = None
        if ctx.needs_input_grad[0]:
            gp = -block_plane_products(w, x.conj())
        gb = w if ctx.needs_input_grad[1] else None
        return gp, gb, None, None


def solve_batched(op, b, config=SolverConfig(), planes=None):
    '''
    Solve A x = b for a batch b (R, B, nz, nx) to ``config.tol``;
    differentiable in forward and reverse mode with respect to the planes
    and ``b``, for scalar and block operators (reverse mode needs an
    operator prepared ``with_transpose=True``). The planes that carry the
    derivatives are ``op.planes``, or ``planes`` when given: the same
    values, for an operator prepared from detached planes (the kernels
    read raw memory, so a forward-mode tangent must not reach them).
    '''

    return _LinearSolve.apply(op.planes if planes is None else planes, b,
                              op, config)


def solve_batched_jit(op, b_batch, config):
    '''
    The JAX package's jitted entry point for repeated host-driven solves.
    The port compiles nothing per call, so this is ``solve_batched``.
    '''

    return solve_batched(op, b_batch, config)


def solve(op, b, config=SolverConfig()):
    '''
    Solve A x = b for a single right-hand side b (B, nz, nx), with
    implicit differentiation (see ``solve_batched``).
    '''

    return solve_batched(op, b[None], config)[0]


def solve_info(op, b, config=SolverConfig()):
    '''
    Forward solve of a batch b (R, B, nz, nx) to ``config.tol`` in one
    run of the configured Krylov method. Returns (x, iters (R,), relres
    (R,)). Not differentiable.
    '''

    def mv(x):
        return apply_block_stencil_fast(op.planes, x)

    res = _krylov_solve(mv, b, _make_precond(op, config), config,
                        op.planes.shape[0])
    return res.x, res.iters, res.relres


def make_chunked_solver(config=SolverConfig(), chunk=64):
    '''
    Host-driven restarted solve: BiCGStab runs in chunks of at most
    ``chunk`` iterations (GMRES and FGMRES in one cycle of ``chunk``
    Arnoldi steps); between chunks the TRUE residual is recomputed and
    the iteration restarts from the current iterate (which removes the
    recursive-residual drift of single-precision BiCGStab).

    Returns ``solve(op, b_batch, max_chunks=None, trace=None) -> (x,
    iters, relres)`` with b_batch (R, B, nz, nx) a tensor on the
    operator's device, iters the summed per-chunk maximum iteration count
    and relres the worst true relative residual over the batch; a
    ``trace`` list receives each chunk's (iterations, worst relres). With
    tracing on, each chunk's span also gets the iterations and the true
    relres of every right-hand side (``lane_iters``, ``lane_relres``),
    read in the same transfer as the worst relres.

    The BiCGStab chunk tolerance is rescaled so the stop target stays
    tol * ||b|| globally (with a 0.7 margin for recursive-vs-true residual
    drift). If a restart makes the true residual non-finite, or (GMRES,
    FGMRES) more than 4x worse than the best so far, the best iterate is
    kept and the solve stops; a non-finite FIRST chunk keeps the
    pre-chunk iterate (zeros) and returns its non-finite relres. A
    BiCGStab chunk that leaves the true residual more than 4x worse than
    the best goes back to the best iterate, and the chunks from there on
    run twice as long: BiCGStab's residual is erratic, and a chunk cut
    where one lane's is high would otherwise end the solve above tol. The
    budget is ``max_chunks * chunk`` iterations either way.
    '''

    margin = 0.7

    def chunk_step(op, b, x, M, sp, length):
        '''
        One chunk of ``length`` iterations from the iterate x: (new
        iterate, worst true relres, iterations), each read to the host.
        '''
        def mv(v):
            return apply_block_stencil_fast(op.planes, v)

        r = b - mv(x)
        bnorm0 = _norm(b)
        krylov = _effective_krylov(config, b.shape[-3])
        if krylov == 'fgmres':
            res = fgmres_cycle(mv, r, M=_inner_precond(mv, M, config),
                               m=length)
        elif krylov == 'gmres':
            res = gmres_cycle(mv, r, M=M, m=length)
        else:
            rnorm = _norm(r)
            tiny = torch.finfo(rnorm.dtype).tiny
            tol_c = (margin * config.tol * bnorm0
                     / torch.clamp(rnorm, min=tiny))
            res = bicgstab(mv, r, M=M, tol=tol_c, maxiter=length)
        x = x + res.x
        bnorm = torch.where(bnorm0 > 0, bnorm0, torch.ones_like(bnorm0))
        with span('helmholtz.true_residual'):
            rr = _norm(b - mv(x)) / bnorm
            if enabled():
                # the lanes' iterations and relres ride with the worst
                n = rr.shape[0]
                host = torch.cat([torch.max(rr).reshape(1), rr,
                                  res.iters.to(rr.dtype)]).cpu()
                worst = float(host[0])
                sp.set(lane_iters=[int(v) for v in host[1 + n:]],
                       lane_relres=host[1:1 + n].tolist())
            else:
                worst = float(torch.max(rr))
            add('solver.syncs')
        its = int(torch.max(res.iters))
        add('solver.syncs')
        return x, worst, its

    def solve_chunked(op, b_batch, max_chunks=None, trace=None):
        if max_chunks is None:
            max_chunks = max(1, config.maxiter // chunk)
        with span('helmholtz.solve', R=b_batch.shape[0], chunk=chunk):
            M = _make_precond(op, config)
            bicg = _effective_krylov(config, b_batch.shape[-3]) == 'bicgstab'
            x = torch.zeros_like(b_batch)
            iters = 0
            worst = None
            best = None
            length, left = chunk, max_chunks * chunk
            while left > 0:
                length = min(length, left)
                with span('helmholtz.chunk') as sp:
                    x_new, worst, its = chunk_step(op, b_batch, x, M, sp,
                                                   length)
                    sp.set(iterations=its, relres=worst)
                left -= length
                iters += its
                if trace is not None:
                    trace.append((its, worst))
                worse = best is not None and worst > 4.0 * best[1]
                if bicg and worse and np.isfinite(worst):
                    # the restart made the TRUE residual materially
                    # worse: back to the best iterate, longer chunks
                    x, worst = best
                    length *= 2
                    continue
                if not np.isfinite(worst) or worse:
                    # non-finite, or worse after a GMRES cycle: keep the
                    # best iterate (or, on the first chunk, the pre-chunk
                    # iterate) and stop
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
