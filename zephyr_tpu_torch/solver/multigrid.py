'''
Geometric multigrid with Galerkin (RAP) coarse operators, matrix-free.

The port of ``zephyr_tpu.solver.multigrid`` for scalar (B=1) and 2x2
block (B=2, TTI) operators:

- coarse-grid operators by exact stencil-space Galerkin coarsening R A P
  (full-weighting restriction, bilinear prolongation), which stays within
  the 9-point stencil class;
- scalar levels: damped Jacobi smoothing at any sweep counts, fused into
  the level's downstroke (kernel K2 at nu1 = 1, 2; else sweeps, residual
  and restriction) and upstroke (kernel K4), further sweeps two at a
  time (K6) and one left over (K5); the downstroke without the
  restriction at nu1 = 2 is kernel K9 (``presmooth_residual``);
- block levels: alternating z/x line smoothing (``smoother='line'``,
  exact damped solves of the tridiagonal band splittings by precomputed
  block PCR) or damped block-Jacobi, each sweep's residual through the
  block apply (kernel K8), the residual restricted and the correction
  prolonged by K7;
- standalone full-weighting restriction and bilinear prolongation
  (kernel K7) for the reduced-resolution spectral solve;
- the hierarchy of the transposed operator (``transpose_hierarchy``);
- the coarsest level solved directly with a dense inverse (one matmul)
  or dense LU factors, computed once at preparation time.

The hierarchy is a pair of NamedTuples of tensors; the right-hand-side
batch is the explicit leading axis of every field, (R, B, nz, nx).
'''

from typing import NamedTuple, Any

import torch

from ..ops import cuda_kernels, stencil
from ..ops.stencil import (apply_block_stencil_fast, block_diag,
                           block_diag_matvec, invert_block_diag,
                           planes_to_dense_torch, shift2d)
from .stratified import pcr_apply_block, pcr_precompute_block

#: per-axis prolongation weights for offsets (-1, 0, +1)
_W = (0.5, 1.0, 0.5)


def _coarse_extent(n):
    'Number of coarse points for vertex-centred 2:1 coarsening.'
    return (n + 1) // 2


def _strided_gather(plane, az, ax, nzc, nxc):
    '''
    Return plane[2I+az, 2J+ax] for coarse indices (I, J), zero outside.
    ``plane`` has shape (..., nz, nx).
    '''

    padded = stencil._pad1(plane)
    return padded[..., 1 + az:1 + az + 2 * (nzc - 1) + 1:2,
                  1 + ax:1 + ax + 2 * (nxc - 1) + 1:2]


def galerkin_coarsen_scalar(planes):
    '''
    Exact stencil-space Galerkin coarsening of a scalar (9, nz, nx) operator:
    A_c = R A P with full-weighting R = (1/4) P^T and bilinear P:

        A_c[d](I,J) = sum_{a, s : a' = a + s - 2d in [-1,1]^2}
            (1/4) w(a) w(a') planes[s][2I + a_z, 2J + a_x]

    The input planes are sanitized first so that the stencil-space product
    matches the dense R A P exactly, including at boundaries.
    '''

    planes = stencil.sanitize_planes(planes)
    nz, nx = planes.shape[-2:]
    nzc, nxc = _coarse_extent(nz), _coarse_extent(nx)

    out = []
    for dz in (-1, 0, 1):
        for dx in (-1, 0, 1):
            acc = torch.zeros((nzc, nxc), dtype=planes.dtype,
                              device=planes.device)
            for az in (-1, 0, 1):
                for sz in (-1, 0, 1):
                    apz = az + sz - 2 * dz
                    if apz < -1 or apz > 1:
                        continue
                    wz = _W[az + 1] * _W[apz + 1]
                    for ax in (-1, 0, 1):
                        for sx in (-1, 0, 1):
                            apx = ax + sx - 2 * dx
                            if apx < -1 or apx > 1:
                                continue
                            w = 0.25 * wz * _W[ax + 1] * _W[apx + 1]
                            k = (sz + 1) * 3 + (sx + 1)
                            acc = acc + w * _strided_gather(
                                planes[k], az, ax, nzc, nxc)
            out.append(acc)
    return torch.stack(out, dim=0)


def galerkin_coarsen(planes):
    'Galerkin coarsening of block planes (B, B, 9, nz, nx).'

    B = planes.shape[0]
    rows = []
    for i in range(B):
        cols = [galerkin_coarsen_scalar(planes[i, j]) for j in range(B)]
        rows.append(torch.stack(cols, dim=0))
    return torch.stack(rows, dim=0)


def _restrict_ref(v):
    '''
    Full-weighting restriction of (..., nz, nx) to the coarse grid:
    out[I, J] = 0.25 sum_{a,b} w(a) w(b) v[2I+a, 2J+b], zero outside.
    A separable [0.5, 1, 0.5] tent filter followed by decimation.
    '''

    nz, nx = v.shape[-2:]
    t = v + 0.5 * (shift2d(v, 1, 0) + shift2d(v, -1, 0))
    t = t + 0.5 * (shift2d(t, 0, 1) + shift2d(t, 0, -1))
    t = 0.25 * t
    return t[..., 0::2, 0::2]


def _prolong_ref(vc, nz, nx):
    '''
    Bilinear prolongation of (..., nzc, nxc) onto the (nz, nx) fine grid:
    zero-interleave onto (2 nzc, 2 nxc), separable tent filter
    [0.5, 1, 0.5] per axis, crop to (nz, nx).
    '''

    nzc, nxc = vc.shape[-2:]
    zz = torch.zeros(vc.shape[:-2] + (2 * nzc, 2 * nxc), dtype=vc.dtype,
                     device=vc.device)
    zz[..., 0::2, 0::2] = vc
    out = zz + 0.5 * (shift2d(zz, 1, 0) + shift2d(zz, -1, 0))
    out = out + 0.5 * (shift2d(out, 0, 1) + shift2d(out, 0, -1))
    return out[..., :nz, :nx]


def _flat_batch(v):
    '(..., nz, nx) -> (N, nz, nx) contiguous, for a batched kernel.'
    return v.reshape((-1,) + tuple(v.shape[-2:])).contiguous()


def restrict(v):
    '''
    Full-weighting restriction of (..., nz, nx) to the coarse grid (see
    ``_restrict_ref``): the twin on the CPU, kernel K7 on the card.
    '''

    if stencil._on_cpu(v):
        return _restrict_ref(v)
    out = cuda_kernels.restrict(_flat_batch(v))
    return out.reshape(v.shape[:-2] + out.shape[-2:])


def prolong(vc, nz, nx):
    '''
    Bilinear prolongation of (..., nzc, nxc) onto the (nz, nx) fine grid
    (see ``_prolong_ref``): the twin on the CPU, kernel K7 on the card.
    '''

    if stencil._on_cpu(vc):
        return _prolong_ref(vc, nz, nx)
    out = cuda_kernels.prolong(_flat_batch(vc), nz, nx)
    return out.reshape(vc.shape[:-2] + (nz, nx))


class MGLevel(NamedTuple):
    planes: Any   # (B, B, 9, nz, nx)
    dinv: Any     # (B, B, nz, nx)
    mask: Any     # (nz, nx) interior mask: 0 on the boundary ring
    linez: Any = None  # StratPCRBlock of the z-line bands
    linex: Any = None  # StratPCRBlock of the x-line bands (axes swapped);
                       # present iff smoother='line' on a block level


class MGHierarchy(NamedTuple):
    levels: Any        # tuple of MGLevel, fine -> coarse
    coarse_lu: Any     # LU factors of the coarsest dense operator
    coarse_piv: Any    # their (1-based, LAPACK) pivots
    coarse_inv: Any = None  # explicit dense inverse (coarse='inv')


def _ring_mask(nz, nx, dtype, device='cpu'):
    m = torch.ones((nz, nx), dtype=dtype, device=device)
    m[0, :] = 0
    m[-1, :] = 0
    m[:, 0] = 0
    m[:, -1] = 0
    return m


def _mask_ring_planes(planes, mask):
    '''
    The operator diag(m) A diag(m) in stencil space: zero the plane rows on
    the boundary ring and every entry that points into the ring, which
    decouples the Dirichlet rows from the coarse-grid correction.
    '''

    B = planes.shape[0]
    out = []
    for i in range(B):
        row = []
        for j in range(B):
            ps = []
            for k, (dz, dx) in enumerate(stencil.OFFSETS):
                ps.append(planes[i, j, k] * mask * shift2d(mask, dz, dx))
            row.append(torch.stack(ps, dim=0))
        out.append(torch.stack(row, dim=0))
    return torch.stack(out, dim=0)


def _fix_empty_rows(planes):
    '''
    Give any all-but-empty row of a Galerkin coarse operator a unit
    diagonal so the coarsest dense solve stays nonsingular; rows with
    genuine restricted content are left untouched.
    '''

    B = planes.shape[0]
    out = planes.clone()
    for i in range(B):
        d = out[i, i, 4]
        rowmag = sum(torch.abs(out[i, j, k])
                     for j in range(B) for k in range(9))
        empty = rowmag < 1e-30
        out[i, i, 4] = torch.where(empty, torch.ones_like(d), d)
    return out


def _line_pcr_states(planes, delta=1e-6):
    '''
    Precomputed block cyclic-reduction states of the z-line and x-line
    band splittings of a block operator, the alternating-line smoother's
    tridiagonal factors: the z bands are the (dz in {-1, 0, 1}, dx = 0)
    planes 1/4/7 with their true per-point coefficients, the x bands the
    (dz = 0, dx in {-1, 0, 1}) planes 3/4/5 with the grid axes swapped.
    complex64 factors are bf16-packed (the JAX package's defaults: clamp
    1e-6, quantised, both axes).
    '''

    linez = pcr_precompute_block(planes[:, :, 1], planes[:, :, 4],
                                 planes[:, :, 7], delta=delta)
    xb = [planes[:, :, k].transpose(-1, -2) for k in (3, 4, 5)]
    return linez, pcr_precompute_block(*xb, delta=delta)


def build_hierarchy(planes, min_size=16, max_levels=16, coarse='lu',
                    smoother='jacobi'):
    '''
    Build a multigrid hierarchy from (B, B, 9, nz, nx) planes. Coarsens by
    2x per level until min(nz, nx) <= min_size, then inverts
    (coarse='inv') or LU-factorizes (coarse='lu') the coarsest dense
    operator. Boundary-ring dofs are excluded from the coarse-grid
    correction at every level.

    ``smoother='line'`` precomputes per-level alternating z/x line
    states for block (B > 1) operators; scalar operators always smooth
    with the fused Jacobi kernels, so there it is the same as 'jacobi'.
    '''

    if smoother not in ('jacobi', 'line'):
        raise ValueError("build_hierarchy: smoother must be 'jacobi' or "
                         "'line', got %r" % (smoother,))
    if coarse not in ('inv', 'lu'):
        raise NotImplementedError(
            "build_hierarchy: coarse=%r; the port has 'inv' and 'lu' "
            "(the iterative coarse solve is not ported)" % (coarse,))
    rdtype = planes.real.dtype
    levels = []
    current = planes
    for lev in range(max_levels):
        nz, nx = current.shape[-2:]
        mask = _ring_mask(nz, nx, rdtype, planes.device)
        dinv = invert_block_diag(block_diag(current))
        linez = linex = None
        if smoother == 'line' and current.shape[0] > 1:
            linez, linex = _line_pcr_states(current)
        levels.append(MGLevel(current, dinv, mask, linez, linex))
        if min(nz, nx) <= min_size:
            break
        masked = _mask_ring_planes(current, mask)
        current = _fix_empty_rows(galerkin_coarsen(masked))

    lu, piv, cinv = None, None, None
    dense = planes_to_dense_torch(levels[-1].planes)
    if coarse == 'lu':
        lu, piv = torch.linalg.lu_factor(dense)
    else:
        cinv = torch.linalg.inv(dense)
    return MGHierarchy(tuple(levels), lu, piv, cinv)


def _coarse_solve(hier, b):
    '''
    Direct coarsest-level solve of a batch b (R, B, nz, nx). The inverse
    is applied as one full-f32 (or f64) matmul: on CUDA the TF32 matmul
    shortcut would keep ~3 digits, so it must be off.
    '''

    R = b.shape[0]
    if b.device.type == 'cuda' and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError('coarse solve: torch.backends.cuda.matmul.'
                           'allow_tf32 must be False (full f32 matmul)')
    flat = b.reshape(R, -1)
    if hier.coarse_inv is not None:
        x = torch.matmul(flat, hier.coarse_inv.T)
    else:
        x = torch.linalg.lu_solve(hier.coarse_lu, hier.coarse_piv,
                                  flat.T).T
    return x.contiguous().reshape(b.shape)


#: damping of the alternating-line smoother (the JAX package's measured
#: choice: 1.0 diverges on layered TTI, 0.8 converges fastest)
LINE_OMEGA = 0.8


def _smooth(lvl, u, b, omega, nsweeps, from_zero=False):
    '''
    ``nsweeps`` damped smoothing sweeps of a level. A scalar level runs
    fused damped-Jacobi sweeps: two at a time (K6; from zero when
    ``from_zero`` says the incoming u is all zero, which saves reading
    it), and one (K5) for an odd sweep left over. A block level computes
    each residual through the block apply (K8 on the card): alternating
    z/x line sweeps (damped by LINE_OMEGA) when the level carries line
    states, else damped block-Jacobi.
    '''

    if lvl.planes.shape[0] == 1:
        dinv_eff = omega * lvl.dinv[0, 0]
        planes, bb, u0 = lvl.planes[0, 0], b[:, 0], u[:, 0]
        remaining = nsweeps
        if from_zero and remaining >= 2:
            u0 = stencil.jacobi_sweep2_batched(planes, dinv_eff, bb)
            remaining -= 2
        while remaining >= 2:
            u0 = stencil.jacobi_sweep2_batched(planes, dinv_eff, bb, u0)
            remaining -= 2
        if remaining:
            u0 = stencil.jacobi_sweep_batched(planes, dinv_eff, bb, u0)
        return u0[:, None]
    for _ in range(nsweeps):
        r = b - apply_block_stencil_fast(lvl.planes, u)
        if lvl.linez is None:
            u = u + omega * block_diag_matvec(lvl.dinv, r)
            continue
        u = u + LINE_OMEGA * pcr_apply_block(lvl.linez, r)
        r = b - apply_block_stencil_fast(lvl.planes, u)
        du = pcr_apply_block(lvl.linex, r.transpose(-1, -2))
        u = u + LINE_OMEGA * du.transpose(-1, -2)
    return u


def presmooth_residual(lvl, b, omega, nu1):
    '''
    The downstroke of a level before the transfer: nu1 smoothing sweeps
    from zero and the masked residual (u, mask * (b - A u)). A scalar
    level at nu1 = 2 runs it as one kernel (K9); otherwise the sweeps
    (``_smooth``) and the residual through the operator apply (K1 or K8).
    '''

    if lvl.planes.shape[0] == 1 and nu1 == 2:
        u0, resm = stencil.presmooth_residual_batched(
            lvl.planes[0, 0], omega * lvl.dinv[0, 0], lvl.mask, b[:, 0])
        return u0[:, None], resm[:, None]
    u = _smooth(lvl, torch.zeros_like(b), b, omega, nu1, from_zero=True)
    return u, lvl.mask * (b - apply_block_stencil_fast(lvl.planes, u))


def presmooth_restrict(lvl, b, omega, nu1):
    '''
    The complete downstroke of a level, (u, restrict(mask * residual)).
    A scalar level at nu1 = 1 or 2 runs the sweeps from zero, the masked
    residual and its restriction as one kernel (K2); other sweep counts
    and block levels run ``presmooth_residual`` and the restriction K7.
    Returns (u, rc) with u (R, B, nz, nx).
    '''

    if lvl.planes.shape[0] != 1 or nu1 not in (1, 2):
        u, rm = presmooth_residual(lvl, b, omega, nu1)
        return u, restrict(rm)
    u0, rc = stencil.presmooth_restrict_batched(
        lvl.planes[0, 0], omega * lvl.dinv[0, 0], lvl.mask, b[:, 0], nu1)
    return u0[:, None], rc[:, None]


def prolong_add_smooth(lvl, u, b, ec, omega, nu2):
    '''
    The upstroke of a level: u + mask * prolong(ec), then nu2 damped
    post-smoothing sweeps. A scalar level with nu2 >= 1 runs the
    prolongation, the masked add and the first sweep as one kernel (K4),
    then the other nu2 - 1 sweeps two at a time (K6) and an odd one left
    over (K5). Otherwise (a block level, or nu2 = 0) it prolongs with K7
    and smooths with ``_smooth``.
    '''

    if lvl.planes.shape[0] != 1 or nu2 < 1:
        nz, nx = b.shape[-2:]
        return _smooth(lvl, u + lvl.mask * prolong(ec, nz, nx), b, omega,
                       nu2)
    u0 = stencil.prolong_add_smooth_batched(
        lvl.planes[0, 0], omega * lvl.dinv[0, 0], lvl.mask, b[:, 0],
        u[:, 0], ec[:, 0])
    return _smooth(lvl, u0[:, None], b, omega, nu2 - 1)


def v_cycle(hier, b, omega=0.6, nu1=2, nu2=2, level=0):
    '''
    One multigrid V-cycle for the (shifted) operator; returns an
    approximate solution of A x = b with zero initial guess for a batch
    b of shape (R, B, nz, nx).
    '''

    if level == len(hier.levels) - 1:
        return _coarse_solve(hier, b)
    lvl = hier.levels[level]
    u, rc = presmooth_restrict(lvl, b, omega, nu1)
    ec = v_cycle(hier, rc, omega, nu1, nu2, level + 1)
    return prolong_add_smooth(lvl, u, b, ec, omega, nu2)


def transpose_hierarchy(hier):
    '''
    Hierarchy for the transposed operator. Since R = (1/4) P^T, the Galerkin
    coarse operator of A^T equals the transpose of the coarse operator of A,
    so each level's planes are simply block-transposed (and its line
    states rebuilt from them); the coarsest dense inverse is transposed,
    or its LU re-factorized from the transposed planes.
    '''

    levels = []
    for lvl in hier.levels:
        planesT = stencil.transpose_block_planes(lvl.planes)
        linez = linex = None
        if lvl.linez is not None:
            linez, linex = _line_pcr_states(planesT)
        levels.append(MGLevel(planesT, invert_block_diag(block_diag(planesT)),
                              lvl.mask, linez, linex))
    lu, piv, cinv = None, None, None
    if hier.coarse_inv is not None:
        # inverse of the transpose is the transpose of the inverse
        cinv = hier.coarse_inv.T.contiguous()
    else:
        lu, piv = torch.linalg.lu_factor(
            planes_to_dense_torch(levels[-1].planes))
    return MGHierarchy(tuple(levels), lu, piv, cinv)
