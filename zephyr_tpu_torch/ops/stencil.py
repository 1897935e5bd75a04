'''
Matrix-free 9-point stencil operators for zephyr_tpu_torch.

The port of ``zephyr_tpu.ops.stencil``. The operator is stored as dense
"coefficient planes" of shape (9, nz, nx) and applied matrix-free:

    (A u)[i, j] = sum_k  planes[k, i, j] * u[i + dz_k, j + dx_k]

with zero extension outside the grid. Block operators are planes of shape
(B, B, 9, nz, nx) acting on fields of shape (..., B, nz, nx).

Plane ordering: index k = (dz + 1) * 3 + (dx + 1) for offsets
(dz, dx) in row-major order over {-1, 0, 1}^2, i.e.

    k : 0        1       2       3       4      5       6       7       8
    s : (-1,-1) (-1,0) (-1,+1) (0,-1) (0,0) (0,+1) (+1,-1) (+1,0) (+1,+1)

Every fused operator has two forms here: a plain torch "twin" (the
``*_ref`` functions, line for line the JAX package's reference bodies)
and a dispatch function that takes the right-hand-side batch as an
explicit leading axis. A dispatch function runs the twin for CPU tensors
and the hand-written CUDA kernel (``ops.cuda_kernels``) for CUDA
tensors; anything else raises. There is no fallback from one to the
other.
'''

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_kernels

#: Stencil offsets (dz, dx), index k = (dz+1)*3 + (dx+1)
OFFSETS = tuple((dz, dx) for dz in (-1, 0, 1) for dx in (-1, 0, 1))
CENTER = 4


def _pad1(a):
    'Zero-pad the last two axes by one cell on every side.'
    return F.pad(a, (1, 1, 1, 1))


def shift2d(arr, dz, dx):
    '''
    Return out[i, j] = arr[i + dz, j + dx], zero outside the array.
    Operates on the last two axes.
    '''

    nz, nx = arr.shape[-2:]
    return _pad1(arr)[..., 1 + dz:1 + dz + nz, 1 + dx:1 + dx + nx]


def sanitize_planes(planes):
    '''
    Zero the stencil entries that point outside the grid (e.g. the (0,+1)
    plane on the last column). Semantically a no-op for the apply, but it
    makes plane storage canonical, which the Galerkin coarsening relies on.
    Works on (..., 9, nz, nx).
    '''

    out = []
    for k, (dz, dx) in enumerate(OFFSETS):
        p = planes[..., k, :, :].clone()
        if dz < 0:
            p[..., 0, :] = 0
        if dz > 0:
            p[..., -1, :] = 0
        if dx < 0:
            p[..., :, 0] = 0
        if dx > 0:
            p[..., :, -1] = 0
        out.append(p)
    return torch.stack(out, dim=-3)


def apply_stencil(planes, u):
    '''
    Apply a scalar 9-point stencil operator (the plain twin of K1).

    Args:
        planes: (9, nz, nx) complex coefficient planes
        u: (..., nz, nx) field (leading axes broadcast, e.g. RHS batch)

    Returns:
        (..., nz, nx) A @ u
    '''

    up = _pad1(u)
    nz, nx = u.shape[-2:]
    out = None
    for k, (dz, dx) in enumerate(OFFSETS):
        term = planes[k] * up[..., 1 + dz:1 + dz + nz, 1 + dx:1 + dx + nx]
        out = term if out is None else out + term
    return out


def apply_block_stencil(planes, u):
    '''
    Apply a block 9-point stencil operator: planes (B, B, 9, nz, nx),
    u (..., B, nz, nx) -> (..., B, nz, nx), out[i] = sum_j A[i,j] u[j]
    (the plain twin of K8 at B=2).
    '''

    B = planes.shape[0]
    rows = []
    for i in range(B):
        acc = None
        for j in range(B):
            term = apply_stencil(planes[i, j], u[..., j, :, :])
            acc = term if acc is None else acc + term
        rows.append(acc)
    return torch.stack(rows, dim=-3)


def transpose_planes(planes):
    '''
    Coefficient planes of the transposed scalar operator.

    A^T[r, r+s] = A[r+s, r] = P_{-s}[r+s], so the transposed plane for
    offset s is the plane for -s shifted by +s (with zero fill).
    '''

    out = []
    for dz, dx in OFFSETS:
        krev = (1 - dz) * 3 + (1 - dx)  # index of offset (-dz, -dx)
        out.append(shift2d(planes[krev], dz, dx))
    return torch.stack(out, dim=0)


def plane_products(w, x):
    '''
    G[k][i] = sum_r w_r[i] x_r[i + s_k] for w, x (R, nz, nx) ->
    (9, nz, nx): the derivative of sum_r sum_i w_r[i] (A x_r)[i] w.r.t.
    the planes of A, with w and x held fixed (zero outside the grid).
    '''

    return torch.stack([torch.sum(w * shift2d(x, dz, dx), dim=0)
                        for dz, dx in OFFSETS])


def block_plane_products(w, x):
    '''
    G[i, j, k] = sum_r w_r[i] x_r[j][. + s_k] for w, x (R, B, nz, nx) ->
    (B, B, 9, nz, nx): ``plane_products`` per block, the derivative of
    sum_r sum_i w_r[i] (A x_r)[i] w.r.t. the block planes of A (the JAX
    package takes it by jax.vjp of ``apply_block_stencil``).
    '''

    B = w.shape[-3]
    return torch.stack([torch.stack([plane_products(w[:, i], x[:, j])
                                     for j in range(B)])
                        for i in range(B)])


def transpose_block_planes(planes):
    'Planes of the transposed block operator (swap blocks + per-block T).'

    B = planes.shape[0]
    rows = []
    for i in range(B):
        cols = [transpose_planes(planes[j, i]) for j in range(B)]
        rows.append(torch.stack(cols, dim=0))
    return torch.stack(rows, dim=0)


def block_diag(planes):
    'The (B, B, nz, nx) pointwise block-diagonal (the CENTER plane).'

    return planes[:, :, CENTER]


def invert_block_diag(D):
    '''
    Pointwise inverse of a (B, B, nz, nx) block-diagonal field.
    Supports B = 1 and B = 2 analytically.
    '''

    B = D.shape[0]
    if B == 1:
        return (1.0 / D[0, 0])[None, None]
    if B == 2:
        a, b = D[0, 0], D[0, 1]
        c, d = D[1, 0], D[1, 1]
        det = a * d - b * c
        inv = torch.stack([torch.stack([d, -b], dim=0),
                           torch.stack([-c, a], dim=0)], dim=0)
        return inv / det
    raise NotImplementedError('invert_block_diag: B > 2')


def block_diag_matvec(Dinv, r):
    'Apply a pointwise (B, B, nz, nx) block field to (..., B, nz, nx).'

    B = Dinv.shape[0]
    outs = []
    for i in range(B):
        acc = None
        for j in range(B):
            term = Dinv[i, j] * r[..., j, :, :]
            acc = term if acc is None else acc + term
        outs.append(acc)
    return torch.stack(outs, dim=-3)


# ---------------------------------------------------------------------------
# Dense assembly (tests, and the multigrid coarsest-level inverse only)
# ---------------------------------------------------------------------------

def planes_to_dense(planes):
    '''
    Assemble a scalar (9, nz, nx) plane set (numpy or CPU tensor) into a
    dense numpy (nz*nx, nz*nx) matrix with true 2D neighbour semantics.
    '''

    planes = np.asarray(planes)
    _, nz, nx = planes.shape
    n = nz * nx
    A = np.zeros((n, n), dtype=planes.dtype)
    I, J = np.mgrid[0:nz, 0:nx]
    rows = (I * nx + J).ravel()
    for k, (dz, dx) in enumerate(OFFSETS):
        In, Jn = I + dz, J + dx
        valid = (In >= 0) & (In < nz) & (Jn >= 0) & (Jn < nx)
        cols = (In * nx + Jn).ravel()
        v = valid.ravel()
        A[rows[v], cols[v]] += planes[k].ravel()[v]
    return A


def planes_to_dense_torch(planes):
    '''
    Dense assembly of block planes (B, B, 9, nz, nx) into a
    (B*nz*nx, B*nz*nx) tensor on the planes' device: the multigrid
    coarsest-level operator.
    '''

    B = planes.shape[0]
    nz, nx = planes.shape[-2:]
    n = nz * nx
    dev = planes.device
    I, J = torch.meshgrid(torch.arange(nz, device=dev),
                          torch.arange(nx, device=dev), indexing='ij')
    rows = (I * nx + J).reshape(-1)
    A = torch.zeros((B * n, B * n), dtype=planes.dtype, device=dev)
    for bi in range(B):
        for bj in range(B):
            for k, (dz, dx) in enumerate(OFFSETS):
                In, Jn = I + dz, J + dx
                valid = (In >= 0) & (In < nz) & (Jn >= 0) & (Jn < nx)
                cols = (In.clamp(0, nz - 1) * nx
                        + Jn.clamp(0, nx - 1)).reshape(-1)
                vals = torch.where(valid.reshape(-1),
                                   planes[bi, bj, k].reshape(-1), 0)
                A.index_put_((bi * n + rows, bj * n + cols), vals,
                             accumulate=True)
    return A


# ---------------------------------------------------------------------------
# Fused-operator twins (the JAX package's reference bodies)
# ---------------------------------------------------------------------------

def _jacobi_ref(p, d, bb, uu):
    return uu + d * (bb - apply_stencil(p, uu))


def _jacobi2_ref(p, d, bb, uu):
    'Two damped-Jacobi sweeps from uu: twin of K6.'
    return _jacobi_ref(p, d, bb, _jacobi_ref(p, d, bb, uu))


def _jacobi2z_ref(p, d, bb):
    'Two damped-Jacobi sweeps from zero: twin of K6 with u=None.'
    return _jacobi_ref(p, d, bb, d * bb)


def _ps2r_ref(p, d, m, bb):
    'Two from-zero sweeps + masked residual of the iterate: twin of K9.'

    u2 = _jacobi2z_ref(p, d, bb)
    return u2, m * (bb - apply_stencil(p, u2))


def _ps2rr_ref(p, d, m, bb):
    'Downstroke (two sweeps + masked residual) + restriction: twin of K2.'

    from ..solver.multigrid import _restrict_ref
    u2, resm = _ps2r_ref(p, d, m, bb)
    return u2, _restrict_ref(resm)


def _ps1rr_ref(p, d, m, bb):
    'Single-sweep downstroke + restriction: twin of K2 at NSWEEPS=1.'

    from ..solver.multigrid import _restrict_ref
    u1 = d * bb
    return u1, _restrict_ref(m * (bb - apply_stencil(p, u1)))


def _pas_ref(p, d, m, bb, uu, ec):
    'Upstroke: one sweep of (u + mask * prolong(ec)) vs b: twin of K4.'

    from ..solver.multigrid import _prolong_ref
    nz, nx = bb.shape[-2:]
    u1 = uu + m * _prolong_ref(ec, nz, nx)
    return u1 + d * (bb - apply_stencil(p, u1))


# ---------------------------------------------------------------------------
# Dispatch: one function per kernel, batch axis explicit
# ---------------------------------------------------------------------------

def _on_cpu(t):
    '''
    True for a CPU tensor (run the twin), False for a CUDA tensor (run the
    kernel, whose wrapper validates dtype, shape and device and raises on
    anything it does not take); any other device raises.
    '''

    if t.device.type == 'cpu':
        return True
    if t.device.type == 'cuda':
        return False
    raise RuntimeError('zephyr_tpu_torch: no kernel for device %s'
                       % (t.device,))


def apply_stencil_batched(planes, u):
    '''
    K1: batched 9-point apply, planes (9, nz, nx) shared across the batch,
    u (R, nz, nx) -> (R, nz, nx).
    '''

    if _on_cpu(u):
        return apply_stencil(planes, u)
    return cuda_kernels.apply_stencil(planes, u)


def jacobi_sweep_batched(planes, dinv_eff, b, u):
    '''
    K5: one damped-Jacobi sweep u + dinv_eff (b - A u) of a batch, b, u
    (R, nz, nx) -> (R, nz, nx); planes (9, nz, nx) and dinv_eff (nz, nx)
    shared across the batch.
    '''

    if _on_cpu(b):
        return _jacobi_ref(planes, dinv_eff, b, u)
    return cuda_kernels.jacobi_sweep(planes, dinv_eff, b, u)


def presmooth_restrict_batched(planes, dinv_eff, mask, b, nsweeps):
    '''
    K2: the V-cycle downstroke of a scalar level in one pass —
    ``nsweeps`` (1 or 2) damped-Jacobi sweeps from zero, the masked
    residual, and its full-weighting restriction. b (R, nz, nx) ->
    (u (R, nz, nx), rc (R, (nz+1)//2, (nx+1)//2)).
    '''

    if nsweeps not in (1, 2):
        raise ValueError('presmooth_restrict: nsweeps must be 1 or 2 (the '
                         'multigrid downstroke runs other counts as '
                         'presmooth_residual + restrict)')
    if _on_cpu(b):
        ref = _ps2rr_ref if nsweeps == 2 else _ps1rr_ref
        return ref(planes, dinv_eff, mask, b)
    return cuda_kernels.presmooth_restrict(planes, dinv_eff, mask, b,
                                           nsweeps)


def jacobi_sweep2_batched(planes, dinv_eff, b, u=None):
    '''
    K6: two damped-Jacobi sweeps of a batch in one pass, b, u (R, nz, nx)
    -> (R, nz, nx); ``u=None`` starts from zero (the first sweep is then
    dinv_eff * b).
    '''

    if _on_cpu(b):
        if u is None:
            return _jacobi2z_ref(planes, dinv_eff, b)
        return _jacobi2_ref(planes, dinv_eff, b, u)
    return cuda_kernels.jacobi_sweep2(planes, dinv_eff, b, u)


def presmooth_residual_batched(planes, dinv_eff, mask, b):
    '''
    K9: the downstroke of a scalar level without the restriction — two
    damped-Jacobi sweeps from zero and the masked residual of the
    iterate. b (R, nz, nx) -> (u2, mask * (b - A u2)), each (R, nz, nx).
    '''

    if _on_cpu(b):
        return _ps2r_ref(planes, dinv_eff, mask, b)
    return cuda_kernels.presmooth_residual(planes, dinv_eff, mask, b)


def prolong_add_smooth_batched(planes, dinv_eff, mask, b, u, ec):
    '''
    K4: the V-cycle upstroke of a scalar level in one pass — bilinear
    prolongation of ec, masked add to u, one damped-Jacobi sweep against
    b. b, u (R, nz, nx), ec (R, (nz+1)//2, (nx+1)//2) -> (R, nz, nx).
    '''

    if _on_cpu(b):
        return _pas_ref(planes, dinv_eff, mask, b, u, ec)
    return cuda_kernels.prolong_add_smooth(planes, dinv_eff, mask, b, u, ec)


def apply_block_stencil_batched(planes, u):
    '''
    K8: batched 2x2 block apply, planes (2, 2, 9, nz, nx) shared across
    the batch, u (R, 2, nz, nx) -> (R, 2, nz, nx). The twin is
    ``apply_block_stencil``.
    '''

    if _on_cpu(u):
        return apply_block_stencil(planes, u)
    return cuda_kernels.apply_block_stencil(planes, u)


def apply_block_stencil_fast(planes, u):
    '''
    The solver-internal operator apply for block planes (B, B, 9, nz, nx)
    on a batch u (R, B, nz, nx): K1 for scalar (B=1) operators, K8 for
    the 2x2 block (TTI) operators.
    '''

    B = planes.shape[0]
    if B == 2:
        return apply_block_stencil_batched(planes, u)
    if B != 1:
        raise NotImplementedError('block apply: B=%d (the port has B=1 '
                                  'and B=2)' % B)
    return apply_stencil_batched(planes[0, 0], u[:, 0])[:, None]
