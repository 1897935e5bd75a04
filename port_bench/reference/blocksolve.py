'''
A direct solve of the 9-point operator by block Gaussian elimination
over grid columns (block Thomas): the unknowns of one column x are one
block of nz, the operator is block tridiagonal with tridiagonal blocks,

    L_j X_{j-1} + D_j X_j + U_j X_{j+1} = B_j,

and the elimination keeps, for every column, G_j = S_j^{-1} U_j and
S_j^{-1} Y_j, where S_j = D_j - L_j G_{j-1} is the Schur complement. Each
S_j is factorised with partial pivoting (``torch.linalg.solve``); there
is no pivoting across columns. Memory is nx nz^2 elements for the G_j.

``quantize`` (a function of a tensor) is applied to every stored
quantity: the lower-precision control rounds there.
'''

import torch


def _tri(planes, k0, j):
    '(sub, diag, super) of the tridiagonal block of column j.'
    return planes[k0, :, j], planes[k0 + 3, :, j], planes[k0 + 6, :, j]


def _dense_tri(sub, diag, sup):
    n = diag.shape[0]
    M = torch.diag_embed(diag)
    idx = torch.arange(n - 1, device=diag.device)
    M[idx + 1, idx] = sub[1:]
    M[idx, idx + 1] = sup[:-1]
    return M


def _tri_mul(sub, diag, sup, G):
    'T @ G for the tridiagonal T = (sub, diag, sup) and G (n, m).'
    out = diag[:, None] * G
    out[1:] += sub[1:, None] * G[:-1]
    out[:-1] += sup[:-1, None] * G[1:]
    return out


def _solve(S, rhs, infos):
    'S^{-1} rhs without a host sync (the factorisation info is kept).'
    sol, info = torch.linalg.solve_ex(S, rhs)
    infos.append(info)
    return sol


def solve(planes, b, quantize=None, dtype=torch.complex128):
    '''
    x with A x = b for planes (9, nz, nx) and b (m, nz, nx); the
    elimination runs in ``dtype`` on the planes' device.
    '''

    q = quantize or (lambda t: t)
    planes = q(planes.to(dtype))
    m, nz, nx = b.shape
    B = q(b.to(dtype).permute(2, 1, 0))          # (nx, nz, m)
    # plane k = 3 (dz + 1) + (dx + 1): dx = -1 -> L, 0 -> D, +1 -> U
    GU, GY, infos = [], [], []
    prevU = prevY = None
    for j in range(nx):
        L = _tri(planes, 0, j)
        D = _dense_tri(*_tri(planes, 1, j))
        Y = B[j]
        if j > 0:
            D = D - _tri_mul(*L, prevU)
            Y = Y - _tri_mul(*L, prevY)
        S = q(D)
        if j < nx - 1:
            U = _dense_tri(*_tri(planes, 2, j))
            sol = _solve(S, torch.cat([U, q(Y)], dim=1), infos)
            prevU, prevY = q(sol[:, :nz]), q(sol[:, nz:])
        else:
            prevU, prevY = None, q(_solve(S, q(Y), infos))
        GU.append(prevU)
        GY.append(prevY)
    if int(torch.stack(infos).abs().max()) != 0:
        raise RuntimeError('blocksolve: a Schur complement is singular')
    X = [None] * nx
    X[nx - 1] = GY[nx - 1]
    for j in range(nx - 2, -1, -1):
        X[j] = q(GY[j] - GU[j] @ X[j + 1])
        GU[j + 1] = GY[j + 1] = None
    return torch.stack(X).permute(2, 1, 0).contiguous()


def bf16_round(t):
    '''
    ``t`` rounded to bfloat16 (each real part of a complex tensor), in
    the dtype it came in.
    '''
    if t.is_complex():
        r = torch.view_as_real(t.to(torch.complex64))
        r = r.to(torch.bfloat16).to(torch.float32)
        return torch.view_as_complex(r.contiguous()).to(t.dtype)
    return t.to(torch.bfloat16).to(t.dtype)


def bf16_control():
    '''
    (quantize, dtype) of the lower-precision control: every stored
    quantity in bfloat16, the arithmetic in complex64.
    '''
    return bf16_round, torch.complex64
