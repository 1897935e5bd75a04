'''
Batched Krylov solvers for zephyr_tpu_torch: right-preconditioned
BiCGStab, restarted GMRES and flexible GMRES.

The port of ``zephyr_tpu.solver.krylov`` with the right-hand-side batch as
an explicit leading axis: fields are (R, B, nz, nx) and every scalar of a
recurrence is an (R,) tensor (GMRES's Hessenberg matrix, Givens rotations
and least-squares right-hand side are per RHS). The JAX package vmaps a
``lax.while_loop``; its semantics are reproduced here: the loop runs while
ANY right-hand side is still active, and a right-hand side whose own
condition has turned false is frozen (its state is no longer updated).
'''

from typing import NamedTuple, Any

import torch


def _dot(a, b):
    'Per-RHS complex inner product <a, b> = sum(conj(a) * b), (R,).'
    return torch.sum((a.conj() * b).reshape(a.shape[0], -1), dim=1)


def _norm(a):
    'Per-RHS 2-norm, (R,) real.'
    return torch.sqrt(torch.abs(_dot(a, a)).real)


def _bcast(s, like):
    'An (R,) tensor viewed to broadcast against an (R, ...) field.'
    return s.reshape((-1,) + (1,) * (like.dim() - 1))


class BicgstabResult(NamedTuple):
    x: Any
    iters: Any     # (R,) int32
    relres: Any    # (R,) real


def bicgstab(matvec, b, M=None, tol=1e-6, maxiter=1000):
    '''
    Right-preconditioned BiCGStab for a batch of right-hand sides.

    Args:
        matvec: x -> A x on a batch (R, B, nz, nx)
        b: right-hand sides (R, B, nz, nx)
        M: preconditioner application on a batch (or None)
        tol: relative residual target ||r|| <= tol * ||b||, a float or an
            (R,) tensor (per right-hand side)
        maxiter: iteration cap

    Returns:
        BicgstabResult(x, iters (R,), relres (R,))
    '''

    if M is None:
        M = lambda r: r

    cdtype = b.dtype
    dev = b.device
    R = b.shape[0]
    bnorm = _norm(b)
    bnorm = torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))
    atol = tol * bnorm
    tiny = torch.finfo(bnorm.dtype).tiny

    def _safe_div(num, den):
        'num / den, or 0 on (near-)breakdown of the denominator.'
        bad = torch.abs(den) < tiny
        return torch.where(bad, torch.zeros((), dtype=cdtype, device=dev),
                           num / torch.where(bad, torch.ones_like(den),
                                             den))

    x = torch.zeros_like(b)
    r = b - matvec(x)
    rhat = r
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    one = torch.ones(R, dtype=cdtype, device=dev)
    rho, alpha, omega = one, one, one
    k = torch.zeros(R, dtype=torch.int32, device=dev)
    down = torch.zeros(R, dtype=torch.bool, device=dev)

    def active_mask():
        return (_norm(r) > atol) & (k < maxiter) & ~down

    act = active_mask()
    while True:
        flags = act.cpu()   # the one host sync of an iteration
        if not bool(flags.any()):
            break
        rho_new = _dot(rhat, r)
        beta = _safe_div(rho_new * alpha, rho * omega)
        p_new = r + _bcast(beta, r) * (p - _bcast(omega, v) * v)
        phat = M(p_new)
        v_new = matvec(phat)
        denom = _dot(rhat, v_new)
        alpha_new = _safe_div(rho_new, denom)
        s = r - _bcast(alpha_new, v_new) * v_new
        shat = M(s)
        t = matvec(shat)
        tt = _dot(t, t)
        omega_new = _safe_div(_dot(t, s), tt)
        x_new = (x + _bcast(alpha_new, phat) * phat
                 + _bcast(omega_new, shat) * shat)
        r_new = s - _bcast(omega_new, t) * t
        # Lanczos breakdown: the next iteration cannot make progress
        down_new = ((torch.abs(rho_new) < tiny) | (torch.abs(denom) < tiny)
                    | (torch.abs(omega_new) < tiny))

        if bool(flags.all()):
            x, r, p, v = x_new, r_new, p_new, v_new
        else:
            # freeze every right-hand side whose own loop has ended
            af = _bcast(act, b)
            x = torch.where(af, x_new, x)
            r = torch.where(af, r_new, r)
            p = torch.where(af, p_new, p)
            v = torch.where(af, v_new, v)
        rho = torch.where(act, rho_new, rho)
        alpha = torch.where(act, alpha_new, alpha)
        omega = torch.where(act, omega_new, omega)
        k = torch.where(act, k + 1, k)
        down = torch.where(act, down_new, down)
        act = active_mask()
    return BicgstabResult(x, k, _norm(r) / bnorm)


def gmres_cycle(matvec, b, M=None, x0=None, m=20):
    '''
    One cycle of right-preconditioned GMRES(m) on a batch: x = x0 + M V y
    with V the m-step Arnoldi basis of the preconditioned residual
    equation, by modified Gram-Schmidt (in the JAX package's order) and
    Givens rotations. Fixed m steps, no early exit. The basis V is
    (m + 1, R, B, nz, nx). Returns BicgstabResult(x, iters = m, relres).
    '''

    return _gmres_cycle(matvec, b, M, x0, m, flexible=False)


def fgmres_cycle(matvec, b, M=None, x0=None, m=20):
    '''
    One cycle of flexible GMRES(m) (Saad 1993): the preconditioned
    directions Z[j] = M(V[j]) are stored (an extra (m, R, B, nz, nx)
    basis) and the update is x = x0 + Z y, so ``M`` may be a variable
    (nonlinear) operator such as an inner Krylov sweep.
    '''

    return _gmres_cycle(matvec, b, M, x0, m, flexible=True)


def _gmres_cycle(matvec, b, M, x0, m, flexible):
    if M is None:
        M = lambda r: r
    R = b.shape[0]
    cdtype = b.dtype
    dev = b.device
    x0 = torch.zeros_like(b) if x0 is None else x0
    r0 = b - matvec(x0)
    beta = _norm(r0)
    safe_beta = torch.where(beta > 0, beta, torch.ones_like(beta))
    tiny = torch.finfo(beta.dtype).tiny

    V = torch.zeros((m + 1,) + tuple(b.shape), dtype=cdtype, device=dev)
    V[0] = r0 / _bcast(safe_beta.to(cdtype), r0)
    Z = (torch.zeros((m,) + tuple(b.shape), dtype=cdtype, device=dev)
         if flexible else None)
    H = torch.zeros((R, m + 1, m), dtype=cdtype, device=dev)
    g = torch.zeros((R, m + 1), dtype=cdtype, device=dev)
    g[:, 0] = beta.to(cdtype)
    cs = torch.zeros((R, m), dtype=cdtype, device=dev)
    sn = torch.zeros((R, m), dtype=cdtype, device=dev)
    one = torch.ones((), dtype=cdtype, device=dev)

    for j in range(m):
        z = M(V[j])
        if flexible:
            Z[j] = z
        w = matvec(z)
        # modified Gram-Schmidt against the basis so far
        for i in range(j + 1):
            hij = _dot(V[i], w)
            w = w - _bcast(hij, w) * V[i]
            H[:, i, j] = hij
        hnext = _norm(w).to(cdtype)
        H[:, j + 1, j] = hnext
        V[j + 1] = w / _bcast(torch.where(torch.abs(hnext) > tiny, hnext,
                                          one), w)
        # the previous Givens rotations, applied to the new column
        for i in range(j):
            hi, hi1 = H[:, i, j], H[:, i + 1, j]
            h1 = cs[:, i].conj() * hi + sn[:, i].conj() * hi1
            h2 = -sn[:, i] * hi + cs[:, i] * hi1
            H[:, i, j] = h1
            H[:, i + 1, j] = h2
        # the new rotation, zeroing H[j + 1, j]
        h0, h1 = H[:, j, j], H[:, j + 1, j]
        denom = torch.sqrt(torch.abs(h0) ** 2 + torch.abs(h1) ** 2)
        denom = torch.where(denom > tiny, denom,
                            torch.ones_like(denom)).to(cdtype)
        c_j, s_j = h0 / denom, h1 / denom
        cs[:, j], sn[:, j] = c_j, s_j
        H[:, j, j] = c_j.conj() * h0 + s_j.conj() * h1
        H[:, j + 1, j] = 0
        gj = g[:, j]
        g[:, j + 1] = -s_j * gj
        g[:, j] = c_j.conj() * gj

    # back-substitute the m x m upper-triangular system H y = g
    y = torch.zeros((R, m), dtype=cdtype, device=dev)
    for j in range(m - 1, -1, -1):
        acc = torch.zeros((R,), dtype=cdtype, device=dev)
        for i in range(j + 1, m):
            acc = acc + H[:, j, i] * y[:, i]
        hjj = H[:, j, j]
        hjj = torch.where(torch.abs(hjj) > tiny, hjj, one)
        y[:, j] = (g[:, j] - acc) / hjj

    if flexible:
        x = x0
        for j in range(m):
            x = x + _bcast(y[:, j], x) * Z[j]
    else:
        zsum = torch.zeros_like(b)
        for j in range(m):
            zsum = zsum + _bcast(y[:, j], zsum) * V[j]
        x = x0 + M(zsum)
    r = b - matvec(x)
    bnorm = _norm(b)
    bnorm = torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))
    iters = torch.full((R,), m, dtype=torch.int32, device=dev)
    return BicgstabResult(x, iters, _norm(r) / bnorm)


def _restarted(cycle, matvec, b, M, tol, maxiter, restart):
    '''
    Full ``cycle``s until the true residual of every right-hand side meets
    ``tol`` or its cycle budget maxiter // restart is spent; a right-hand
    side that has converged keeps its iterate while the others cycle on.
    Returns BicgstabResult(x, cycles * restart, relres).
    '''

    ncycles = max(1, maxiter // restart)
    bnorm = _norm(b)
    bnorm = torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))
    x = torch.zeros_like(b)
    rr = _norm(b - matvec(x)) / bnorm
    k = torch.zeros(b.shape[0], dtype=torch.int32, device=b.device)
    while True:
        act = (rr > tol) & (k < ncycles)
        if not bool(act.any()):     # the one host sync of a cycle
            break
        res = cycle(matvec, b, M=M, x0=x, m=restart)
        x = torch.where(_bcast(act, x), res.x, x)
        rr = torch.where(act, res.relres, rr)
        k = torch.where(act, k + 1, k)
    return BicgstabResult(x, k * restart, rr)


def gmres(matvec, b, M=None, tol=1e-6, maxiter=1000, restart=40):
    '''
    Restarted GMRES built from ``gmres_cycle``: full cycles until the true
    residual meets tol or the matvec budget is spent (``iters`` counts
    cycles x restart).
    '''

    return _restarted(gmres_cycle, matvec, b, M, tol, maxiter, restart)


def fgmres(matvec, b, M=None, tol=1e-6, maxiter=1000, restart=40):
    '''
    Restarted flexible GMRES built from ``fgmres_cycle``; ``maxiter``
    counts outer Arnoldi steps, as in ``gmres``.
    '''

    return _restarted(fgmres_cycle, matvec, b, M, tol, maxiter, restart)
