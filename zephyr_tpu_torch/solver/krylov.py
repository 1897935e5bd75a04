'''
Batched right-preconditioned BiCGStab for zephyr_tpu_torch.

The port of ``zephyr_tpu.solver.krylov.bicgstab`` with the right-hand-side
batch as an explicit leading axis: fields are (R, B, nz, nx) and every
scalar of the recurrence is an (R,) tensor. The JAX package vmaps a
``lax.while_loop``; its semantics are reproduced here: the loop runs while
ANY right-hand side is still active, and a right-hand side whose own
condition ||r|| > atol, k < maxiter, no breakdown has turned false is
frozen (its state is no longer updated).
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
