'''
Stratified (depth-varying) spectral interior solve for the hybrid
Helmholtz preconditioner: the port of ``zephyr_tpu.solver.stratified``
for scalar (B=1) operators, with its transpose.

Per-ROW mean stencil coefficients over an interior x-window, an FFT in x
(``torch.fft``, cuFFT on the card), and for every cross-line wavenumber
kx the TRIDIAGONAL system in z solved by parallel cyclic reduction (PCR):

    T(kx)[z] x[z-1..z+1] = r_hat[z],
    T_dz(z, kx) = sum_dx c[(dz,dx)](z) e^{i kx dx}.

The RHS-independent part of the reduction runs once at preparation time
(``pcr_precompute``); each application only sweeps the right-hand side
(``pcr_apply``), which on the card is kernel K3. complex64 operators
store the per-level factors as bfloat16 re/im pairs. The transposed
family (``stratified_apply(..., transpose=True)``, the transpose solves of
gradients) is reduced from the stored coefficients in full precision and
swept in plain torch on every device, as the JAX package does.

Not ported yet (each raises NotImplementedError): the DFT-matmul
x-transform (``strat_dft='dft'``), the x-panel family
(``strat_panels > 1``) and the block (TTI) family.
'''

from typing import NamedTuple, Any

import numpy as np
import torch

from ..ops import cuda_kernels
from ..ops.stencil import CENTER


class StratPCR(NamedTuple):
    '''
    Precomputed cyclic-reduction state of the stratified tridiagonal
    family: per-level (alpha, gamma) factors and the reduced diagonal
    inverse. complex64 factors are stored as bfloat16 re/im pairs (an
    extra axis of size 2), complex128 ones at full precision.
    '''

    alphas: Any   # (nsteps, nz, nx) complex, or (nsteps, 2, nz, nx) bf16
    gammas: Any   # like alphas
    dinv: Any     # (nz, nx) complex, or (2, nz, nx) bf16
    ldu: Any      # (3, nz, nx) original coefficients (full precision)


def _pack_bf16(x):
    '(...,) complex -> (2, ...) bfloat16 re/im pair, round to nearest even.'
    return torch.stack([x.real, x.imag], dim=0).to(torch.bfloat16)


def _unpack_bf16(p, cdtype):
    '(2, ...) bfloat16 -> complex, upcast through float32.'
    return torch.complex(p[0].float(), p[1].float()).to(cdtype)


def _shift_z(a, s):
    'a[..., z + s, :] with zero fill outside; shift along axis -2.'

    nz = a.shape[-2]
    if s == 0:
        return a
    out = torch.zeros_like(a)
    if abs(s) >= nz:
        return out
    if s > 0:
        out[..., :nz - s, :] = a[..., s:, :]
    else:
        out[..., -s:, :] = a[..., :nz + s, :]
    return out


def _pcr_nsteps(nz):
    return max(1, int(np.ceil(np.log2(max(nz, 2)))))


# The factor recurrence spells its complex arithmetic out in real parts,
# with the rules XLA uses: torch's complex negation, product, division and
# reciprocal round or sign their zeros differently, which changes bits of
# the bf16 factors (the packed zeros of the first rows, for one).

def _cneg(a):
    return torch.complex(-a.real, -a.imag)


def _cmul(a, b):
    return torch.complex(a.real * b.real - a.imag * b.imag,
                         a.real * b.imag + a.imag * b.real)


def _cdiv(a, b):
    'Complex a / b by Smith\'s algorithm.'

    ar, ai, br, bi = a.real, a.imag, b.real, b.imag
    m = torch.abs(br) >= torch.abs(bi)
    rat = torch.where(m, bi / br, br / bi)
    den = torch.where(m, br + bi * rat, bi + br * rat)
    cr = torch.where(m, ar + ai * rat, ar * rat + ai)
    ci = torch.where(m, ai - ar * rat, ai * rat - ar)
    return torch.complex(cr / den, ci / den)


def _safe_inv(x, delta):
    '''
    Magnitude-clamped reciprocal: entries below ``delta * max|x|``
    (including exact zeros from out-of-range shifts) are replaced by the
    clamp value with their phase preserved.
    '''

    a = torch.abs(x)
    dmin = delta * torch.max(a)
    tiny = torch.finfo(a.dtype).tiny
    phase = torch.where(a > 0,
                        _cdiv(x, torch.clamp(a, min=tiny).to(x.dtype)),
                        torch.ones((), dtype=x.dtype, device=x.device))
    xs = torch.where(a < dmin, _cmul(dmin.to(x.dtype), phase), x)
    return _cdiv(torch.ones_like(xs), xs)


def _pcr_levels(l, d, u, delta):
    '''
    The RHS-independent cyclic-reduction recurrence (clamping included).
    Returns (alphas, gammas) per level and the final reduced diagonal
    inverse.
    '''

    alphas, gammas = [], []
    s = 1
    for _ in range(_pcr_nsteps(d.shape[-2])):
        alpha = _cmul(_cneg(l), _safe_inv(_shift_z(d, -s), delta))
        gamma = _cmul(_cneg(u), _safe_inv(_shift_z(d, +s), delta))
        l_new = _cmul(alpha, _shift_z(l, -s))
        u_new = _cmul(gamma, _shift_z(u, +s))
        d_new = (d + _cmul(alpha, _shift_z(u, -s))
                 + _cmul(gamma, _shift_z(l, +s)))
        alphas.append(alpha)
        gammas.append(gamma)
        l, d, u = l_new, d_new, u_new
        s *= 2
    return alphas, gammas, _safe_inv(d, delta)


def _pcr_sweep_rhs(alphas, gammas, dinv, b):
    'RHS-only reduction sweep with full-precision per-level factors.'

    s = 1
    for alpha, gamma in zip(alphas, gammas):
        b = b + alpha * _shift_z(b, -s) + gamma * _shift_z(b, +s)
        s *= 2
    return b * dinv


def tridiag_pcr_solve(l, d, u, b, delta=1e-6):
    '''
    Solve tridiagonal systems T x = b along axis -2, batched over every
    other axis: T x[z] = l[z] x[z-1] + d[z] x[z] + u[z] x[z+1], by
    parallel cyclic reduction with magnitude-clamped divisions.
    '''

    return _pcr_sweep_rhs(*_pcr_levels(l, d, u, delta), b)


def pcr_precompute(l, d, u, delta=1e-6, quantize=None):
    '''
    Run the RHS-independent part of the cyclic reduction once, returning
    a StratPCR for ``pcr_apply``. ``quantize`` (default: on for complex64)
    stores the factors as bf16 re/im pairs, (nsteps, 2, nz, nx).
    '''

    ldu = torch.stack([l, d, u], dim=0)
    alphas, gammas, dinv = _pcr_levels(l, d, u, delta)
    alphas = torch.stack(alphas, 0)
    gammas = torch.stack(gammas, 0)
    if quantize is None:
        quantize = d.dtype == torch.complex64
    if quantize:
        alphas = _pack_bf16(alphas).transpose(0, 1).contiguous()
        gammas = _pack_bf16(gammas).transpose(0, 1).contiguous()
        dinv = _pack_bf16(dinv)
    return StratPCR(alphas, gammas, dinv, ldu)


def _pcr_sweep_bf16_ref(alphas, gammas, dinv, b):
    'Per-level unpacked bf16 sweep: the plain twin of K3.'

    s = 1
    for i in range(alphas.shape[0]):
        a = _unpack_bf16(alphas[i], b.dtype)
        g = _unpack_bf16(gammas[i], b.dtype)
        b = b + a * _shift_z(b, -s) + g * _shift_z(b, +s)
        s *= 2
    return b * _unpack_bf16(dinv, b.dtype)


def pcr_sweep_batched(alphas, gammas, dinv, b):
    '''
    K3: the bf16-factor RHS sweep of a batch b (R, nz, nx). CPU tensors
    run the twin, CUDA tensors the kernel; anything else raises.
    '''

    if b.device.type == 'cpu':
        return _pcr_sweep_bf16_ref(alphas, gammas, dinv, b)
    if b.device.type == 'cuda':
        return cuda_kernels.pcr_sweep(alphas, gammas, dinv, b)
    raise RuntimeError('pcr_sweep: no kernel for device %s' % (b.device,))


def pcr_apply(pcr, b):
    '''
    RHS-only cyclic-reduction sweep with precomputed levels, b
    (R, nz, nx). Full-precision (complex128) factors sweep in plain torch
    on the CPU; on the card the forward factors are always bf16 and go to
    K3.
    '''

    if pcr.alphas.dtype == torch.bfloat16:
        return pcr_sweep_batched(pcr.alphas, pcr.gammas, pcr.dinv, b)
    if b.device.type != 'cpu':
        raise NotImplementedError('pcr_apply: full-precision factors on '
                                  '%s have no kernel; K3 takes bf16 '
                                  'factors (complex64 operators)'
                                  % (b.device,))
    return _pcr_sweep_rhs(pcr.alphas, pcr.gammas, pcr.dinv, b)


def _per_row_mean(planes):
    '''
    Per-row mean stencil coefficients over the interior x-window
    (B, B, 9, nz, nx) -> (B, B, 9, nz).
    '''

    nx = planes.shape[-1]
    x0, x1 = nx // 4, max(nx // 4 + 1, (3 * nx) // 4)
    return torch.mean(planes[..., x0:x1], dim=-1)


def stratified_coeffs(planes, precond_planes, shift, fft_shift,
                      contrast_threshold=1.05):
    '''
    The (l, d, u) tridiagonal coefficient arrays of the stratified
    interior operator at the spectral CSLP shift, for a SCALAR (B=1)
    operator: with per-row true coefficients c0(z) and ``shift``-shifted
    coefficients cP(z), cM = (c0 - cP) / shift and cF = c0 - fft_shift cM.

    fft_shift may be 'auto': 0.03j when the within-row contrast of the
    mass plane is below ``contrast_threshold``, else 0.25j (computed on
    the device exactly as the JAX package does).

    Returns (l, d, u), each (nz, nx) complex.
    '''

    if planes.shape[0] != 1:
        raise NotImplementedError('stratified_coeffs: block (TTI) family '
                                  'not ported yet (ROADMAP Slice D)')
    c0 = _per_row_mean(planes)[0, 0]           # (9, nz)
    cP = _per_row_mean(precond_planes)[0, 0]
    cdtype = c0.dtype
    shift = torch.as_tensor(shift, dtype=cdtype, device=c0.device)
    cM = (c0 - cP) / shift

    if isinstance(fft_shift, str):  # 'auto'
        nz, nx = planes.shape[-2:]
        z0, z1 = nz // 4, max(nz // 4 + 1, (3 * nz) // 4)
        x0, x1 = nx // 4, max(nx // 4 + 1, (3 * nx) // 4)
        mass = (planes[0, 0, CENTER, z0:z1, x0:x1]
                - precond_planes[0, 0, CENTER, z0:z1, x0:x1]) / shift
        ma = torch.abs(mass)
        tiny = torch.finfo(ma.dtype).tiny
        row_mean = torch.clamp(torch.mean(ma, dim=-1, keepdim=True),
                               min=tiny)
        man = ma / row_mean
        contrast = torch.sqrt(torch.max(man)
                              / torch.clamp(torch.min(man), min=tiny))
        small = torch.tensor(0.03, dtype=ma.dtype, device=ma.device)
        large = torch.tensor(0.25, dtype=ma.dtype, device=ma.device)
        fft_shift = torch.where(contrast < contrast_threshold, small,
                                large) * 1j
    fs = torch.as_tensor(fft_shift, dtype=cdtype, device=c0.device)
    cF = c0 - fs * cM   # (9, nz)

    nx = planes.shape[-1]
    rdtype = c0.real.dtype
    kx = (2 * np.pi) * torch.fft.fftfreq(nx, dtype=rdtype,
                                         device=c0.device)
    bands = []
    for dz in (-1, 0, 1):
        acc = None
        for dx in (-1, 0, 1):
            k = (dz + 1) * 3 + (dx + 1)
            phase = torch.exp(1j * kx * dx).to(cdtype)   # (nx,)
            term = cF[k][:, None] * phase[None, :]
            acc = term if acc is None else acc + term
        bands.append(acc)                                 # (nz, nx)
    return tuple(bands)   # (l, d, u)


def transpose_strat(strat):
    '''
    Tridiagonal coefficients of the transposed stratified operator:
    (T^T)[z] couples via l_T(z) = u(z-1), d, u_T(z) = l(z+1).
    '''

    l, d, u = strat
    return (_shift_z(u, -1), d, _shift_z(l, +1))


def transpose_pcr(strat, delta=1e-6):
    '''
    The RHS-independent reduction of the transposed family of a StratPCR
    (or a bare (l, d, u) triple), from its stored coefficients and in
    full precision, as the JAX package's transpose solve reduces it.
    '''

    ldu = strat.ldu if isinstance(strat, StratPCR) else strat
    return pcr_precompute(*transpose_strat(tuple(ldu)), delta=delta,
                          quantize=False)


def stratified_apply(strat, r, transpose=False):
    '''
    Apply the stratified interior inverse to r (R, 1, nz, nx): x-FFT,
    per-kx tridiagonal solve in z (the precomputed PCR sweep), inverse
    x-FFT.

    With ``transpose=True``, ``strat`` is the transposed family
    (``transpose_pcr``) and this applies the algebraic transpose
    P^T = F T^{-T} F^{-1} (the x-DFT matrix is symmetric), sweeping the
    full-precision factors in plain torch on every device: it is not a
    kernel, in the JAX package or here.
    '''

    if transpose:
        rhat = torch.fft.ifft(r, dim=-1)
        xhat = _pcr_sweep_rhs(strat.alphas, strat.gammas, strat.dinv, rhat)
        return torch.fft.fft(xhat, dim=-1)
    rhat = torch.fft.fft(r[:, 0], dim=-1)
    xhat = pcr_apply(strat, rhat)
    return torch.fft.ifft(xhat, dim=-1)[:, None]
