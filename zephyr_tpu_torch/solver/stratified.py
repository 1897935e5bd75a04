'''
Stratified (depth-varying) spectral interior solve for the hybrid
Helmholtz preconditioner: the port of ``zephyr_tpu.solver.stratified``
for scalar (B=1) operators with its transpose, and the forward block
(B=2, TTI) family.

Per-ROW mean stencil coefficients over an interior x-window, an FFT in x
(``torch.fft``, cuFFT on the card), and for every cross-line wavenumber
kx the TRIDIAGONAL system in z solved by parallel cyclic reduction (PCR):

    T(kx)[z] x[z-1..z+1] = r_hat[z],
    T_dz(z, kx) = sum_dx c[(dz,dx)](z) e^{i kx dx}.

The RHS-independent part of the reduction runs once at preparation time
(``pcr_precompute``); each application only sweeps the right-hand side
(``pcr_apply``), which on the card is kernel K3. complex64 operators
store the per-level factors as bfloat16 re/im pairs, and once more in
K3's packed layout (``pack_pcr_factors``). The transposed
family (``stratified_apply(..., transpose=True)``, the transpose solves of
gradients) is reduced from the stored coefficients in full precision and
swept in plain torch on every device, as the JAX package does.

The x-transform is ``torch.fft`` by default; a state prepared with
``pcr_precompute(dft=w)`` carries the symmetric DFT matrix pair of width
w and transforms by full-f32 matmuls instead (``strat_dft='dft'``). Its
phases are reduced mod w in integers (the JAX package forms them in f32
and is ~1e-3 off at w = 2048; fault F2, not inherited).

The x-panel family (``stratified_coeffs_panels``,
``stratified_apply_panels``; ``strat_panels > 1``) partitions x into
overlapping panels blended by a partition of unity: per-panel row means,
per-panel x-transforms, and one PCR sweep (K3) over the concatenated
panel columns, for laterally heterogeneous media.

The block family (``stratified_coeffs_block``, ``pcr_precompute_block``,
``stratified_apply_block``) solves a 2x2 block-tridiagonal system per kx
by the same reduction with pointwise 2x2 block inverses; it runs as
plain torch on every device, as it does in the JAX package, and also
serves the multigrid line smoother (``multigrid._line_pcr_states``).

Not ported yet (raises NotImplementedError): the transposed block family
(TTI gradients).
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
    dft: Any = None   # optional (F, Fi) DFT matrix pair, each (w, w)
                      # complex and symmetric: the x-transforms as matmuls
    packed: Any = None  # bf16 factors in K3's layout (pack_pcr_factors)


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


def dft_mats(w, dtype=torch.complex64, device='cpu'):
    '''
    Symmetric DFT matrix pair (F, Fi) of width ``w``: F[x, k] =
    exp(-2 pi i x k / w), Fi = conj(F) / w, so ``r @ F`` along the last
    axis is ``torch.fft.fft(r, dim=-1)`` and ``r @ Fi`` its inverse. The
    product x k is reduced mod w in integers and the phase formed in
    float64 before the cast to ``dtype`` (fault F2 of the JAX package,
    which forms the unreduced phase in float32).
    '''

    x = torch.arange(w, dtype=torch.int64, device=device)
    m = torch.remainder(x[:, None] * x[None, :], w)
    phase = (-2.0 * np.pi / w) * m.to(torch.float64)
    F = torch.exp(1j * phase)
    return F.to(dtype), (F.conj() / w).to(dtype)


def _dft_apply(r, M):
    '''
    Contract the last axis of r with a DFT matrix: one full-precision
    matmul (on the card the TF32 shortcut would keep ~3 digits, so it
    must be off).
    '''

    if r.device.type == 'cuda' and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError('DFT x-transform: torch.backends.cuda.matmul.'
                           'allow_tf32 must be False (full f32 matmul)')
    return torch.matmul(r, M)


def _x_transforms(strat, width):
    '''
    The (forward, inverse) x-transforms of a solve of this width: DFT
    matmuls when the state carries matrices of that width, else
    ``torch.fft``.
    '''

    dftm = getattr(strat, 'dft', None)
    if dftm is not None and dftm[0].shape[-1] == width:
        return (lambda v: _dft_apply(v, dftm[0]),
                lambda v: _dft_apply(v, dftm[1]))
    return (lambda v: torch.fft.fft(v, dim=-1),
            lambda v: torch.fft.ifft(v, dim=-1))


def pcr_precompute(l, d, u, delta=1e-6, quantize=None, dft=None):
    '''
    Run the RHS-independent part of the cyclic reduction once, returning
    a StratPCR for ``pcr_apply``. ``quantize`` (default: on for complex64)
    stores the factors as bf16 re/im pairs, (nsteps, 2, nz, nx). ``dft``
    (a width, or True for the bands' width) attaches the DFT matrix pair,
    so the x-transforms run as matmuls.
    '''

    ldu = torch.stack([l, d, u], dim=0)
    alphas, gammas, dinv = _pcr_levels(l, d, u, delta)
    alphas = torch.stack(alphas, 0)
    gammas = torch.stack(gammas, 0)
    if quantize is None:
        quantize = d.dtype == torch.complex64
    packed = None
    if quantize:
        alphas = _pack_bf16(alphas).transpose(0, 1).contiguous()
        gammas = _pack_bf16(gammas).transpose(0, 1).contiguous()
        dinv = _pack_bf16(dinv)
        packed = pack_pcr_factors(alphas, gammas, dinv)
    mats = None
    if dft:
        w = d.shape[-1] if dft is True else int(dft)
        mats = dft_mats(w, d.dtype, d.device)
    return StratPCR(alphas, gammas, dinv, ldu, mats, packed)


def pack_pcr_factors(alphas, gammas, dinv):
    '''
    K3's layout of the bf16 factors: (nsteps + 1, nx, nz, 4) bfloat16, for
    every level, column and row the four parts (alpha re, alpha im, gamma
    re, gamma im) side by side (one 8-byte word), the rows of a column
    contiguous; level ``nsteps`` holds (dinv re, dinv im, 0, 0). Built
    once per prepared operator (``pcr_precompute``, ``convert``); the
    (nsteps, 2, nz, nx) planes stay for the twin. The bits are the
    planes' bits (``unpack_pcr_factors`` gives them back).
    '''

    last = torch.stack([dinv[0], dinv[1], torch.zeros_like(dinv[0]),
                        torch.zeros_like(dinv[0])], dim=-1)   # (nz, nx, 4)
    words = torch.cat([torch.stack([alphas[:, 0], alphas[:, 1], gammas[:, 0],
                                    gammas[:, 1]], dim=-1), last[None]])
    return words.transpose(1, 2).contiguous()


def unpack_pcr_factors(packed):
    '(alphas, gammas, dinv) planes of a packed layout, bit for bit.'

    p = packed.transpose(1, 2)      # (nsteps + 1, nz, nx, 4)
    alphas = torch.stack([p[:-1, ..., 0], p[:-1, ..., 1]], dim=1)
    gammas = torch.stack([p[:-1, ..., 2], p[:-1, ..., 3]], dim=1)
    dinv = torch.stack([p[-1, ..., 0], p[-1, ..., 1]], dim=0)
    return alphas.contiguous(), gammas.contiguous(), dinv.contiguous()


def _pcr_sweep_bf16_ref(alphas, gammas, dinv, b):
    'Per-level unpacked bf16 sweep: the plain twin of K3.'

    s = 1
    for i in range(alphas.shape[0]):
        a = _unpack_bf16(alphas[i], b.dtype)
        g = _unpack_bf16(gammas[i], b.dtype)
        b = b + a * _shift_z(b, -s) + g * _shift_z(b, +s)
        s *= 2
    return b * _unpack_bf16(dinv, b.dtype)


def pcr_sweep_batched(alphas, gammas, dinv, b, packed=None):
    '''
    K3: the bf16-factor RHS sweep of a batch b (R, nz, nx). CPU tensors
    run the twin on the planes, CUDA tensors the kernel on ``packed``
    (``pack_pcr_factors`` of the same planes, built once by the caller);
    anything else raises.
    '''

    if b.device.type == 'cpu':
        return _pcr_sweep_bf16_ref(alphas, gammas, dinv, b)
    if b.device.type == 'cuda':
        if packed is None:
            raise ValueError('pcr_sweep: the kernel takes the packed '
                             'factors (pack_pcr_factors, once per operator)')
        return cuda_kernels.pcr_sweep(packed, b)
    raise RuntimeError('pcr_sweep: no kernel for device %s' % (b.device,))


def pcr_apply(pcr, b):
    '''
    RHS-only cyclic-reduction sweep with precomputed levels, b
    (R, nz, nx). Full-precision (complex128) factors sweep in plain torch
    on the CPU; on the card the forward factors are always bf16 and go to
    K3.
    '''

    if pcr.alphas.dtype == torch.bfloat16:
        return pcr_sweep_batched(pcr.alphas, pcr.gammas, pcr.dinv, b,
                                 pcr.packed)
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


def _auto_fft_shift(planes, precond_planes, shift, x0, x1,
                    contrast_threshold=1.05):
    '''
    The 'auto' spectral shift of a scalar operator, on the device: 0.03j
    when the within-row contrast of the mass plane over rows
    [nz/4, 3nz/4) and columns [x0, x1) is below ``contrast_threshold``,
    else 0.25j (as the JAX package computes it; no host sync).
    '''

    nz = planes.shape[-2]
    z0, z1 = nz // 4, max(nz // 4 + 1, (3 * nz) // 4)
    mass = (planes[0, 0, CENTER, z0:z1, x0:x1]
            - precond_planes[0, 0, CENTER, z0:z1, x0:x1]) / shift
    ma = torch.abs(mass)
    tiny = torch.finfo(ma.dtype).tiny
    row_mean = torch.clamp(torch.mean(ma, dim=-1, keepdim=True), min=tiny)
    man = ma / row_mean
    contrast = torch.sqrt(torch.max(man)
                          / torch.clamp(torch.min(man), min=tiny))
    small = torch.tensor(0.03, dtype=ma.dtype, device=ma.device)
    large = torch.tensor(0.25, dtype=ma.dtype, device=ma.device)
    return torch.where(contrast < contrast_threshold, small, large) * 1j


def _bands(cF, width):
    '''
    The (l, d, u) bands over the cross-line wavenumbers of an x-transform
    of ``width``: T_dz(z, kx) = sum_dx cF[(dz, dx)](z) e^{i kx dx}, from
    per-row coefficients cF (9, nz); each band (nz, width).
    '''

    kx = (2 * np.pi) * torch.fft.fftfreq(width, dtype=cF.real.dtype,
                                         device=cF.device)
    bands = []
    for dz in (-1, 0, 1):
        acc = None
        for dx in (-1, 0, 1):
            k = (dz + 1) * 3 + (dx + 1)
            phase = torch.exp(1j * kx * dx).to(cF.dtype)   # (width,)
            term = cF[k][:, None] * phase[None, :]
            acc = term if acc is None else acc + term
        bands.append(acc)
    return tuple(bands)


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
        raise ValueError('stratified_coeffs: scalar operators only; block '
                         'operators take stratified_coeffs_block')
    c0 = _per_row_mean(planes)[0, 0]           # (9, nz)
    cP = _per_row_mean(precond_planes)[0, 0]
    cdtype = c0.dtype
    shift = torch.as_tensor(shift, dtype=cdtype, device=c0.device)
    cM = (c0 - cP) / shift

    nx = planes.shape[-1]
    if isinstance(fft_shift, str):  # 'auto'
        x0, x1 = nx // 4, max(nx // 4 + 1, (3 * nx) // 4)
        fft_shift = _auto_fft_shift(planes, precond_planes, shift, x0, x1,
                                    contrast_threshold)
    fs = torch.as_tensor(fft_shift, dtype=cdtype, device=c0.device)
    return _bands(c0 - fs * cM, nx)   # (l, d, u)


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
    pcr = pcr_precompute(*transpose_strat(tuple(ldu)), delta=delta,
                         quantize=False)
    # the DFT matrices are symmetric: the transpose reuses them unchanged
    return pcr._replace(dft=getattr(strat, 'dft', None))


def stratified_apply(strat, r, transpose=False):
    '''
    Apply the stratified interior inverse to r (R, 1, nz, nx): x-FFT (or
    the DFT matmul, see StratPCR.dft), per-kx tridiagonal solve in z (the
    precomputed PCR sweep), inverse x-transform.

    With ``transpose=True``, ``strat`` is the transposed family
    (``transpose_pcr``) and this applies the algebraic transpose
    P^T = F T^{-T} F^{-1} (the x-DFT matrix is symmetric), sweeping the
    full-precision factors in plain torch on every device: it is not a
    kernel, in the JAX package or here.
    '''

    fwd, inv = _x_transforms(strat, r.shape[-1])
    if transpose:
        xhat = _pcr_sweep_rhs(strat.alphas, strat.gammas, strat.dinv,
                              inv(r))
        return fwd(xhat)
    return inv(pcr_apply(strat, fwd(r[:, 0])))[:, None]


# ---------------------------------------------------------------------------
# x-panelled stratification: the per-row mean misses LATERAL velocity
# structure. x is partitioned into overlapping panels blended by a
# partition of unity; per panel, per-row means over ITS window, a
# per-panel x-transform and z-PCR solve, and a scatter-add of the weighted
# panel solutions. The panels concatenate along x, so one PCR sweep (K3 on
# the card) covers them all.
# ---------------------------------------------------------------------------

def panel_layout(nx, npanels, overlap):
    '''
    Static panel windows: cores of width C = nx // npanels (the last core
    absorbs the remainder), each window extended by ``overlap`` on both
    sides and clamped to the domain; all windows share one width W.
    Returns (starts tuple, W). Raises ValueError when the windows leave a
    column uncovered.
    '''

    C = nx // npanels
    W = min(nx, C + (nx - C * (npanels - 1)) % max(C, 1) + 2 * overlap)
    starts = []
    for p in range(npanels):
        s = p * C - overlap
        starts.append(max(0, min(s, nx - W)))
    # the last window must reach the domain edge
    starts[-1] = nx - W
    covered = np.zeros(nx, bool)
    for s in starts:
        covered[s:s + W] = True
    if not covered.all():
        raise ValueError('panel_layout: nx=%d npanels=%d overlap=%d leaves '
                         'columns uncovered' % (nx, npanels, overlap))
    return tuple(starts), W


def panel_weights(nx, npanels, overlap, dtype=np.float32):
    '''
    Partition-of-unity blend weights, (P, W): tent ramps of length
    ``overlap`` at interior panel edges, flat elsewhere, normalized so the
    pointwise sum over panels is exactly 1 everywhere.
    '''

    starts, W = panel_layout(nx, npanels, overlap)
    ramp = max(overlap, 1)
    w = np.zeros((npanels, nx), np.float64)
    for p, s in enumerate(starts):
        x = np.arange(s, s + W)
        up = np.minimum(1.0, (x - s + 1) / ramp)
        dn = np.minimum(1.0, (s + W - x) / ramp)
        w[p, s:s + W] = np.minimum(up, dn)
    colsum = w.sum(axis=0, keepdims=True)
    if not colsum.min() > 1.0 / max(overlap, 1) - 1e-9:
        raise ValueError('panel_weights: coverage hole (min column weight '
                         '%g)' % colsum.min())
    w /= colsum
    out = np.zeros((npanels, W), np.float64)
    for p, s in enumerate(starts):
        out[p] = w[p, s:s + W]
    return out.astype(dtype)


def stratified_coeffs_panels(planes, precond_planes, shift, fft_shift,
                             npanels, overlap, dst=False):
    '''
    Per-panel stratified tridiagonal coefficients of a scalar operator:
    (l, d, u), each (nz, P * W), panel p in columns [p W, (p+1) W), with
    kx of the panel width W. An 'auto' fft_shift resolves per panel from
    the within-panel contrast, on the device. ``dst=True`` doubles the kx
    grid to 2W (the odd-extension solve of taper 'dst'): (nz, P * 2W).
    '''

    if planes.shape[0] != 1:
        raise ValueError('stratified_coeffs_panels: scalar operators only')
    nx = planes.shape[-1]
    starts, W = panel_layout(nx, npanels, overlap)
    # interior x-columns for the mean (exclude the x-PML frames)
    xlo, xhi = nx // 8, nx - nx // 8
    shift = torch.as_tensor(shift, dtype=planes.dtype, device=planes.device)
    bands_all = [[], [], []]
    for s in starts:
        a, b = max(s, xlo), min(s + W, xhi)
        if b <= a:          # panel fully inside a PML frame: its window
            a, b = s, s + W
        c0 = torch.mean(planes[0, 0, :, :, a:b], dim=-1)          # (9, nz)
        cP = torch.mean(precond_planes[0, 0, :, :, a:b], dim=-1)
        cM = (c0 - cP) / shift
        fshift = fft_shift
        if isinstance(fshift, str):  # 'auto', per panel
            fshift = _auto_fft_shift(planes, precond_planes, shift, a, b)
        fs = torch.as_tensor(fshift, dtype=c0.dtype, device=c0.device)
        for i, band in enumerate(_bands(c0 - fs * cM, 2 * W if dst else W)):
            bands_all[i].append(band)
    return tuple(torch.cat(b, dim=-1) for b in bands_all)


def _panel_gather(r, starts, W):
    '(..., nz, nx) -> (..., nz, P*W) panel-window gather.'
    return torch.cat([r[..., s:s + W] for s in starts], dim=-1)


def _panel_scatter(xp, starts, W, nx):
    '(..., nz, P*W) -> (..., nz, nx) overlapping scatter-add.'
    out = torch.zeros(xp.shape[:-1] + (nx,), dtype=xp.dtype,
                      device=xp.device)
    for p, s in enumerate(starts):
        out[..., s:s + W] += xp[..., p * W:(p + 1) * W]
    return out


def _panel_fft(rp, P, W, transform):
    'Apply an x-transform of width W blockwise to (..., nz, P*W).'
    out = transform(rp.reshape(rp.shape[:-1] + (P, W)))
    return out.reshape(rp.shape)


def _odd_extend(rp, P, W):
    '''
    Per-panel odd (Dirichlet) extension along x: (..., nz, P*W) ->
    (..., nz, P*2W), each panel followed by its negated reverse, so the
    periodic solve sees zero-Dirichlet panel edges.
    '''

    rps = rp.reshape(rp.shape[:-1] + (P, W))
    ext = torch.cat([rps, -torch.flip(rps, dims=(-1,))], dim=-1)
    return ext.reshape(rp.shape[:-1] + (P * 2 * W,))


def _odd_restrict(xp, P, W):
    '(..., nz, P*2W) -> (..., nz, P*W): keep each panel\'s first half.'
    return xp.reshape(xp.shape[:-1] + (P, 2 * W))[..., :W].reshape(
        xp.shape[:-1] + (P * W,))


def panel_solver(strat, nx, npanels, overlap, transpose=False, taper='out'):
    '''
    The x-panelled stratified interior inverse as a function r -> x of
    (R, 1, nz, nx) fields, with the panel layout and the taper weights
    built once (``stratified_apply_panels`` applies it once). See there
    for ``taper`` and ``transpose``.
    '''

    if taper not in ('in', 'out', 'sym', 'dst'):
        raise ValueError("stratified_apply_panels: taper must be 'in', "
                         "'out', 'sym' or 'dst', got %r" % (taper,))
    starts, W = panel_layout(nx, npanels, overlap)
    P = len(starts)
    dev, rdt = strat.ldu.device, strat.ldu.real.dtype
    # float32 weights (and their square roots) as the JAX package has them
    wts = torch.from_numpy(panel_weights(nx, npanels, overlap)).reshape(P * W)
    if taper == 'sym':
        w_in = w_out = torch.sqrt(wts).to(device=dev, dtype=rdt)
    elif taper == 'in':
        w_in, w_out = wts.to(device=dev, dtype=rdt), None
    else:  # 'out', 'dst'
        w_in, w_out = None, wts.to(device=dev, dtype=rdt)
    if transpose:
        w_in, w_out = w_out, w_in
    dst = taper == 'dst'
    Wx = 2 * W if dst else W
    fwd, inv = _x_transforms(strat, Wx)
    first, last = (inv, fwd) if transpose else (fwd, inv)

    def apply(r):
        rp = _panel_gather(r[:, 0], starts, W)
        if w_in is not None:
            rp = rp * w_in
        if dst:
            rp = _odd_extend(rp, P, W)
        rhat = _panel_fft(rp, P, Wx, first)
        if transpose:
            xhat = _pcr_sweep_rhs(strat.alphas, strat.gammas, strat.dinv,
                                  rhat)
        else:
            xhat = pcr_apply(strat, rhat)
        xp = _panel_fft(xhat, P, Wx, last)
        if dst:
            xp = _odd_restrict(xp, P, W)
        if w_out is not None:
            xp = xp * w_out
        return _panel_scatter(xp, starts, W, nx)[:, None]

    return apply


def stratified_apply_panels(strat, r, npanels, overlap, transpose=False,
                            taper='out'):
    '''
    Apply the x-panelled stratified interior inverse to r (R, 1, nz, nx):
    gather panel windows, per-panel x-transform, z-PCR solve over the
    concatenated panel columns (K3 on the card), inverse transform,
    partition-of-unity blend, overlapping scatter-add.

    ``taper`` says where the partition-of-unity weights act: 'out' on the
    solved output, 'in' on the gathered residual, 'sym' square roots on
    both, 'dst' zero-Dirichlet panel solves by odd extension to width 2W
    (the bands built with ``dst=True``), weights on the output.

    With ``transpose=True``, ``strat`` is the transposed family
    (``transpose_pcr``, full precision, swept in plain torch) and the
    weights move to the other side: the algebraic transpose.
    '''

    return panel_solver(strat, r.shape[-1], npanels, overlap, transpose,
                        taper)(r)


# ---------------------------------------------------------------------------
# Block (B = 2) family: the Eurus TTI system is a 2x2 block operator; its
# stratified interior solve is a block-tridiagonal family per kx, reduced
# by the same cyclic reduction with pointwise 2x2 block inverses. The
# factor recurrence spells its complex arithmetic out as the scalar one
# does, so the bf16 factors match the JAX package's bit for bit.
# ---------------------------------------------------------------------------

def _bmul(A, B):
    '2x2 block product: (2, 2, ...) x (2, 2, ...) pointwise over trailing.'

    rows = []
    for i in range(2):
        rows.append(torch.stack([_cmul(A[i, 0], B[0, j])
                                 + _cmul(A[i, 1], B[1, j])
                                 for j in range(2)], dim=0))
    return torch.stack(rows, dim=0)


def _bmatvec(A, x):
    '2x2 block times block vector: (2, 2, ...) x (..., 2, nz, nx).'

    out0 = A[0, 0] * x[..., 0, :, :] + A[0, 1] * x[..., 1, :, :]
    out1 = A[1, 0] * x[..., 0, :, :] + A[1, 1] * x[..., 1, :, :]
    return torch.stack([out0, out1], dim=-3)


def _binv(D, delta):
    '''
    2x2 block inverse with the determinant magnitude-clamped at
    ``delta * max|det|``, its phase preserved.
    '''

    a, b = D[0, 0], D[0, 1]
    c, d = D[1, 0], D[1, 1]
    det = _cmul(a, d) - _cmul(b, c)
    mag = torch.abs(det)
    dmin = delta * torch.max(mag)
    tiny = torch.finfo(mag.dtype).tiny
    phase = torch.where(mag > 0,
                        _cdiv(det, torch.clamp(mag, min=tiny).to(det.dtype)),
                        torch.ones((), dtype=det.dtype, device=det.device))
    det_s = torch.where(mag < dmin, _cmul(dmin.to(det.dtype), phase), det)
    inv = torch.stack([torch.stack([d, _cneg(b)], 0),
                       torch.stack([_cneg(c), a], 0)], 0)
    return _cdiv(inv, det_s)


def _bshift(A, s):
    'Shift 2x2 block coefficient arrays (2, 2, nz, nx) along z.'
    return _shift_z(A, s)


def _bcap(A, cap):
    '''
    Magnitude cap of a 2x2 block field: rescale any block whose Frobenius
    norm exceeds ``cap`` down to it (0 or None: no cap, the default).
    '''

    if not cap:
        return A
    nrm = torch.sqrt(sum(torch.abs(A[i, j]) ** 2
                         for i in range(2) for j in range(2)))
    scale = torch.clamp(cap / torch.clamp(nrm, min=1e-30), max=1.0)
    return A * scale.to(A.dtype)[None, None]


def _pcr_levels_block(L, D, U, delta, cap=0.0):
    '''
    The RHS-independent block cyclic-reduction recurrence. Returns
    (alphas, gammas) per level and the final reduced block inverse.
    '''

    alphas, gammas = [], []
    s = 1
    for _ in range(_pcr_nsteps(D.shape[-2])):
        alpha = _bcap(_bmul(_cneg(L), _binv(_bshift(D, -s), delta)), cap)
        gamma = _bcap(_bmul(_cneg(U), _binv(_bshift(D, +s), delta)), cap)
        L_new = _bmul(alpha, _bshift(L, -s))
        U_new = _bmul(gamma, _bshift(U, +s))
        D_new = (D + _bmul(alpha, _bshift(U, -s))
                 + _bmul(gamma, _bshift(L, +s)))
        alphas.append(alpha)
        gammas.append(gamma)
        L, D, U = L_new, D_new, U_new
        s *= 2
    return alphas, gammas, _binv(D, delta)


def _pcr_sweep_rhs_block(alphas, gammas, dinv, b):
    'RHS-only block reduction sweep with full-precision per-level factors.'

    s = 1
    for alpha, gamma in zip(alphas, gammas):
        b = (b + _bmatvec(alpha, _shift_z(b, -s))
             + _bmatvec(gamma, _shift_z(b, +s)))
        s *= 2
    return _bmatvec(dinv, b)


def block_tridiag_pcr_solve(L, D, U, b, delta=1e-6):
    '''
    Solve block-tridiagonal systems (2x2 blocks) along axis -2 of the
    block fields: T x[z] = L[z] x[z-1] + D[z] x[z] + U[z] x[z+1], with
    L, D, U (2, 2, nz, nx) and b (..., 2, nz, nx).
    '''

    return _pcr_sweep_rhs_block(*_pcr_levels_block(L, D, U, delta), b)


class StratPCRBlock(NamedTuple):
    '''
    Precomputed block cyclic-reduction state (B = 2). complex64 factors
    are stored as bfloat16 re/im pairs with the re/im axis second:
    (nsteps, 2, 2, 2, nz, nx), dinv (2, 2, 2, nz, nx).
    '''

    alphas: Any   # (nsteps, 2, 2, nz, nx) complex, or bf16 as above
    gammas: Any
    dinv: Any     # (2, 2, nz, nx) complex, or (2, 2, 2, nz, nx) bf16
    ldu: Any      # (3, 2, 2, nz, nx) original coefficients


def pcr_precompute_block(L, D, U, delta=1e-6, quantize=None):
    '''
    The RHS-independent block reduction, run once at preparation time.
    ``quantize`` (default: on for complex64) stores the factors as bf16
    re/im pairs (see StratPCRBlock).
    '''

    ldu = torch.stack([L, D, U], dim=0)
    alphas, gammas, dinv = _pcr_levels_block(L, D, U, delta)
    alphas = torch.stack(alphas, 0)
    gammas = torch.stack(gammas, 0)
    if quantize is None:
        quantize = D.dtype == torch.complex64
    if quantize:
        alphas = _pack_bf16(alphas).transpose(0, 1).contiguous()
        gammas = _pack_bf16(gammas).transpose(0, 1).contiguous()
        dinv = _pack_bf16(dinv)
    return StratPCRBlock(alphas, gammas, dinv, ldu)


def pcr_apply_block(pcr, b):
    '''
    RHS-only block cyclic-reduction sweep with precomputed levels, b
    (..., 2, nz, nx): plain torch on every device (no kernel, as in the
    JAX package), unpacking bf16 factors level by level.
    '''

    if pcr.alphas.dtype == torch.bfloat16:
        s = 1
        for i in range(pcr.alphas.shape[0]):
            a = _unpack_bf16(pcr.alphas[i], b.dtype)
            g = _unpack_bf16(pcr.gammas[i], b.dtype)
            b = (b + _bmatvec(a, _shift_z(b, -s))
                 + _bmatvec(g, _shift_z(b, +s)))
            s *= 2
        return _bmatvec(_unpack_bf16(pcr.dinv, b.dtype), b)
    return _pcr_sweep_rhs_block(pcr.alphas, pcr.gammas, pcr.dinv, b)


def stratified_coeffs_block(planes, precond_planes, shift, fft_shift):
    '''
    Per-row mean coefficients of a B = 2 block operator at the spectral
    CSLP shift: (L, D, U), each (2, 2, nz, nx) complex, the
    block-tridiagonal family over the cross-line wavenumber kx.
    ``fft_shift='auto'`` is the damped 0.25j for block operators.
    '''

    if planes.shape[0] != 2:
        raise ValueError('stratified_coeffs_block: B = 2 only')
    c0 = _per_row_mean(planes)            # (2, 2, 9, nz)
    cP = _per_row_mean(precond_planes)
    cdtype = c0.dtype
    shift = torch.as_tensor(shift, dtype=cdtype, device=c0.device)
    cM = (c0 - cP) / shift
    if isinstance(fft_shift, str):  # 'auto'
        fft_shift = 0.25j
    fs = torch.as_tensor(fft_shift, dtype=cdtype, device=c0.device)
    cF = c0 - fs * cM

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
            term = cF[:, :, k, :, None] * phase[None, None, None, :]
            acc = term if acc is None else acc + term
        bands.append(acc)                                 # (2, 2, nz, nx)
    return tuple(bands)


def stratified_apply_block(strat, r, transpose=False):
    '''
    Apply the block stratified interior inverse to r (R, 2, nz, nx):
    x-FFT, the precomputed block PCR sweep in z, inverse x-FFT. The
    transposed family (the TTI backward) is not ported yet.
    '''

    if transpose:
        raise NotImplementedError(
            'stratified_apply_block(transpose=True): the transposed block '
            'family belongs to TTI gradients, not ported yet (ROADMAP '
            'Queue 1, item 8b)')
    rhat = torch.fft.fft(r, dim=-1)
    return torch.fft.ifft(pcr_apply_block(strat, rhat), dim=-1)
