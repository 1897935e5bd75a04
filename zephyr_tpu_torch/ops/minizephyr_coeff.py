'''
Coefficient-plane builder for the MiniZephyr discretization: the port of
``zephyr_tpu.ops.minizephyr_coeff``.

The 9-point mixed-grid FDFD Helmholtz stencil of the reference
(uwoseis/zephyr, zephyr/backend/minizephyr.py:40-254): the OMEGA/FULLWV
optimal 9-point operator with Roecker-style quadratic-profile PML,
buoyancy averaging at the 9 stencil points, 2.5D cross-line wavenumber
(ky in the mass term), Laplace-domain damping (omega -> omega - i/tau)
and Dirichlet/free-surface boundary rows. The output is a (9, nz, nx)
complex tensor in the ordering of ``zephyr_tpu_torch.ops.stencil.OFFSETS``.
Plain torch on tensors, so autograd flows through ``c`` and ``rho``.
'''

import math

import torch

# Optimal 9-point stencil weights (reference minizephyr.py:204-209)
ACOEF = 0.5461
BCOEF = 0.4539
CCOEF = 0.6248
DCOEF = 0.09381
ECOEF = 0.000001297

PMLR = 1e-3  # PML target reflection coefficient (minizephyr.py:94)


def _edge_pad(arr):
    '''
    Pad a 2D field by one cell on every side, replicating edges. Built by
    index concatenation, which works for complex tensors too.
    '''
    nz, nx = arr.shape
    iz = torch.cat([torch.zeros(1, dtype=torch.long),
                    torch.arange(nz), torch.full((1,), nz - 1)])
    ix = torch.cat([torch.zeros(1, dtype=torch.long),
                    torch.arange(nx), torch.full((1,), nx - 1)])
    return arr[iz.to(arr.device)][:, ix.to(arr.device)]


def minizephyr_planes(c, rho, freq, dx=1.0, dz=1.0, nPML=10, ky=0.0,
                      tau=math.inf, freeSurf=(False, False, False, False),
                      pml=True, pml_cap=None):
    '''
    Build the (9, nz, nx) coefficient planes of the MiniZephyr operator.

    Args:
        c: (nz, nx) complex wave velocity tensor; its dtype (complex64 or
            complex128) and device set those of the planes
        rho: (nz, nx) real bulk density tensor
        freq: frequency in Hz (real or complex scalar)
        dx, dz: grid spacing
        nPML: PML thickness in grid points
        ky: cross-line wavenumber for 2.5D operation
        tau: Laplace-domain damping time constant (inf = none)
        freeSurf: 4-tuple of free-surface flags (bottom, right, top, left),
            index 0 applying to grid row 0 and index 2 to the last row
        pml: if False, the interior stencil everywhere (no absorbing layer)
        pml_cap: if set, limit the PML decay strength to pml_cap * |omega|
            (the preconditioner planes)

    Returns:
        (9, nz, nx) complex planes.
    '''

    cdtype = torch.promote_types(c.dtype, torch.complex64)
    c = c.to(cdtype)
    rdtype = c.real.dtype
    rho = (rho.real if rho.is_complex() else rho).to(rdtype)
    nz, nx = c.shape
    dev = c.device

    # host scalars (python complex): 1j / inf is 0 there, as in XLA
    omega = 2 * math.pi * complex(freq)
    dampCoeff = 1j / complex(tau)
    omegaDamped = omega - dampCoeff

    cPad = _edge_pad(c)
    rhoPad = _edge_pad(rho)

    aky = 2 * math.pi * ky

    dxx = dx ** 2
    dzz = dz ** 2
    dxz = (dxx + dzz) / 2
    dd = math.sqrt(dxz)
    iom = 1j * omegaDamped

    # --- PML decay profiles (quadratic, Roecker fdfdpml.f style) -----------
    pmldx = dx * (nPML - 1)
    pmldz = dz * (nPML - 1)
    pmlfx = 3.0 * math.log(1.0 / PMLR) / (2 * pmldx ** 3)
    pmlfz = 3.0 * math.log(1.0 / PMLR) / (2 * pmldz ** 3)

    ramp_dn = torch.arange(nPML, 0, -1, device=dev)
    ramp_up = torch.arange(1, nPML + 1, device=dev)
    dpmlx = torch.zeros((nz, nx), dtype=cdtype, device=dev)
    dpmlx[:, :nPML] = (ramp_dn * dx).to(cdtype)[None, :]
    dpmlx[:, -nPML:] = (ramp_up * dx).to(cdtype)[None, :]

    dpmlz = torch.zeros((nz, nx), dtype=cdtype, device=dev)
    dpmlz[:nPML, :] = (ramp_dn * dz).to(cdtype)[:, None]
    dpmlz[-nPML:, :] = (ramp_up * dz).to(cdtype)[:, None]

    # Sign masks: PML absorbing term enabled only where no free surface
    isnx = torch.zeros((nz, nx), dtype=rdtype, device=dev)
    isnz = torch.zeros((nz, nx), dtype=rdtype, device=dev)
    if not freeSurf[2]:
        isnz[-nPML:, :] = -1.0   # top
    if not freeSurf[1]:
        isnx[:, -nPML:] = -1.0   # right
    if not freeSurf[0]:
        isnz[:nPML, :] = 1.0     # bottom
    if not freeSurf[3]:
        isnx[:, :nPML] = 1.0     # left

    if pml:
        dnx = pmlfx * c * dpmlx ** 2
        ddnx = 2 * pmlfx * c * dpmlx
        dnz = pmlfz * c * dpmlz ** 2
        ddnz = 2 * pmlfz * c * dpmlz

        if pml_cap is not None:
            cap = pml_cap * abs(omegaDamped)
            fx = torch.clamp(cap / torch.clamp(torch.abs(dnx), min=1e-30),
                             max=1.0)
            fz = torch.clamp(cap / torch.clamp(torch.abs(dnz), min=1e-30),
                             max=1.0)
            dnx, ddnx = fx * dnx, fx * ddnx
            dnz, ddnz = fz * dnz, fz * ddnz

        denx = dnx + iom
        r1x = iom / denx
        r1xsq = r1x ** 2
        r2x = isnx * r1xsq * ddnx / denx

        denz = dnz + iom
        r1z = iom / denz
        r1zsq = r1z ** 2
        r2z = isnz * r1zsq * ddnz / denz
    else:
        one = torch.ones((nz, nx), dtype=cdtype, device=dev)
        zero = torch.zeros((nz, nx), dtype=cdtype, device=dev)
        r1xsq = r1zsq = one
        r2x = r2z = zero

    # --- Buoyancies, averaged between centre and neighbours ----------------
    bMM = 1.0 / rhoPad[0:-2, 0:-2]
    bME = 1.0 / rhoPad[0:-2, 1:-1]
    bMP = 1.0 / rhoPad[0:-2, 2:]
    bEM = 1.0 / rhoPad[1:-1, 0:-2]
    bEE = 1.0 / rhoPad[1:-1, 1:-1]
    bEP = 1.0 / rhoPad[1:-1, 2:]
    bPM = 1.0 / rhoPad[2:, 0:-2]
    bPE = 1.0 / rhoPad[2:, 1:-1]
    bPP = 1.0 / rhoPad[2:, 2:]

    bMM = (bEE + bMM) / 2
    bME = (bEE + bME) / 2
    bMP = (bEE + bMP) / 2
    bEM = (bEE + bEM) / 2
    bEP = (bEE + bEP) / 2
    bPM = (bEE + bPM) / 2
    bPE = (bEE + bPE) / 2
    bPP = (bEE + bPP) / 2

    # --- Mass term ----------------------------------------------------------
    K = ((omegaDamped ** 2 / cPad ** 2) - aky ** 2) / rhoPad
    kMM = K[0:-2, 0:-2]
    kME = K[0:-2, 1:-1]
    kMP = K[0:-2, 2:]
    kEM = K[1:-1, 0:-2]
    kEE = K[1:-1, 1:-1]
    kEP = K[1:-1, 2:]
    kPM = K[2:, 0:-2]
    kPE = K[2:, 1:-1]
    kPP = K[2:, 2:]

    # --- The nine diagonals (minizephyr.py:219-243 verbatim semantics) -----
    AD = ECOEF * kMM \
        + BCOEF * bMM * ((r1zsq + r1xsq) / (4 * dxz) - (r2z + r2x) / (4 * dd))
    DD = DCOEF * kME \
        + ACOEF * bME * (r1zsq / dz - r2z / 2) / dz \
        + BCOEF * (r1zsq - r1xsq) * (bMP + bMM) / (4 * dxz)
    CD = ECOEF * kMP \
        + BCOEF * bMP * ((r1zsq + r1xsq) / (4 * dxz) - (r2z - r2x) / (4 * dd))
    AA = DCOEF * kEM \
        + ACOEF * bEM * (r1xsq / dx - r2x / 2) / dx \
        + BCOEF * (r1xsq - r1zsq) * (bPM + bMM) / (4 * dxz)
    BE = CCOEF * kEE \
        + ACOEF * (r2x * (bEM - bEP) / (2 * dx) + r2z * (bME - bPE) / (2 * dz)
                   - r1xsq * (bEM + bEP) / dxx - r1zsq * (bME + bPE) / dzz) \
        + BCOEF * (((r2x + r2z) * (bMM - bPP) + (r2z - r2x) * (bMP - bPM))
                   / (4 * dd)
                   - (r1xsq + r1zsq) * (bMM + bPP + bPM + bMP) / (4 * dxz))
    CC = DCOEF * kEP \
        + ACOEF * bEP * (r1xsq / dx + r2x / 2) / dx \
        + BCOEF * (r1xsq - r1zsq) * (bMP + bPP) / (4 * dxz)
    AF = ECOEF * kPM \
        + BCOEF * bPM * ((r1zsq + r1xsq) / (4 * dxz) + (r2z - r2x) / (4 * dd))
    FF = DCOEF * kPE \
        + ACOEF * bPE * (r1zsq / dz + r2z / 2) / dz \
        + BCOEF * (r1zsq - r1xsq) * (bPM + bPP) / (4 * dxz)
    CF = ECOEF * kPP \
        + BCOEF * bPP * ((r1zsq + r1xsq) / (4 * dxz) + (r2z + r2x) / (4 * dd))

    # Plane order: see module docstring / stencil.OFFSETS
    planes = torch.stack([AD, DD, CD, AA, BE, CC, AF, FF, CF], dim=0)

    return _apply_boundary(planes, freeSurf)


def _apply_boundary(planes, freeSurf):
    '''
    Dirichlet / free-surface boundary rows (minizephyr.py:256-298): every
    off-diagonal plane is zeroed on the boundary ring; the centre plane is
    set to -1 where the corresponding free surface is active, else +1.
    Applied in the reference's order (left, right, bottom, top) so corner
    values match.
    '''

    def pick(side):
        return -1.0 if freeSurf[side] else 1.0

    CENTER = 4
    planes = planes.clone()
    for sl, side in (((slice(None), slice(None), 0), 3),
                     ((slice(None), slice(None), -1), 1),
                     ((slice(None), 0, slice(None)), 0),
                     ((slice(None), -1, slice(None)), 2)):
        planes[sl] = 0
        planes[(CENTER,) + sl[1:]] = pick(side)
    return planes
