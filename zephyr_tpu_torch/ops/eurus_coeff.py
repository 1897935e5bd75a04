'''
Coefficient-plane builder for the Eurus TTI discretization: the port of
``zephyr_tpu.ops.eurus_coeff``.

The 9-point mixed-grid anisotropic (TTI viscoacoustic) FDFD stencil of the
reference (uwoseis/zephyr, zephyr/backend/eurus.py:28-464), after Operto
et al. (2009): Thomsen parameters (theta, eps, delta) map to direction
coefficients Ax..Hz; the PML is the cosine-profile complex stretch
Xi = 1 - i gamma / omega with gamma = cPML cos(pi/2 d/L); the mass term
uses the anti-lumped 9-point weights; the operator is a coupled pair of
wavefields, a 2x2 block of 9-point stencils A = [[M1, M2], [M3, M4]].

Output: (2, 2, 9, nz, nx) complex planes in the ordering of
``zephyr_tpu_torch.ops.stencil.OFFSETS``. The reference's Eurus matrix
ordering mord=(-nx, +1) flips z, so the coefficient slices named "bottom"
(z-1 in array coordinates) are applied to the z+1 neighbour and vice
versa: the stencil is z-mirrored relative to MiniZephyr. This quirk is
reproduced exactly (it is invisible for z-symmetric media).

Boundary rows zero every off-centre plane on the boundary ring and leave
the EE diagonal untouched (eurus.py:466-485). Plain torch on tensors, so
autograd flows through ``c`` and ``rho``; complex64 and complex128.
'''

import math

import torch

from .minizephyr_coeff import _edge_pad

# Anti-lumped mass weights and Laplacian weight (eurus.py:244-252)
WM1 = 0.6287326
WM2 = 0.3712667
W1 = 0.4382634


def _edge_pad1(v):
    'Pad a 1D tensor by one entry at each end, replicating the edges.'
    return torch.cat([v[:1], v, v[-1:]])


def _pml_stretch(n, d, nPML, cPML, cap, omegaDamped, cdtype, dev):
    '''
    The (n + 2,) complex stretch Xi = 1 - i gamma / omega along one axis,
    edge-padded, with gamma limited to ``cap`` when it is set.
    '''

    pmld = d * (nPML - 1)
    vals = torch.arange(nPML, dtype=torch.float64, device=dev) * d
    ramp = (cPML * torch.cos((math.pi / 2) * (vals / pmld))).to(cdtype)
    gamma = torch.zeros((n,), dtype=cdtype, device=dev)
    gamma[:nPML] = ramp
    gamma[-nPML:] = ramp.flip(0)
    if cap is not None:
        gamma = gamma * torch.clamp(
            cap / torch.clamp(torch.abs(gamma), min=1e-30), max=1.0)
    return 1 - (1j * _edge_pad1(gamma)) / omegaDamped


def eurus_planes(c, rho, freq, theta=None, eps=None, delta=None,
                 dx=1.0, dz=1.0, nPML=10, cPML=1e3, tau=math.inf,
                 freeSurf=(False, False, False, False), pml=True,
                 pml_cap=None):
    '''
    Build the (2, 2, 9, nz, nx) coefficient planes of the Eurus operator.

    Args:
        c: (nz, nx) complex velocity tensor; its dtype (complex64 or
            complex128) and device set those of the planes
        rho: (nz, nx) density tensor
        freq: frequency (may be complex, per eurus.py:23)
        theta, eps, delta: (nz, nx) Thomsen fields (default zero)
        nPML: PML thickness in cells; cPML: PML amplitude (eurus.py:500-504)
        tau: Laplace damping constant
        freeSurf: kept for API parity (the Eurus boundary treatment does
            not branch on it; eurus.py:466-485)
        pml: if False, Xi = 1 everywhere
        pml_cap: if set, limit the PML decay gamma to pml_cap * |omega|
            (the preconditioner planes)

    Returns:
        (2, 2, 9, nz, nx) complex planes.
    '''

    cdtype = torch.promote_types(c.dtype, torch.complex64)
    c = c.to(cdtype)
    rdtype = c.real.dtype
    rho = (rho.real if rho.is_complex() else rho).to(rdtype)
    nz, nx = c.shape
    dev = c.device

    def field(v):
        if v is None:
            return torch.zeros((nz, nx), dtype=rdtype, device=dev)
        v = torch.as_tensor(v, device=dev)
        return (v.real if v.is_complex() else v).to(rdtype)

    theta, eps, delta = field(theta), field(eps), field(delta)

    # host scalars (python complex): 1j / inf is 0 there, as in XLA
    omega = 2 * math.pi * complex(freq)
    dampCoeff = 1j / complex(tau)
    omegaDamped = omega - dampCoeff

    cPad = _edge_pad(c)
    rhoPad = _edge_pad(rho)

    dxx = dx ** 2
    dzz = dz ** 2

    # --- PML complex stretch (eurus.py:76-97) ------------------------------
    if pml:
        cap = None if pml_cap is None else pml_cap * abs(omegaDamped)
        Xi_x = _pml_stretch(nx, dx, nPML, cPML, cap, omegaDamped, cdtype,
                            dev).reshape(1, nx + 2)
        Xi_z = _pml_stretch(nz, dz, nPML, cPML, cap, omegaDamped, cdtype,
                            dev).reshape(nz + 2, 1)
    else:
        Xi_x = torch.ones((1, nx + 2), dtype=cdtype, device=dev)
        Xi_z = torch.ones((nz + 2, 1), dtype=cdtype, device=dev)

    Xi_x1 = Xi_x[:, 0:-2]
    Xi_x2 = Xi_x[:, 1:-1]
    Xi_x3 = Xi_x[:, 2:]
    Xi_z1 = Xi_z[0:-2, :]
    Xi_z2 = Xi_z[1:-1, :]
    Xi_z3 = Xi_z[2:, :]

    Xi_x_M = (Xi_x1 + Xi_x2) / 2
    Xi_x_C = Xi_x2
    Xi_x_P = (Xi_x2 + Xi_x3) / 2
    Xi_z_M = (Xi_z1 + Xi_z2) / 2
    Xi_z_C = Xi_z2
    Xi_z_P = (Xi_z2 + Xi_z3) / 2

    L_x4 = 1 / (4 * Xi_x_C * dxx)
    L_x = 1 / (Xi_x_C * dxx)
    L_z4 = 1 / (4 * Xi_z_C * dzz)
    L_z = 1 / (Xi_z_C * dzz)

    # --- Buoyancies (eurus.py:171-226) -------------------------------------
    b_GG = 1. / rhoPad[0:-2, 0:-2]
    b_HH = 1. / rhoPad[0:-2, 1:-1]
    b_II = 1. / rhoPad[0:-2, 2:]
    b_DD = 1. / rhoPad[1:-1, 0:-2]
    b_EE = 1. / rhoPad[1:-1, 1:-1]
    b_FF = 1. / rhoPad[1:-1, 2:]
    b_AA = 1. / rhoPad[2:, 0:-2]
    b_BB = 1. / rhoPad[2:, 1:-1]
    b_CC = 1. / rhoPad[2:, 2:]

    b_SQ1_x = ((b_AA + b_BB + b_DD + b_EE) / 4) / Xi_x_M
    b_SQ2_x = ((b_BB + b_CC + b_EE + b_FF) / 4) / Xi_x_P
    b_SQ3_x = ((b_DD + b_EE + b_GG + b_HH) / 4) / Xi_x_M
    b_SQ4_x = ((b_EE + b_FF + b_HH + b_II) / 4) / Xi_x_P

    b_SQ1_z = ((b_AA + b_BB + b_DD + b_EE) / 4) / Xi_z_M
    b_SQ2_z = ((b_BB + b_CC + b_EE + b_FF) / 4) / Xi_z_M
    b_SQ3_z = ((b_DD + b_EE + b_GG + b_HH) / 4) / Xi_z_P
    b_SQ4_z = ((b_EE + b_FF + b_HH + b_II) / 4) / Xi_z_P

    b_LN1 = ((b_BB + b_EE) / 2) / Xi_z_M
    b_LN2 = ((b_DD + b_EE) / 2) / Xi_x_M
    b_LN3 = ((b_EE + b_FF) / 2) / Xi_x_P
    b_LN4 = ((b_EE + b_HH) / 2) / Xi_z_P

    b_LN1_C = ((b_BB + b_EE) / 2) / Xi_x_C
    b_LN2_C = ((b_DD + b_EE) / 2) / Xi_z_C
    b_LN3_C = ((b_EE + b_FF) / 2) / Xi_z_C
    b_LN4_C = ((b_EE + b_HH) / 2) / Xi_x_C

    # --- Mass term with anti-lumped weights (eurus.py:229-269) -------------
    K = (omegaDamped * omegaDamped) / (rhoPad * cPad ** 2)
    wm3 = 0.25 * (1. - WM1 - WM2)
    wm2 = 0.25 * WM2
    KGG = wm3 * K[0:-2, 0:-2]
    KHH = wm2 * K[0:-2, 1:-1]
    KII = wm3 * K[0:-2, 2:]
    KDD = wm2 * K[1:-1, 0:-2]
    KEE = WM1 * K[1:-1, 1:-1]
    KFF = wm2 * K[1:-1, 2:]
    KAA = wm3 * K[2:, 0:-2]
    KBB = wm2 * K[2:, 1:-1]
    KCC = wm3 * K[2:, 2:]

    # --- Direction coefficients (eurus.py:279-295) -------------------------
    cos2 = torch.cos(theta) ** 2
    sin2 = torch.sin(theta) ** 2
    sin2t = torch.sin(2 * theta)

    Ax = 1. + (2. * delta) * cos2
    Bx = (-1. * delta) * sin2t
    Cx = (1. + 2. * delta) * cos2
    Dx = (-0.5 * (1. + 2. * delta)) * sin2t
    Ex = (2. * (eps - delta)) * cos2
    Fx = (-1. * (eps - delta)) * sin2t
    Gx = Ex
    Hx = Fx

    Az = Bx
    Bz = 1. + (2. * delta) * sin2
    Cz = Dx
    Dz = (1. + 2. * delta) * sin2
    Ez = Fx
    Fz = (2. * (eps - delta)) * sin2
    Gz = Fx
    Hz = Fz

    def generate(massTerm, c1x, c1z, c2x, c2z):
        '''
        The nine diagonals of one block of the anisotropic mixed-grid
        stencil (eurus.py:300-427, Operto et al. 2009 Appendix).
        '''

        GG = (massTerm * KGG) \
            + W1 * ((L_x4 * c1x) * b_SQ3_x
                    + (-1 * L_x4 * c2x) * b_SQ3_z
                    + (-1 * L_z4 * c1z) * b_SQ3_x
                    + (L_z4 * c2z) * b_SQ3_z) \
            + (1 - W1) * ((-1 * L_x4 * c2x) * b_LN2_C
                          + (-1 * L_z4 * c1z) * b_LN4_C)
        HH = (massTerm * KHH) \
            + W1 * ((L_x4 * c1x) * (- b_SQ3_x - b_SQ4_x)
                    + (L_x4 * c2x) * (- b_SQ3_z + b_SQ4_z)
                    + (L_z4 * c1z) * (b_SQ3_x - b_SQ4_x)
                    + (L_z4 * c2z) * (b_SQ3_z + b_SQ4_z)) \
            + (1 - W1) * ((L_x4 * c2x) * (- b_LN2_C + b_LN3_C)
                          + (L_z * c2z) * b_LN4)
        II = (massTerm * KII) \
            + W1 * ((L_x4 * c1x) * b_SQ4_x
                    + (L_x4 * c2x) * b_SQ4_z
                    + (L_z4 * c1z) * b_SQ4_x
                    + (L_z4 * c2z) * b_SQ4_z) \
            + (1 - W1) * ((L_x4 * c2x) * b_LN3_C
                          + (L_z4 * c1z) * b_LN4_C)
        DD = (massTerm * KDD) \
            + W1 * ((L_x4 * c1x) * (b_SQ3_x + b_SQ1_x)
                    + (L_x4 * c2x) * (b_SQ3_z - b_SQ1_z)
                    + (L_z4 * c1z) * (- b_SQ3_x + b_SQ1_x)
                    + (L_z4 * c2z) * (- b_SQ3_z - b_SQ1_z)) \
            + (1 - W1) * ((L_x * c1x) * b_LN2
                          + (L_z4 * c1z) * (- b_LN4_C + b_LN1_C))
        EE = (massTerm * KEE) \
            + W1 * ((-1 * L_x4 * c1x) * (b_SQ1_x + b_SQ2_x + b_SQ3_x
                                         + b_SQ4_x)
                    + (L_x4 * c2x) * (b_SQ2_z + b_SQ3_z - b_SQ1_z - b_SQ4_z)
                    + (L_z4 * c1z) * (b_SQ2_x + b_SQ3_x - b_SQ1_x - b_SQ4_x)
                    + (-1 * L_z4 * c2z) * (b_SQ1_z + b_SQ2_z + b_SQ3_z
                                           + b_SQ4_z)) \
            + (1 - W1) * ((L_x * c1x) * (- b_LN2 - b_LN3)
                          + (L_z * c2z) * (- b_LN1 - b_LN4))
        FF = (massTerm * KFF) \
            + W1 * ((L_x4 * c1x) * (b_SQ2_x + b_SQ4_x)
                    + (L_x4 * c2x) * (b_SQ2_z - b_SQ4_z)
                    + (L_z4 * c1z) * (- b_SQ2_x + b_SQ4_x)
                    + (L_z4 * c2z) * (- b_SQ2_z - b_SQ4_z)) \
            + (1 - W1) * ((L_x * c1x) * b_LN3
                          + (L_z4 * c1z) * (b_LN4_C - b_LN1_C))
        AA = (massTerm * KAA) \
            + W1 * ((L_x4 * c1x) * b_SQ1_x
                    + (L_x4 * c2x) * b_SQ1_z
                    + (L_z4 * c1z) * b_SQ1_x
                    + (L_z4 * c2z) * b_SQ1_z) \
            + (1 - W1) * ((L_x4 * c2x) * b_LN2_C
                          + (L_z4 * c1z) * b_LN1_C)
        BB = (massTerm * KBB) \
            + W1 * ((L_x4 * c1x) * (- b_SQ2_x - b_SQ1_x)
                    + (L_x4 * c2x) * (- b_SQ2_z + b_SQ1_z)
                    + (L_z4 * c1z) * (b_SQ2_x - b_SQ1_x)
                    + (L_z4 * c2z) * (b_SQ2_z + b_SQ1_z)) \
            + (1 - W1) * ((L_x4 * c2x) * (- b_LN3_C + b_LN2_C)
                          + (L_z * c2z) * b_LN1)
        CC = (massTerm * KCC) \
            + W1 * ((L_x4 * c1x) * b_SQ2_x
                    + (-1 * L_x4 * c2x) * b_SQ2_z
                    + (-1 * L_z4 * c1z) * b_SQ2_x
                    + (L_z4 * c2z) * b_SQ2_z) \
            + (1 - W1) * ((-1 * L_x4 * c2x) * b_LN3_C
                          + (-1 * L_z4 * c1z) * b_LN1_C)

        # Plane order k0..k8 per stencil.OFFSETS, with the Eurus offset
        # mapping (module docstring): [AA BB CC DD EE FF GG HH II]
        planes = torch.stack(
            [torch.broadcast_to(p, (nz, nx)).to(cdtype)
             for p in (AA, BB, CC, DD, EE, FF, GG, HH, II)], dim=0)
        return _eurus_boundary(planes)

    M1 = generate(1., Ax, Az, Bx, Bz)
    M2 = generate(0., Cx, Cz, Dx, Dz)
    M3 = generate(0., Ex, Ez, Fx, Fz)
    M4 = generate(1., Gx, Gz, Hx, Hz)

    return torch.stack([torch.stack([M1, M2], dim=0),
                        torch.stack([M3, M4], dim=0)], dim=0)


def _eurus_boundary(planes):
    'Zero the off-centre planes on the boundary ring; EE untouched.'

    CENTER = 4
    planes = planes.clone()
    off = [k for k in range(9) if k != CENTER]
    planes[off, :, 0] = 0
    planes[off, :, -1] = 0
    planes[off, 0, :] = 0
    planes[off, -1, :] = 0
    return planes
