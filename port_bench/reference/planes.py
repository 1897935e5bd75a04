'''
The 9-point MiniZephyr Helmholtz operator, written out plainly in torch
float64 / complex128 from its definition (the OMEGA/FULLWV optimal
9-point mixed-grid stencil of uwoseis/zephyr, minizephyr.py:40-298):
quadratic-profile PML on all four sides (target reflection 1e-3),
buoyancy averaged between the centre and each neighbour, Dirichlet rows
on the outer ring. No free surface, no cross-line wavenumber, no
Laplace damping: the benchmark's configurations use none of them.

Planes are (9, nz, nx); plane k = 3 (dz + 1) + (dx + 1) multiplies
u[z + dz, x + dx]. Autograd flows through ``c``.
'''

import math

import torch

A_W, B_W, C_W, D_W, E_W = 0.5461, 0.4539, 0.6248, 0.09381, 0.000001297
PML_R = 1e-3


def _pad_edge(a):
    return torch.nn.functional.pad(a[None, None], (1, 1, 1, 1),
                                   mode='replicate')[0, 0]


def _neighbours(a):
    'The nine shifted (nz, nx) views of an edge-padded field, k order.'
    p = _pad_edge(a)
    nz, nx = a.shape
    return [p[1 + dz:1 + dz + nz, 1 + dx:1 + dx + nx]
            for dz in (-1, 0, 1) for dx in (-1, 0, 1)]


def helmholtz_planes(c, freq, dx=1.0, dz=1.0, npml=10, rho=None):
    '''
    (9, nz, nx) complex128 planes of the operator for a real velocity
    ``c`` (nz, nx) at ``freq`` on a grid of spacing dx, dz.
    '''

    c = c.to(torch.float64)
    nz, nx = c.shape
    dev = c.device
    rho = (torch.ones_like(c) if rho is None else rho.to(torch.float64))
    omega = 2 * math.pi * float(freq)
    iom = 1j * omega
    dxx, dzz = dx * dx, dz * dz
    dxz = (dxx + dzz) / 2
    dd = math.sqrt(dxz)

    # distance into the absorbing layer, and its sign (+1 on the low
    # side, -1 on the high side; where the two layers overlap, on a grid
    # narrower than two of them, the high side's distance and the low
    # side's sign)
    def ramp(n, h):
        d = torch.zeros(n, dtype=torch.float64, device=dev)
        s = torch.zeros(n, dtype=torch.float64, device=dev)
        d[:npml] = torch.arange(npml, 0, -1, device=dev) * h
        d[-npml:] = torch.arange(1, npml + 1, device=dev) * h
        s[-npml:] = -1.0
        s[:npml] = 1.0
        return d, s

    dpx, sx = ramp(nx, dx)
    dpz, sz = ramp(nz, dz)
    fx = 3.0 * math.log(1.0 / PML_R) / (2 * (dx * (npml - 1)) ** 3)
    fz = 3.0 * math.log(1.0 / PML_R) / (2 * (dz * (npml - 1)) ** 3)

    def stretch(f, dp, s):
        d1 = f * c * dp ** 2
        d2 = 2 * f * c * dp
        den = d1 + iom
        r1sq = (iom / den) ** 2
        return r1sq, s * r1sq * d2 / den

    r1xsq, r2x = stretch(fx, dpx[None, :], sx[None, :])
    r1zsq, r2z = stretch(fz, dpz[:, None], sz[:, None])

    b = [(1.0 / rho + 1.0 / n) / 2 for n in _neighbours(rho)]
    bMM, bME, bMP, bEM, bEE, bEP, bPM, bPE, bPP = b
    bEE = 1.0 / rho
    K = [(omega ** 2 / n ** 2) / r for n, r in
         zip(_neighbours(c), _neighbours(rho))]
    kMM, kME, kMP, kEM, kEE, kEP, kPM, kPE, kPP = K

    s_zx = r1zsq + r1xsq
    planes = [
        E_W * kMM + B_W * bMM * (s_zx / (4 * dxz) - (r2z + r2x) / (4 * dd)),
        D_W * kME + A_W * bME * (r1zsq / dz - r2z / 2) / dz
        + B_W * (r1zsq - r1xsq) * (bMP + bMM) / (4 * dxz),
        E_W * kMP + B_W * bMP * (s_zx / (4 * dxz) - (r2z - r2x) / (4 * dd)),
        D_W * kEM + A_W * bEM * (r1xsq / dx - r2x / 2) / dx
        + B_W * (r1xsq - r1zsq) * (bPM + bMM) / (4 * dxz),
        C_W * kEE
        + A_W * (r2x * (bEM - bEP) / (2 * dx) + r2z * (bME - bPE) / (2 * dz)
                 - r1xsq * (bEM + bEP) / dxx - r1zsq * (bME + bPE) / dzz)
        + B_W * (((r2x + r2z) * (bMM - bPP) + (r2z - r2x) * (bMP - bPM))
                 / (4 * dd) - s_zx * (bMM + bPP + bPM + bMP) / (4 * dxz)),
        D_W * kEP + A_W * bEP * (r1xsq / dx + r2x / 2) / dx
        + B_W * (r1xsq - r1zsq) * (bMP + bPP) / (4 * dxz),
        E_W * kPM + B_W * bPM * (s_zx / (4 * dxz) + (r2z - r2x) / (4 * dd)),
        D_W * kPE + A_W * bPE * (r1zsq / dz + r2z / 2) / dz
        + B_W * (r1zsq - r1xsq) * (bPM + bPP) / (4 * dxz),
        E_W * kPP + B_W * bPP * (s_zx / (4 * dxz) + (r2z + r2x) / (4 * dd)),
    ]
    P = torch.stack(planes)
    # Dirichlet ring: identity rows
    ring = torch.zeros((nz, nx), dtype=torch.bool, device=dev)
    ring[0, :] = ring[-1, :] = True
    ring[:, 0] = ring[:, -1] = True
    eye = torch.zeros((9, 1, 1), dtype=P.dtype, device=dev)
    eye[4] = 1.0
    return torch.where(ring[None], eye, P)


def apply(planes, u):
    '''(A u) for planes (9, nz, nx) and u (..., nz, nx), zero outside.'''
    nz, nx = u.shape[-2:]
    p = torch.nn.functional.pad(u, (1, 1, 1, 1))
    out = torch.zeros_like(u)
    k = 0
    for dz in (-1, 0, 1):
        for dx in (-1, 0, 1):
            out = out + planes[k] * p[..., 1 + dz:1 + dz + nz,
                                      1 + dx:1 + dx + nx]
            k += 1
    return out


def transpose(planes):
    '''Planes of the transposed operator A^T (not conjugated).'''
    nz, nx = planes.shape[-2:]
    p = torch.nn.functional.pad(planes, (1, 1, 1, 1))
    out = []
    for k in range(9):
        dz, dx = k // 3 - 1, k % 3 - 1
        # A^T[p, p + s] = A[p + s, p]: plane 8 - k at p + s
        out.append(p[8 - k, 1 + dz:1 + dz + nz, 1 + dx:1 + dx + nx])
    return torch.stack(out)
