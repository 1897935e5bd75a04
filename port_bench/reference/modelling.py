'''
Receiver data of forward modelling: d = R conj(x), x = A^{-1} q, for the
shots of one frequency on one grid, by the direct solve.
'''

import numpy as np
import torch

from . import blocksolve, planes, stamps


def receiver_data(c, freq, src_pos, rec_pos, dx=1.0, dz=1.0, ireg=4,
                  device='cpu', quantize=None, dtype=torch.complex128):
    '''
    (nsrc, nrec) complex128 numpy data of the shots at ``src_pos`` on the
    velocity ``c`` (nz, nx), all shots in one solve. Returns (data, worst
    true relative residual of the solutions in the float64 operator).
    '''

    c = torch.as_tensor(np.asarray(c, np.float64), device=device)
    shape = tuple(c.shape)
    P = planes.helmholtz_planes(c, freq, dx, dz)
    sidx, sval = stamps.stamps(shape, dx, dz, src_pos, ireg)
    ridx, rval = stamps.stamps(shape, dx, dz, rec_pos, ireg, receiver=True)
    ridx = torch.as_tensor(ridx, device=device)
    rval = torch.as_tensor(rval, device=device)
    sidx = torch.as_tensor(sidx, device=device)
    sval = torch.as_tensor(sval, device=device)
    b = torch.zeros((len(sidx), shape[0] * shape[1]),
                    dtype=torch.complex128, device=device)
    b.scatter_add_(1, sidx, sval)
    b = b.reshape((len(sidx),) + shape)
    x = blocksolve.solve(P, b, quantize, dtype).to(torch.complex128)
    r = planes.apply(P, x) - b
    rel = (torch.linalg.vector_norm(r, dim=(-2, -1))
           / torch.linalg.vector_norm(b, dim=(-2, -1)))
    u = torch.conj(x).reshape(len(b), -1)
    return (u[:, ridx] * rval).sum(-1).cpu().numpy(), float(rel.max())
