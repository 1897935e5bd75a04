'''
Eurus: TTI anisotropic 2D (visco)acoustic frequency-domain modelling, the
port of ``zephyr_tpu.backend.eurus`` (Eurus, EurusHD).

Reference parity: zephyr/backend/eurus.py:14-552 (Operto et al. 2009
mixed-grid stencil; coupled 2N-state system [[M1, M2], [M3, M4]]; RHS
auto-padding of half-size sources with zeros and clipping of the result,
eurus.py:512-533). The coefficient planes come from
``zephyr_tpu_torch.ops.eurus_coeff``; the solve is the block multigrid-
GMRES of ``zephyr_tpu_torch.solver.helmholtz``, on the card unless the
``device`` config key says 'cpu'.
'''

import numpy as np
import scipy.sparse as sp

from ..ops.eurus_coeff import eurus_planes
from ..solver.helmholtz import shifted_velocity
from .base import BaseAnisotropic
from .discretization import BaseDiscretization


class Eurus(BaseDiscretization, BaseAnisotropic):
    '''
    TTI anisotropic discretization (parity: eurus.py:14-533).
    '''

    initMap = {
    #   Argument        Required    Rename as ...   Store as type
        'nPML':         (False,     '_nPML',        np.int64),
        'freq':         (True,      None,           np.complex128),
        'mord':         (False,     '_mord',        tuple),
        'cPML':         (False,     '_cPML',        np.float64),
    }

    @property
    def mord(self):
        'Matrix ordering (parity; layout is always (z, x) with the flip).'
        return getattr(self, '_mord', (-self.nx, +1))

    @property
    def cPML(self):
        'The convolutional PML coefficient (eurus.py:500-504).'
        return float(getattr(self, '_cPML', 1e3))

    @property
    def nPML(self):
        'The depth of the PML region in gridpoints'
        return int(getattr(self, '_nPML', 10))

    @property
    def nblock(self):
        return 2

    def _planeKwargs(self):
        return dict(freq=complex(np.complex128(self.freq)), tau=self.tau,
                    theta=self.theta, eps=self.eps, delta=self.delta,
                    dx=self.dx, dz=self.dz, nPML=self.nPML, cPML=self.cPML,
                    freeSurf=tuple(bool(f) for f in self.freeSurf))

    def _planesFromFields(self, c, rho):
        return eurus_planes(c, rho, **self._planeKwargs())

    def _precondPlanesFromFields(self, c, rho):
        cfg = self.solverConfig
        return eurus_planes(shifted_velocity(c, cfg.shift), rho,
                            pml_cap=cfg.pml_cap, **self._planeKwargs())

    def __mul__(self, rhs):
        '''
        Action of the inverse of the 2N-state system. Half-size RHS are
        padded with zeros and the result clipped back (eurus.py:512-533).
        '''

        if sp.issparse(rhs):
            rhs = rhs.toarray()
        rhs = np.asarray(rhs)
        single = rhs.ndim < 2
        if single:
            rhs = rhs.reshape((rhs.size, 1))

        clipResult = False
        if 2 * rhs.shape[0] == self.shape[1]:
            rhs = np.vstack([rhs, np.zeros(rhs.shape, dtype=np.complex128)])
            clipResult = True
        elif rhs.shape[0] != self.shape[1]:
            raise ValueError('dimension mismatch')

        result = self._solve_rhs(rhs.astype(np.complex128))

        if clipResult:
            result = result[:self.shape[1] // 2, :]
        return result.ravel() if single else result


class EurusHD(Eurus):
    '''
    Eurus with half-differentiation of the source by default
    (parity: eurus.py:536-552).
    '''

    @property
    def premul(self):
        cfact = np.sqrt(2j * np.pi * np.complex128(self.freq))
        return getattr(self, '_premul', cfact)
