'''
MiniZephyr: 2D (visco)acoustic frequency-domain wave modelling, the port
of ``zephyr_tpu.backend.minizephyr`` (MiniZephyr, MiniZephyrHD). The
9-point mixed-grid stencil comes from
``zephyr_tpu_torch.ops.minizephyr_coeff``; the solve is the fused hybrid
multigrid-Krylov of ``zephyr_tpu_torch.solver.helmholtz``.
'''

import numpy as np

from ..ops.minizephyr_coeff import minizephyr_planes
from ..solver.helmholtz import shifted_velocity
from .discretization import BaseDiscretization


class MiniZephyr(BaseDiscretization):
    '''
    2D (visco)acoustic frequency-domain discretization with accommodations
    for 2.5D modelling (parity: reference minizephyr.py:27-324).
    '''

    initMap = {
    #   Argument        Required    Rename as ...   Store as type
        'nPML':         (False,     '_nPML',        np.int64),
        'ky':           (False,     '_ky',          np.float64),
        'mord':         (False,     '_mord',        tuple),
    }

    @property
    def mord(self):
        'Matrix ordering (kept for API parity; layout is always (z, x)).'
        return getattr(self, '_mord', (self.nx, +1))

    @property
    def nPML(self):
        'The depth of the PML region in gridpoints'
        return int(getattr(self, '_nPML', 10))

    @property
    def ky(self):
        'The cross-line wavenumber for 2.5D operation'
        return float(getattr(self, '_ky', 0.))

    def _planeKwargs(self):
        return dict(freq=complex(np.complex128(self.freq)), tau=self.tau,
                    ky=self.ky, dx=self.dx, dz=self.dz, nPML=self.nPML,
                    freeSurf=tuple(bool(f) for f in self.freeSurf))

    def _planesFromFields(self, c, rho):
        return minizephyr_planes(c, rho, **self._planeKwargs())[None, None]

    def _precondPlanesFromFields(self, c, rho):
        cfg = self.solverConfig
        return minizephyr_planes(shifted_velocity(c, cfg.shift), rho,
                                 pml_cap=cfg.pml_cap,
                                 **self._planeKwargs())[None, None]


class MiniZephyrHD(MiniZephyr):
    '''
    MiniZephyr with half-differentiation of the source by default,
    correcting for 3D spreading (parity: reference minizephyr.py:327-343).
    '''

    @property
    def premul(self):
        cfact = np.sqrt(2j * np.pi * np.complex128(self.freq))
        return getattr(self, '_premul', cfact)
