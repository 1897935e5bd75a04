'''
MiniZephyr: 2D / 2.5D (visco)acoustic frequency-domain wave modelling,
the port of ``zephyr_tpu.backend.minizephyr`` (MiniZephyr, MiniZephyrHD,
MiniZephyr25D). The 9-point mixed-grid stencil comes from
``zephyr_tpu_torch.ops.minizephyr_coeff``; the solve is the fused hybrid
multigrid-Krylov of ``zephyr_tpu_torch.solver.helmholtz``. The 2.5D
wrapper performs the reference's Fourier summation over cross-line
wavenumbers (minizephyr.py:346-461), one ky subproblem after the other.
'''

import numpy as np
import scipy.sparse as sp

from ..ops.minizephyr_coeff import minizephyr_planes
from ..solver.helmholtz import shifted_velocity
from .discretization import BaseDiscretization, DiscretizationWrapper


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


class MiniZephyr25D(BaseDiscretization, DiscretizationWrapper):
    '''
    2.5D modelling by Fourier summation over cross-line wavenumbers
    (parity: reference minizephyr.py:346-461).

    The reference's host-driven contract: ``__mul__`` loops the ky
    subproblems (instances of ``Disc``, MiniZephyr by default) serially,
    each with its own cached factor lifecycle (BaseSCCache semantics),
    and sums the weighted wavefields. Each subproblem runs on the
    ``device`` config key's device (the card unless 'cpu' is asked for).
    ``parallel.multifreq.multifreq_dpred_25d`` and the 2.5D problems
    (middleware/problem.py) run the same sum holding one prepared operator
    at a time.
    '''

    initMap = {
    #   Argument        Required    Rename as ...   Store as type
        'Disc':         (False,     '_Disc',        None),
        'nky':          (True,      '_nky',         np.int64),
        'parallel':     (False,     '_parallel',    bool),
        'cmin':         (False,     '_cmin',        np.float64),
    }

    maskKeys = {'nky', 'Disc', 'parallel'}

    @property
    def Disc(self):
        'The discretization applied to each wavenumber subproblem'
        if getattr(self, '_Disc', None) is None:
            self._Disc = MiniZephyr
        return self._Disc

    @property
    def nky(self):
        'Number of cross-line wavenumber components'
        if getattr(self, '_nky', None) is None:
            self._nky = 1
        return int(self._nky)

    @property
    def cmin(self):
        'Minimum velocity (or configured representative value)'
        if getattr(self, '_cmin', None) is None:
            return np.min(self.c.real)
        return float(self._cmin)

    @property
    def pkys(self):
        '''
        The modelled wavenumbers: regular sampling corresponding to an
        inverse DFT (minizephyr.py:380-394).
        '''

        indices = np.arange(self.nky)
        if self.nky > 1:
            dky = float(np.real(np.complex128(self.freq))) \
                / (self.cmin * (self.nky - 1))
        else:
            dky = 0.
        return indices * dky

    @property
    def kyweights(self):
        'Inverse-DFT weights: 1 for ky = 0, else 2 (minizephyr.py:396-405).'
        indices = np.arange(self.nky)
        return 1. + (indices > 0)

    @property
    def spUpdates(self):
        'Per-ky subProblem config updates (minizephyr.py:417-421).'

        weightfac = 1. / (2 * self.nky - 1) if self.nky > 1 else 1.
        return [{'ky': ky, 'premul': weightfac * (1. + (ky > 0))}
                for ky in self.pkys]

    @property
    def scaleTerm(self):
        'Output scaling exp(i pi) / 4 pi (minizephyr.py:429-433).'
        return getattr(self, '_scaleTerm', 1.) * np.exp(1j * np.pi) \
            / (4 * np.pi)

    @property
    def factors(self):
        return DiscretizationWrapper.factors.fget(self)

    @factors.deleter
    def factors(self):
        DiscretizationWrapper.factors.fdel(self)

    def __mul__(self, rhs):
        '''
        Fan out the right-hand side(s) over the ky subproblems and return
        the weighted Fourier sum of wavefields.
        '''

        if sp.issparse(rhs):
            rhs = rhs.toarray()
        rhs = np.asarray(rhs)
        single = rhs.ndim < 2
        if single:
            rhs = rhs.reshape((rhs.size, 1))

        u = None
        for subProblem in self.subProblems:
            usub = subProblem * rhs
            u = usub if u is None else u + usub

        u = self.scaleTerm * u
        return u.ravel() if single else u
