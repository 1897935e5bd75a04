'''
Discretization base class for zephyr_tpu_torch: the port of
``zephyr_tpu.backend.discretization.BaseDiscretization``.

The reference's calling convention is kept: a discretization instance IS
the inverse operator, ``u = Ainv * q`` returns wavefields, and
``__mul__`` applies ``(A^{-1} (premul * rhs)).conjugate()`` (the FT
convention of the reference's discretization.py:101-103). ``A`` is the
matrix-free coefficient-plane tensor and ``Ainv`` the prepared operator
(planes, multigrid hierarchy, stratified solve), cached per instance and
droppable via ``del obj.factors``.

Nothing picks the device by itself: the ``device`` config key (default
'cpu') places the planes, the prepared operator and the solve, and
``dtype`` (default complex128 on the CPU, complex64 on CUDA) sets their
precision.
'''

import numpy as np
import scipy.sparse as sp
import torch

from ..solver.helmholtz import (prepare_operator, resolve_panels,
                                resolve_solver_config, solve_batched)
from .base import BaseModelDependent

_DTYPES = {'complex64': torch.complex64, 'complex128': torch.complex128}


class BaseDiscretization(BaseModelDependent):
    '''
    Base class for all discretizations. Subclasses provide
    ``_planesFromFields(c, rho)`` (the true operator planes,
    (B, B, 9, nz, nx)) and ``_precondPlanesFromFields(c, rho)`` (the
    complex-shifted preconditioner planes), both on tensors.
    '''

    initMap = {
    #   Argument        Required    Rename as ...   Store as type
        'c':            (True,      '_c',           np.complex128),
        'rho':          (False,     '_rho',         np.float64),
        'freq':         (True,      None,           np.complex128),
        'tau':          (False,     '_tau',         np.float64),
        'premul':       (False,     '_premul',      np.complex128),
        'solverOpts':   (False,     '_solverOpts',  dict),
        'device':       (False,     '_device',      None),
        'dtype':        (False,     '_dtype',       None),
    }

    @property
    def device(self):
        'The torch device of the operator and the solve (default cpu).'
        return torch.device(getattr(self, '_device', 'cpu'))

    @property
    def dtype(self):
        'complex128 on the CPU and complex64 on CUDA unless configured.'
        dt = getattr(self, '_dtype', None)
        if dt is None:
            return (torch.complex64 if self.device.type == 'cuda'
                    else torch.complex128)
        if isinstance(dt, str):
            dt = _DTYPES[dt]
        if dt not in (torch.complex64, torch.complex128):
            raise ValueError('dtype must be complex64 or complex128')
        return dt

    @property
    def tau(self):
        'Laplace-domain damping time constant'
        return getattr(self, '_tau', np.inf)

    @property
    def dampCoeff(self):
        'Computed damping coefficient to be added to real omega'
        return 1j / self.tau

    @property
    def premul(self):
        'A premultiplication factor, used by 2.5D and half differentiation'
        return getattr(self, '_premul', 1.)

    @property
    def c(self):
        'Complex wave velocity'
        if isinstance(self._c, np.ndarray) and self._c.size > 1:
            return self._c.reshape((self.nz, self.nx))
        return np.complex128(self._c) * np.ones((self.nz, self.nx),
                                                dtype=np.complex128)

    @property
    def rho(self):
        'Bulk density; defaults to Gardner\'s relation 310 c^0.25'
        if hasattr(self, '_rho'):
            rho = self._rho
            if isinstance(rho, np.ndarray) and rho.size > 1:
                return rho.reshape((self.nz, self.nx))
            return np.float64(rho) * np.ones((self.nz, self.nx),
                                             dtype=np.float64)
        self._rho = 310. * self.c.real ** 0.25
        return self._rho

    @property
    def solverConfig(self):
        '''
        The iterative-solver configuration (``solverOpts`` config key) with
        the precision-aware default tolerance and the x-panel default
        (strat_panels=0) resolved from this problem's model.
        '''
        cfg = resolve_solver_config(getattr(self, '_solverOpts', {}),
                                    self.dtype)
        if self.nblock == 1:
            cfg = resolve_panels(cfg, self.c)
        return cfg

    @property
    def nblock(self):
        'Number of wavefield blocks (1 scalar).'
        return 1

    @property
    def shape(self):
        n = self.nblock * self.nrow
        return (n, n)

    def _fields(self):
        'The model (c, rho) as tensors of this instance\'s device/dtype.'
        c = torch.as_tensor(np.asarray(self.c, dtype=np.complex128),
                            device=self.device).to(self.dtype)
        rho = torch.as_tensor(np.asarray(self.rho, dtype=np.float64),
                              device=self.device).to(c.real.dtype)
        return c, rho

    @property
    def A(self):
        'The matrix-free operator: (B, B, 9, nz, nx) coefficient planes.'
        if getattr(self, '_A', None) is None:
            self._A = self._planesFromFields(*self._fields())
        return self._A

    @property
    def Ainv(self):
        'The prepared solver (planes + hierarchy + stratified solve).'
        if not hasattr(self, '_Ainv'):
            c, rho = self._fields()
            self._Ainv = prepare_operator(
                self._planesFromFields(c, rho),
                self._precondPlanesFromFields(c, rho), self.solverConfig,
                with_transpose=False)
        return self._Ainv

    @Ainv.deleter
    def Ainv(self):
        if hasattr(self, '_Ainv'):
            del self._Ainv

    def _planesFromFields(self, c, rho):
        'True-operator planes as a function of (c, rho) tensors.'
        raise NotImplementedError

    def _precondPlanesFromFields(self, c, rho):
        'Shifted-preconditioner planes as a function of (c, rho) tensors.'
        raise NotImplementedError

    @property
    def factors(self):
        return hasattr(self, '_Ainv')

    @factors.deleter
    def factors(self):
        del self.Ainv

    def _solve_rhs(self, rhs):
        '''
        Core solve: rhs (n, nrhs) complex -> wavefields (n, nrhs) with the
        reference's premul and conjugation applied.
        '''

        nrhs = rhs.shape[1]
        b = np.asarray(self.premul * rhs)
        b = b.T.reshape((nrhs, self.nblock, self.nz, self.nx))
        bt = torch.as_tensor(np.ascontiguousarray(b),
                             device=self.device).to(self.dtype)
        x = solve_batched(self.Ainv, bt, self.solverConfig)
        x = x.cpu().numpy().astype(np.complex128)
        x = x.reshape((nrhs, self.nblock * self.nrow)).T
        return x.conjugate()

    def __mul__(self, rhs):
        'Action of multiplying the inverted system by a right-hand side.'

        if sp.issparse(rhs):
            rhs = rhs.toarray()
        rhs = np.asarray(rhs)
        single = rhs.ndim < 2
        if single:
            rhs = rhs.reshape((rhs.size, 1))
        u = self._solve_rhs(rhs.astype(np.complex128))
        return u.ravel() if single else u

    def __call__(self, value):
        return self * value
