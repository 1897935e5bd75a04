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

The ``device`` config key places the planes, the prepared operator and
the solve; it defaults to 'cuda' and raises without a card (pass
'device': 'cpu' for the CPU). ``dtype`` (default complex64 on CUDA,
complex128 on the CPU) sets their precision.
'''

import contextlib

import numpy as np
import scipy.sparse as sp
import torch

from ..solver.helmholtz import (prepare_operator, resolve_panels,
                                resolve_solver_config, solve_batched)
from ..core.attrmap import BaseSCCache
from ..core.device import DEFAULT_DEVICE, resolve_device, resolve_dtype
from .base import BaseModelDependent


def default_complex_dtype(device=DEFAULT_DEVICE):
    '''
    The complex dtype a solve on ``device`` takes when none is
    configured: complex64 on CUDA, complex128 on the CPU
    (``core.device.resolve_dtype``).
    '''
    return resolve_dtype(None, device)


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
        'The torch device of the operator and the solve (default cuda).'
        return resolve_device(getattr(self, '_device', DEFAULT_DEVICE))

    @property
    def dtype(self):
        'complex128 on the CPU and complex64 on CUDA unless configured.'
        dt = getattr(self, '_dtype', None)
        return resolve_dtype(dt, self.device if dt is None else None)

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

    def _dispatch_rhs(self, rhs):
        '''
        Solve for rhs (n, nrhs) complex with the premul applied: returns
        the solution as a tensor on this instance's device,
        (nrhs, nblock, nz, nx), and nrhs. The parallel distributor runs
        this for sibling subproblems on their own cards.
        '''

        nrhs = rhs.shape[1]
        b = np.asarray(self.premul * rhs)
        b = b.T.reshape((nrhs, self.nblock, self.nz, self.nx))
        dev = self.device
        with (torch.cuda.device(dev) if dev.type == 'cuda'
              else contextlib.nullcontext()):
            bt = torch.as_tensor(np.ascontiguousarray(b),
                                 device=dev).to(self.dtype)
            return solve_batched(self.Ainv, bt, self.solverConfig), nrhs

    def _gather_rhs(self, x, nrhs):
        'A dispatched solution on the host as (n, nrhs), FT-conjugated.'

        x = x.cpu().numpy().astype(np.complex128)
        x = x.reshape((nrhs, self.nblock * self.nrow)).T
        return x.conjugate()

    def _solve_rhs(self, rhs):
        '''
        Core solve: rhs (n, nrhs) complex -> wavefields (n, nrhs) with the
        reference's premul and conjugation applied.
        '''

        return self._gather_rhs(*self._dispatch_rhs(rhs))

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


class DiscretizationWrapper(BaseSCCache):
    '''
    Base class for objects that wrap around discretizations in order to
    model composite systems (multi-frequency, multi-grid), the port of
    ``zephyr_tpu.backend.discretization.DiscretizationWrapper``:
    subproblem configs are the stored systemConfig with the wrapper's
    ``maskKeys`` removed, overlaid with each ``spUpdates`` dict (reference
    discretization.py:109-169).
    '''

    initMap = {
    #   Argument        Required    Rename as ...   Store as type
        'Disc':         (True,      None,           None),
        'scaleTerm':    (False,     '_scaleTerm',   np.complex128),
    }

    maskKeys = {'scaleTerm'}

    cacheItems = ['_subProblems']

    @property
    def scaleTerm(self):
        'A scaling term to apply to the output wavefield.'
        return getattr(self, '_scaleTerm', 1.)

    @property
    def spUpdates(self):
        raise NotImplementedError

    @property
    def _spConfigs(self):
        '''
        Subproblem configs: the stored systemConfig with this wrapper's
        aggregated maskKeys removed (so a nested wrapper's children do not
        re-receive its own keys), overlaid with each spUpdate.
        '''

        base = self.maskedConfig

        def overlay(spu):
            config = dict(base)
            config.update(spu)
            return config

        return (overlay(spu) for spu in self.spUpdates)

    @property
    def subProblems(self):
        'Instantiated subproblem discretizations (cached).'

        if getattr(self, '_subProblems', None) is None:
            self._subProblems = [self.Disc(config)
                                 for config in self._spConfigs]
        return self._subProblems

    @property
    def factors(self):
        return getattr(self, '_subProblems', None) is not None and \
            any(s.factors for s in self._subProblems)

    @factors.deleter
    def factors(self):
        if getattr(self, '_subProblems', None) is not None:
            for s in self._subProblems:
                del s.factors

    def __mul__(self, rhs):
        raise NotImplementedError
