'''
A copy of ``zephyr_tpu.middleware.regularization`` (host only: numpy and scipy), kept
in the port so that it never imports the JAX package.

Regularization functionals for the inversion layer.

Reference parity: zephyr/middleware/regularization.py (identity-weighted
Tikhonov); extended with the smallness/smoothness split the reference
defers to SimPEG for.
'''

import numpy as np
import scipy.sparse as sp


class BaseRegularization(object):
    '''
    0.5 || W (m - mref) ||^2 with identity W by default.
    '''

    def __init__(self, mesh=None, mref=None, alpha=1.0):
        self.mesh = mesh
        self.mref = mref
        self.alpha = alpha

    @property
    def W(self):
        'Full regularization weighting matrix.'
        n = self.mesh.nN if self.mesh is not None else None
        return sp.identity(n, dtype=np.complex128)

    def _dm(self, m):
        if self.mref is None:
            return m
        return m - self.mref

    def eval(self, m):
        dm = self._dm(m)
        r = self.W * dm
        return 0.5 * self.alpha * float(np.real(np.vdot(r, r)))

    def evalDeriv(self, m):
        dm = self._dm(m)
        return self.alpha * np.real(self.W.conj().T * (self.W * dm))

    __call__ = eval


class HelmBaseRegularization(BaseRegularization):
    'Identity-weighted regularization (parity: regularization.py:11-18).'


class SmoothRegularization(BaseRegularization):
    '''
    First-difference (gradient) smoothing regularization on the (nz, nx)
    grid — the TPU-era default for FWI model smoothing.
    '''

    def __init__(self, nz, nx, mref=None, alpha=1.0):
        super().__init__(None, mref, alpha)
        self.nz, self.nx = nz, nx

    def eval(self, m):
        dm = np.real(self._dm(m)).reshape(self.nz, self.nx)
        gz = np.diff(dm, axis=0)
        gx = np.diff(dm, axis=1)
        return 0.5 * self.alpha * float((gz ** 2).sum() + (gx ** 2).sum())

    def evalDeriv(self, m):
        dm = np.real(self._dm(m)).reshape(self.nz, self.nx)
        g = np.zeros_like(dm)
        gz = np.diff(dm, axis=0)
        gx = np.diff(dm, axis=1)
        g[:-1, :] -= gz
        g[1:, :] += gz
        g[:, :-1] -= gx
        g[:, 1:] += gx
        return self.alpha * g.ravel()
