'''
Low-level model-dependent base classes for zephyr_tpu_torch.

A copy of ``zephyr_tpu.backend.base`` (numpy only), mirroring the public
surface of the reference's zephyr/backend/base.py:11-149 (grid geometry,
free-surface flags, linear/vector index maps, and Thomsen-parameter
fields).
'''

import numpy as np

from ..core.attrmap import AttributeMapper


class BaseModelDependent(AttributeMapper):
    '''
    AttributeMapper subclass that implements model-dependent properties
    such as grid coordinates and free-surface conditions.
    Parity: reference zephyr/backend/base.py:11-109.
    '''

    initMap = {
    #   Argument        Required    Rename as ...   Store as type
        'nx':           (True,      None,           np.int64),
        'ny':           (False,     None,           np.int64),
        'nz':           (True,      None,           np.int64),
        'xorig':        (False,     '_xorig',       np.float64),
        'yorig':        (False,     '_yorig',       np.float64),
        'zorig':        (False,     '_zorig',       np.float64),
        'dx':           (False,     '_dx',          np.float64),
        'dy':           (False,     '_dy',          np.float64),
        'dz':           (False,     '_dz',          np.float64),
        'freeSurf':     (False,     '_freeSurf',    tuple),
    }

    @property
    def xorig(self):
        return getattr(self, '_xorig', 0.)

    @property
    def yorig(self):
        if hasattr(self, 'ny'):
            return getattr(self, '_yorig', 0.)
        raise AttributeError('%s object is not 3D' % (type(self).__name__,))

    @property
    def zorig(self):
        return getattr(self, '_zorig', 0.)

    @property
    def dx(self):
        return getattr(self, '_dx', 1.)

    @property
    def dy(self):
        if hasattr(self, 'ny'):
            return getattr(self, '_dy', self.dx)
        raise AttributeError('%s object is not 3D' % (type(self).__name__,))

    @property
    def dz(self):
        return getattr(self, '_dz', self.dx)

    @property
    def freeSurf(self):
        if getattr(self, '_freeSurf', None) is None:
            self._freeSurf = (False, False, False, False)
        return self._freeSurf

    @property
    def modelDims(self):
        if hasattr(self, 'ny'):
            return (self.nz, self.ny, self.nx)
        return (self.nz, self.nx)

    @property
    def nrow(self):
        return int(np.prod(self.modelDims))

    def toLinearIndex(self, vec):
        '''
        Linear indices in the raveled model coordinates for an <n by 2>
        array of (z, x) grid coordinates (or <n by 3> for 3D).
        '''

        vec = np.asarray(vec)
        if hasattr(self, 'ny'):
            return (vec[:, 0] * self.nx * self.ny + vec[:, 1] * self.nx
                    + vec[:, 2])
        return vec[:, 0] * self.nx + vec[:, 1]

    def toVecIndex(self, lind):
        'Vectorized (grid) index for each linear index.'

        lind = np.asarray(lind)
        if hasattr(self, 'ny'):
            return np.array([lind // (self.nx * self.ny),
                             np.mod(lind, self.nx),
                             np.mod(lind, self.ny * self.nx)]).T
        return np.array([lind // self.nx, np.mod(lind, self.nx)]).T


class BaseAnisotropic(BaseModelDependent):
    '''
    Mixin providing Thomsen-parameter fields theta (tilt), eps, delta;
    scalars are broadcast over the grid, defaults are zero.
    Parity: reference zephyr/backend/base.py:112-149.
    '''

    initMap = {
    #   Argument        Required    Rename as ...   Store as type
        'theta':        (False,     '_theta',       np.float64),
        'eps':          (False,     '_eps',         np.float64),
        'delta':        (False,     '_delta',       np.float64),
    }

    def _anisoField(self, name):
        value = getattr(self, name, None)
        if value is None:
            value = np.zeros((self.nz, self.nx))
            setattr(self, name, value)
        if isinstance(value, np.ndarray) and value.ndim >= 2:
            return value
        return np.asarray(value, dtype=np.float64) \
            * np.ones((self.nz, self.nx), dtype=np.float64)

    @property
    def theta(self):
        return self._anisoField('_theta')

    @property
    def eps(self):
        return self._anisoField('_eps')

    @property
    def delta(self):
        return self._anisoField('_delta')
