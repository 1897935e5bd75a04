'''
A copy of ``zephyr_tpu.middleware.maps`` (host only: numpy and scipy), kept
in the port so that it never imports the JAX package.

Model parametrization maps.

Reference parity: zephyr/middleware/maps.py — NodalIdentityMap (node to
cell-centre averaging) and SquaredSlownessMap (1/c^2 parametrization).
The reference's SquaredSlownessMap has a latent bug (uses np without
importing it, maps.py:52); the semantics here are the intended ones.
'''

import numpy as np

EPS = 1e-10


class IdentityMap(object):
    'Base map: identity transform on a mesh (SimPEG Maps.IdentityMap).'

    def __init__(self, mesh=None):
        self.mesh = mesh

    @property
    def nP(self):
        if self.mesh is None:
            return '*'
        return self.mesh.nN

    @property
    def shape(self):
        return (self.nP, self.nP)

    def _transform(self, m):
        return m

    def inverse(self, D):
        return D

    def deriv(self, m):
        import scipy.sparse as sp
        return sp.identity(self.mesh.nN if self.mesh is not None
                           else len(m))

    def __mul__(self, m):
        return self._transform(m)

    def __call__(self, m):
        return self._transform(m)


class NodalIdentityMap(IdentityMap):
    'Node -> cell-centre averaging map (parity: maps.py:9-35).'

    @property
    def nP(self):
        if self.mesh is None:
            return '*'
        return self.mesh.nC

    @property
    def shape(self):
        if self.mesh is None:
            return ('*', '*')
        return (self.mesh.nC, self.mesh.nN)

    def _transform(self, m):
        return self.mesh.aveN2CC * m

    def inverse(self, D):
        return self.mesh.aveN2CC.T * D

    def deriv(self, m):
        return self.mesh.aveN2CC


class SquaredSlownessMap(NodalIdentityMap):
    'Model in squared-slowness 1/c^2 (parity: maps.py:37-60).'

    eps = EPS

    def _transform(self, m):
        m = NodalIdentityMap._transform(self, m)
        return 1. / (m ** 2 + EPS)

    def inverse(self, D):
        D = 1. / (np.sqrt(D) + EPS)
        return NodalIdentityMap.inverse(self, D)

    def deriv(self, m):
        import scipy.sparse as sp
        mc = NodalIdentityMap._transform(self, m)
        dd = -2. * mc / (mc ** 2 + EPS) ** 2
        return sp.diags(dd) * NodalIdentityMap.deriv(self, m)
