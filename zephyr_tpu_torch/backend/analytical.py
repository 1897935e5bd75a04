'''
Analytical Helmholtz responses (the test oracle): the port of
``zephyr_tpu.backend.analytical``, after the reference
(zephyr/backend/analytical.py:14-80): the 2D Green's function
-0.5j * H1^(0)(k r) scaled by ``scaleterm * rho``, the 3D Green's function
exp(ikr)/(4 pi r), and tilted-elliptical anisotropy by a coordinate
stretch 1/(1 + 2 eps) rotated by theta. Computed in torch (float64 on the
CPU) and returned as a numpy array.
'''

import numpy as np
import torch

from ..ops.special import hankel1_0


def _field(v):
    '''
    A config value as the oracle computes with it: numbers as they are,
    (nz, nx) arrays (the Eurus configs' c, rho, eps, theta) as tensors.
    '''
    return torch.as_tensor(v) if isinstance(v, np.ndarray) else v


class AnalyticalHelmholtz(object):
    '''
    The analytical Helmholtz system. Parity with the reference includes its
    quirks (x grid spacing from dz, hankel1 per the conjugate-time
    convention that matches the discrete solvers' .conjugate()).
    '''

    def __init__(self, systemConfig):

        self.omega = 2 * np.pi * systemConfig['freq']
        self.c = systemConfig['c']
        self.rho = _field(systemConfig.get('rho', 1.))
        self.k = _field(self.omega / self.c)
        self.stretch = _field(1. / (1 + (2. * systemConfig.get('eps', 0.))))
        self.theta = _field(systemConfig.get('theta', 0.))
        self.scaleterm = systemConfig.get('scaleterm', 0.5)

        xorig = systemConfig.get('xorig', 0.)
        zorig = systemConfig.get('zorig', 0.)
        dx = systemConfig.get('dx', 1.)
        dz = systemConfig.get('dz', 1.)
        nx = systemConfig['nx']
        nz = systemConfig['nz']

        Z, X = np.mgrid[0:nz, 0:nx].astype(np.float64)
        self._z = torch.as_tensor(zorig + dz * Z)
        self._x = torch.as_tensor(xorig + dx * X)

        if systemConfig.get('3D', False):
            self.Green = self.Green3D
        else:
            self.Green = self.Green2D

    def Green2D(self, r):
        'The 2D Green\'s function (hankel1 per the reference FT convention)'

        return self.scaleterm * self.rho * (-0.5j * hankel1_0(self.k * r))

    def Green3D(self, r):
        'The 3D Green\'s function'

        rsafe = torch.where(r > 0, r, torch.ones_like(r))
        out = self.scaleterm * self.rho * (1. / (4 * np.pi * rsafe)) \
            * torch.exp(1j * self.k * rsafe)
        return torch.where(r > 0, out, torch.zeros_like(out))

    def __call__(self, q):
        'Model the Green\'s function given a source location array (1, 2)'

        q = np.asarray(q)
        x = float(q[0, 0])
        z = float(q[0, -1])

        dx = self._x - x
        dz = self._z - z
        dist = torch.sqrt(dx ** 2 + dz ** 2)
        strangle = torch.arctan(dz / dx) + self.theta
        stretch = torch.sqrt(self.stretch * torch.cos(strangle) ** 2
                             + torch.sin(strangle) ** 2)

        # NaN at the source point (0/0 in strangle) propagates through the
        # Green's function and is zeroed at the end, as in the reference.
        out = self.Green(dist * stretch)
        out = torch.complex(torch.nan_to_num(out.real),
                            torch.nan_to_num(out.imag))
        return out.numpy().ravel()

    def __mul__(self, q):
        'Pretend to be a matrix'

        return self(q)
