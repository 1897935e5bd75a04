'''
Regular-grid interpolation for zephyr_tpu_torch: the port of
``zephyr_tpu.backend.interpolation``.

Reference parity: zephyr/backend/interpolation.py (BaseGridInterpolator /
SplineGridInterpolator): regular-grid to regular-grid resampling with a
scale factor, an energy-conserving option (multiplication by scale^2), a
self-transpose ``T`` building the inverse-scale interpolator, and a
``scaleUpdate`` dict that patches systemConfigs onto the scaled grid.

- ``SplineGridInterpolator``: bivariate spline (scipy, host-side), a copy
  of the JAX package's class.
- ``resample_field``: the counterpart of the JAX package's
  ``jax.image.resize(..., 'cubic')`` resampler on tensors: the same
  weights, applied as two small dense matrices, so autograd flows
  through it.
'''

import numpy as np
import torch

from ..core.attrmap import BaseSCCache
from .base import BaseModelDependent


def _keys_cubic(x):
    'The Keys cubic kernel (a = -0.5) at |x|, as jax.image uses it.'
    out = ((1.5 * x - 2.5) * x) * x + 1.
    out = np.where(x >= 1., ((-0.5 * x + 2.5) * x - 4.) * x + 2., out)
    return np.where(x >= 2., 0., out)


def resize_weights(n_in, n_out):
    '''
    The (n_out, n_in) float64 matrix of ``jax.image.resize(..., 'cubic')``
    along one axis (antialias on, no translation): half-pixel centres,
    the kernel widened by the inverse scale when downsampling (the
    antialiasing low-pass), each output's weights renormalised to sum to
    one (which handles the edges), and zero for samples outside the
    input range.
    '''

    scale = n_out / n_in
    inv_scale = 1. / scale
    kernel_scale = max(inv_scale, 1.)
    sample_f = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(n_in)[:, None]) / kernel_scale
    w = _keys_cubic(x)
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000. * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).T


def resample_field(field, new_shape, method='cubic'):
    '''
    Resample a (nz, nx) field (real or complex tensor) to ``new_shape``
    with the weights of ``jax.image.resize(field, new_shape, 'cubic')``,
    applied as ``Wz @ field @ Wx^T`` (an axis whose size is unchanged is
    left alone, as jax.image does), so gradients flow through it.
    '''

    if method != 'cubic':
        raise NotImplementedError('resample_field: only cubic is ported')
    nz, nx = field.shape[-2:]
    mz, mx = new_shape
    out = field
    rdtype = field.real.dtype if field.is_complex() else field.dtype
    if mz != nz:
        Wz = torch.as_tensor(resize_weights(nz, mz), dtype=rdtype,
                             device=field.device).to(field.dtype)
        out = Wz @ out
    if mx != nx:
        Wx = torch.as_tensor(resize_weights(nx, mx), dtype=rdtype,
                             device=field.device).to(field.dtype)
        out = out @ Wx.T
    return out


class BaseGridInterpolator(BaseModelDependent, BaseSCCache):
    '''
    Base class for interpolation between two regular grids
    (parity: interpolation.py:14-169).
    '''

    initMap = {
    #   Argument        Required    Rename as ...   Store as type
        'scale':        (True,      None,           np.float64),
        'eCons':        (False,     '_eCons',       bool),
    }

    @property
    def eCons(self):
        return getattr(self, '_eCons', False)

    @property
    def snx(self):
        return int(np.round(self.nx / self.scale))

    @property
    def snz(self):
        return int(np.round(self.nz / self.scale))

    @property
    def sdx(self):
        return self.dx * self.scale

    @property
    def sdz(self):
        return self.dz * self.scale

    @property
    def Z(self):
        return np.linspace(self.zorig, self.zorig + self.dz * (self.nz - 1),
                           self.nz)

    @property
    def X(self):
        return np.linspace(self.xorig, self.xorig + self.dx * (self.nx - 1),
                           self.nx)

    @property
    def sZ(self):
        return np.linspace(self.zorig,
                           self.zorig + self.sdz * (self.snz - 1), self.snz)

    @property
    def sX(self):
        return np.linspace(self.xorig,
                           self.xorig + self.sdx * (self.snx - 1), self.snx)

    @property
    def compression(self):
        return self.scale ** 2

    @property
    def shape(self):
        return (self.snx * self.snz, self.nx * self.nz)

    @property
    def T(self):
        'The transposed (inverse-scale) interpolator.'
        if not hasattr(self, '_T'):
            configT = dict(self.systemConfig)
            configT.update({
                'scale': 1. / self.scale,
                'nx': self.snx,
                'nz': self.snz,
                'dx': self.sdx,
                'dz': self.sdz,
            })
            self._T = self.__class__(configT)
        return self._T

    @property
    def scaleUpdate(self):
        'Config patch that moves a systemConfig onto the scaled grid.'
        return {
            'nx': self.snx,
            'nz': self.snz,
            'dx': self.sdx,
            'dz': self.sdz,
        }

    def __mul__(self, value):
        raise NotImplementedError

    def __call__(self, value):
        return self * value


class SplineGridInterpolator(BaseGridInterpolator):
    '''
    Bivariate-spline interpolator (parity: interpolation.py:172-198);
    complex fields are resampled as re + 1j * im; multi-column inputs are
    handled column-by-column.
    '''

    def __mul__(self, rhs):

        from scipy.interpolate import RectBivariateSpline

        if self.shape[0] == self.shape[1]:
            return rhs

        rhs = np.asarray(rhs)
        if rhs.ndim == 2:
            out = np.zeros((self.shape[0], rhs.shape[1]),
                           dtype=rhs.dtype)
            for i in range(rhs.shape[1]):
                out[:, i] = self * rhs[:, i]
            return out
        if rhs.ndim > 2:
            raise NotImplementedError(
                '%s does not support %dD inputs'
                % (self.__class__.__name__, rhs.ndim))

        if np.iscomplexobj(rhs):
            return (self * rhs.real) + 1j * (self * rhs.imag)

        rbs = RectBivariateSpline(self.Z, self.X,
                                  rhs.reshape((self.nz, self.nx)))
        result = rbs(self.sZ, self.sX, grid=True)
        if self.eCons:
            result = result * self.compression
        return result.ravel()
