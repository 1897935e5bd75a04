'''
Source- and receiver-generating routines for zephyr_tpu_torch.

A copy of ``zephyr_tpu.backend.source`` (numpy/scipy only): SimpleSource
nearest-gridpoint deltas, and Hicks (2002) Kaiser-windowed sinc
interpolation with free-surface image mirroring and its anisotropic
variant (reference zephyr/backend/source.py:31-351). Geometry
preprocessing happens once on the host; ``.stamps(sLocs)`` gives the
flat (rows, cols, vals) arrays that ``zephyr_tpu_torch.ops.kaiser``
injects and extracts on the device.
'''

import numpy as np
import scipy.sparse as sp

from .base import BaseModelDependent, BaseAnisotropic

#: Kaiser b parameter per half-width (Hicks 2002, Table 1; reference
#: source.py:138-149)
HC_KAISER = {
    1: 1.24, 2: 2.94, 3: 4.53, 4: 6.31, 5: 7.91,
    6: 9.42, 7: 10.95, 8: 12.53, 9: 14.09, 10: 14.18,
}


class BaseSource(BaseModelDependent):
    'Trivial base class for sources'


class FakeSource(BaseSource):
    'Source that does nothing (for use with analytical systems)'

    def __call__(self, loc):
        return loc


class SimpleSource(BaseSource):
    '''
    Nearest-gridpoint delta source. Calling with an (nsrc, 2) array of
    (x, z) locations returns dense RHS vectors of shape (nrow, nsrc).
    '''

    def __init__(self, systemConfig):

        super().__init__(systemConfig)

        if hasattr(self, 'ny'):
            raise NotImplementedError('Sources not implemented for 3D case')

        self._z, self._x = np.mgrid[
            self.zorig: self.zorig + self.dz * self.nz: self.dz,
            self.xorig: self.xorig + self.dx * self.nx: self.dx
        ]

    def dist(self, loc):
        'Distance of each gridpoint from each (x, z) source location.'

        loc = np.asarray(loc)
        nsrc = loc.shape[0]
        return np.sqrt(
            (self._x.reshape((1, self.nz, self.nx))
             - loc[:, 0].reshape((nsrc, 1, 1))) ** 2
            + (self._z.reshape((1, self.nz, self.nx))
               - loc[:, 1].reshape((nsrc, 1, 1))) ** 2)

    def linIndexOf(self, loc):
        '''
        The linear index of the nearest gridpoint to each location: the
        first minimum of ``dist`` in row-major order. It is searched in a
        5 x 5 window around the nearest row and column, which holds every
        gridpoint within rounding of the minimum, with ``dist``'s own
        arithmetic, so the (nsrc, nz, nx) distance array of a large grid
        is never built.
        '''

        loc = np.asarray(loc)
        zs, xs = self._z[:, 0], self._x[0]
        out = np.empty(loc.shape[0], dtype=np.intp)
        for i, (lx, lz) in enumerate(loc[:, :2]):
            iz = int(np.argmin(np.abs(zs - lz)))
            ix = int(np.argmin(np.abs(xs - lx)))
            z0, z1 = max(iz - 2, 0), min(iz + 3, self.nz)
            x0, x1 = max(ix - 2, 0), min(ix + 3, self.nx)
            d = np.sqrt((self._x[z0:z1, x0:x1] - lx) ** 2
                        + (self._z[z0:z1, x0:x1] - lz) ** 2)
            k = int(np.argmin(d))
            out[i] = (z0 + k // (x1 - x0)) * self.nx + x0 + k % (x1 - x0)
        return out

    def vecIndexOf(self, loc):
        'The (z, x) grid index of each source location.'

        return self.toVecIndex(self.linIndexOf(loc))

    def __call__(self, loc):

        loc = np.asarray(loc)
        nsrc = loc.shape[0]
        q = np.zeros((nsrc, self.nrow), dtype=np.complex128)
        q[np.arange(nsrc), self.linIndexOf(loc)] = 1.
        return q.T


class StackedSimpleSource(SimpleSource):
    '''
    SimpleSource stacked over zeros — the doubled RHS layout of the Eurus
    2N-state system (reference source.py:110-119).
    '''

    def __call__(self, loc):

        q = super().__call__(loc)
        return np.vstack([q, np.zeros(q.shape, dtype=np.complex128)])


class SparseKaiserSource(SimpleSource):
    '''
    Kaiser-windowed sinc source/receiver interpolation after Hicks (2002),
    with free-surface image mirroring; returns a scipy sparse matrix of
    shape (nrow, nsrc). Reference parity: source.py:122-322.
    '''

    initMap = {
    #   Argument        Required    Rename as ...   Store as type
        'ireg':         (False,     '_ireg',        np.int64),
        'freeSurf':     (False,     '_freeSurf',    tuple),
    }

    @property
    def ireg(self):
        'Half-width of the source region'
        return int(getattr(self, '_ireg', 4))

    @staticmethod
    def modifyGrid(Zi, Xi, aZi, aXi):
        'Hook for anisotropic grid skewing; identity by default.'
        return Zi, Xi

    def kws(self, offset, aZi, aXi):
        '''
        The (2*ireg+1, 2*ireg+1) Kaiser-windowed sinc stamp for a source
        offset (xOffset, zOffset) in fractional cells from the nearest node.
        '''

        ireg = self.ireg
        try:
            b = HC_KAISER[ireg]
        except KeyError:
            raise ValueError(
                'Kaiser windowed sinc function not implemented for '
                'half-width of %d' % (ireg,))

        freg = 2 * ireg + 1
        xOffset, zOffset = offset

        Zi, Xi = np.mgrid[:freg, :freg]
        Zi, Xi = self.modifyGrid(Zi, Xi, aZi, aXi)

        dZi = zOffset + ireg - Zi
        dXi = xOffset + ireg - Xi

        with np.errstate(invalid='ignore'):
            tZi = np.nan_to_num(np.sqrt(1 - (dZi / ireg) ** 2))
            tXi = np.nan_to_num(np.sqrt(1 - (dXi / ireg) ** 2))

        taperZ = np.i0(b * tZi) / np.i0(b)
        taperX = np.i0(b * tXi) / np.i0(b)

        return (np.sinc(dXi) * taperX) * (np.sinc(dZi) * taperZ)

    def _stampFor(self, sLoc, qI):
        '''
        Build one source's stamp: returns (columns, values) flat arrays
        after boundary clipping and free-surface mirroring.
        '''

        ireg = self.ireg
        freeSurf = self.freeSurf
        nz, nx = self.nz, self.nx
        srcScale = 1. / (self.dx * self.dz)

        Zi, Xi = int(qI) // nx, int(qI) % nx
        offset = (sLoc[0] - self.xorig - Xi * self.dx,
                  sLoc[1] - self.zorig - Zi * self.dz)
        region = self.kws(offset, Zi, Xi)

        lShift, sShift = np.mgrid[-ireg:ireg + 1, -ireg:ireg + 1]
        qshift = lShift * nx + sShift

        # Clip (and mirror for free surfaces) each edge in the reference's
        # order: bottom (row 0), top (last row), left, right.
        if Zi < ireg:
            index = ireg - Zi
            lift = np.flipud(region[:index, :]) if freeSurf[2] else None
            region = region[index:, :]
            qshift = qshift[index:, :]
            if lift is not None:
                region[:index, :] -= lift

        if Zi > nz - ireg - 1:
            index = nz - ireg - 1 - Zi
            lift = np.flipud(region[index:, :]) if freeSurf[0] else None
            region = region[:index, :]
            qshift = qshift[:index, :]
            if lift is not None:
                region[index:, :] -= lift

        if Xi < ireg:
            index = ireg - Xi
            lift = np.fliplr(region[:, :index]) if freeSurf[3] else None
            region = region[:, index:]
            qshift = qshift[:, index:]
            if lift is not None:
                region[:, :index] -= lift

        if Xi > nx - ireg - 1:
            index = nx - ireg - 1 - Xi
            lift = np.fliplr(region[:, index:]) if freeSurf[1] else None
            region = region[:, :index]
            qshift = qshift[:, :index]
            if lift is not None:
                region[:, index:] -= lift

        return qI + qshift.ravel(), srcScale * region.ravel()

    def stamps(self, sLocs):
        '''
        Flat stamp arrays for device-side injection: (rows, cols, vals)
        where rows[i] is the source index, cols[i] the linear grid index.
        '''

        sLocs = np.asarray(sLocs, dtype=np.float64)
        N = sLocs.shape[0]
        qI = self.linIndexOf(sLocs)

        if self.ireg == 0:
            srcScale = 1. / (self.dx * self.dz)
            return (np.arange(N), qI,
                    srcScale * np.ones(N, dtype=np.complex128))

        rows, cols, vals = [], [], []
        for i in range(N):
            c, v = self._stampFor(sLocs[i], qI[i])
            rows.append(np.full(c.size, i))
            cols.append(c)
            vals.append(v.astype(np.complex128))
        return (np.concatenate(rows), np.concatenate(cols),
                np.concatenate(vals))

    def __call__(self, sLocs):

        sLocs = np.asarray(sLocs, dtype=np.float64)
        N = sLocs.shape[0]
        M = self.nz * self.nx
        rows, cols, vals = self.stamps(sLocs)
        q = sp.coo_matrix((vals, (rows, cols)), shape=(N, M),
                          dtype=np.complex128)
        return q.T


class KaiserSource(SparseKaiserSource):
    'Dense-array convenience wrapper over SparseKaiserSource.'

    def __call__(self, sLocs):

        q = super().__call__(sLocs)
        return q.toarray()


class AnisotropicKaiserSource(SparseKaiserSource, BaseAnisotropic):
    '''
    Kaiser source with the sinc-sampling grid skewed by the local Thomsen
    parameters (reference source.py:337-351).
    '''

    def modifyGrid(self, Zi, Xi, aZi, aXi):

        theta = self.theta[aZi, aXi]
        epsilon = self.eps[aZi, aXi]
        delta = self.delta[aZi, aXi]

        root = np.sqrt(1 + 2 * delta)
        wx = (1. + 2 * epsilon + root) / (1 + epsilon + root)
        wz = (1. + root) / (1 + epsilon + root)

        Xi = Xi * (wx * np.cos(theta)) + Xi * (wz * np.sin(theta))
        Zi = Zi * (wx * np.sin(theta)) + Zi * (wz * np.cos(theta))

        return Zi, Xi
