'''
A copy of ``zephyr_tpu.middleware.mesh`` (host only: numpy and scipy), kept
in the port so that it never imports the JAX package.

Minimal tensor-mesh utilities for the inversion layer.

The reference delegates mesh bookkeeping to SimPEG's TensorMesh
(zephyr/middleware/problem.py:35-38) — only the node/cell counts and the
node-to-cell-centre averaging operator are actually used (by
zephyr/middleware/maps.py). This module provides exactly that surface,
implemented standalone.
'''

import numpy as np
import scipy.sparse as sp


class TensorMesh2D(object):
    '''
    A 2D tensor-product mesh with (nx-1) x (nz-1) cells and nx * nz nodes,
    matching the reference's SimPEG.Mesh.TensorMesh([hx, hz]) construction
    from a (dx, nx-1), (dz, nz-1) spec.
    '''

    def __init__(self, nx, nz, dx=1.0, dz=1.0, x0=(0.0, 0.0)):
        self.nx = int(nx)
        self.nz = int(nz)
        self.dx = float(dx)
        self.dz = float(dz)
        self.x0 = x0

    @property
    def nN(self):
        'Number of nodes'
        return self.nx * self.nz

    @property
    def nC(self):
        'Number of cells'
        return (self.nx - 1) * (self.nz - 1)

    @property
    def nCx(self):
        return self.nx - 1

    @property
    def nCz(self):
        return self.nz - 1

    @property
    def aveN2CC(self):
        'Sparse averaging operator from nodes to cell centres.'
        if not hasattr(self, '_aveN2CC'):
            nx, nz = self.nx, self.nz
            rows, cols, vals = [], [], []
            for iz in range(nz - 1):
                for ix in range(nx - 1):
                    cell = iz * (nx - 1) + ix
                    for dz_ in (0, 1):
                        for dx_ in (0, 1):
                            rows.append(cell)
                            cols.append((iz + dz_) * nx + (ix + dx_))
                            vals.append(0.25)
            self._aveN2CC = sp.coo_matrix(
                (vals, (rows, cols)), shape=(self.nC, self.nN)).tocsr()
        return self._aveN2CC
