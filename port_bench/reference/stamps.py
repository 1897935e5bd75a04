'''
Kaiser-windowed sinc point stamps (Hicks 2002) for sources and receivers,
written out plainly in numpy from the definition that uwoseis/zephyr's
SparseKaiserSource uses (source.py:122-322), for grids with no free
surface: the stamp is centred on the node nearest the position (the
first in row-major order on a tie, with distances taken on the node
coordinates i * h), its sinc arguments are the position's offset from
that node as written there (physical offset plus the node index, so a
grid of spacing 1 is the one where the offset is in cells), and it is
clipped at the grid's edge. Source stamps carry 1 / (dx dz); receiver
stamps do not.
'''

import numpy as np

KAISER_B = {1: 1.24, 2: 2.94, 3: 4.53, 4: 6.31, 5: 7.91,
            6: 9.42, 7: 10.95, 8: 12.53, 9: 14.09, 10: 14.18}


def _nearest(coords, v):
    d = np.abs(coords - v)
    return int(np.argmin(d))


def stamps(shape, dx, dz, pos, ireg=4, receiver=False):
    '''
    (index (n, K) int64, value (n, K) complex128) of the stamps of ``pos``
    ((n, 2) physical (x, z)) on an (nz, nx) grid; padded entries have
    value 0 and index 0.
    '''

    nz, nx = shape
    xs = np.arange(nx) * dx
    zs = np.arange(nz) * dz
    b = KAISER_B[ireg]
    w = 2 * ireg + 1
    K = w * w
    idx = np.zeros((len(pos), K), np.int64)
    val = np.zeros((len(pos), K), np.complex128)
    grid = np.arange(w)
    for n, (px, pz) in enumerate(np.asarray(pos, np.float64)):
        # the nearest node: first minimum of the distance in row-major
        # order, looked for in a 5 x 5 window around the nearest row and
        # column
        iz, ix = _nearest(zs, pz), _nearest(xs, px)
        z0, z1 = max(iz - 2, 0), min(iz + 3, nz)
        x0, x1 = max(ix - 2, 0), min(ix + 3, nx)
        dist = np.sqrt((xs[None, x0:x1] - px) ** 2
                       + (zs[z0:z1, None] - pz) ** 2)
        k = int(np.argmin(dist))
        Z, X = z0 + k // (x1 - x0), x0 + k % (x1 - x0)
        ox, oz = px - X * dx, pz - Z * dz
        tz = oz + ireg - grid
        tx = ox + ireg - grid
        with np.errstate(invalid='ignore'):
            wz = np.nan_to_num(np.sqrt(1 - (tz / ireg) ** 2))
            wx = np.nan_to_num(np.sqrt(1 - (tx / ireg) ** 2))
        sz = np.sinc(tz) * np.i0(b * wz) / np.i0(b)
        sx = np.sinc(tx) * np.i0(b * wx) / np.i0(b)
        region = sz[:, None] * sx[None, :]
        rows = Z + grid - ireg
        cols = X + grid - ireg
        keep = ((rows >= 0) & (rows < nz))[:, None] \
            & ((cols >= 0) & (cols < nx))[None, :]
        lin = rows[:, None] * nx + cols[None, :]
        scale = 1.0 if receiver else 1.0 / (dx * dz)
        m = int(keep.sum())
        idx[n, :m] = lin[keep]
        val[n, :m] = scale * region[keep]
    return idx, val


def dense(shape, idx, val):
    '(n, nz, nx) fields of the stamps.'
    nz, nx = shape
    out = np.zeros((idx.shape[0], nz * nx), np.complex128)
    np.add.at(out, (np.arange(idx.shape[0])[:, None], idx), val)
    return out.reshape(-1, nz, nx)
