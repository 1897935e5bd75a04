'''
Source injection and receiver extraction from Kaiser stamps: the port of
``zephyr_tpu.ops.kaiser``. The (geometry-static) stamps become padded
index/value arrays used with scatter-add (injection) and gather
(extraction), both plain torch on the stamps' device.
'''

import numpy as np
import torch


def pad_stamps(rows, cols, vals, n, pad_to=None):
    '''
    Convert flat COO-style stamps (from SparseKaiserSource.stamps) into
    padded per-entity numpy arrays.

    Args:
        rows, cols, vals: flat arrays; rows[i] in [0, n)
        n: number of sources/receivers
        pad_to: stamp capacity (default: max entries per entity)

    Returns:
        (cols_padded (n, K) int32, vals_padded (n, K)) with zero-value
        padding (indices clamped to 0).
    '''

    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    counts = np.bincount(rows.astype(np.int64), minlength=n)
    K = int(pad_to or (counts.max() if counts.size else 1))

    cols_p = np.zeros((n, K), dtype=np.int32)
    vals_p = np.zeros((n, K), dtype=vals.dtype)
    cursor = np.zeros(n, dtype=np.int64)
    for r, c, v in zip(rows, cols, vals):
        k = cursor[r]
        cols_p[r, k] = c
        vals_p[r, k] = v
        cursor[r] += 1
    return cols_p, vals_p


def inject(cols, vals, nz, nx):
    '''
    Dense source fields from padded stamps (tensors): (n, K) ->
    (n, nz, nx) by scatter-add. Differentiable w.r.t. vals.
    '''

    n, K = cols.shape
    fields = torch.zeros((n, nz * nx), dtype=vals.dtype, device=vals.device)
    fields = fields.scatter_add(1, cols.long(), vals)
    return fields.reshape((n, nz, nx))


def extract(u, cols, vals):
    '''
    Receiver extraction by gather: u (..., nz, nx), cols/vals padded
    stamps (nrec, K) -> (..., nrec). Differentiable w.r.t. u and vals.
    '''

    flat = u.reshape(u.shape[:-2] + (u.shape[-2] * u.shape[-1],))
    gathered = flat[..., cols.long()]              # (..., nrec, K)
    return torch.sum(gathered * vals, dim=-1)
