'''
Carry the JAX package's prepared state into the port.

The JAX package (``zephyr_tpu``) keeps a prepared Helmholtz system as a
pytree of NamedTuples (HelmholtzOperator -> MGHierarchy -> MGLevel,
StratPCR). After ``jax.tree_util.tree_map(np.asarray, op)`` every leaf is
a numpy array; ``operator_from_numpy`` rebuilds the port's
HelmholtzOperator from such a tree by attribute name, so the two packages
can be fed the same prepared state and a mismatch is isolated to either
the preparation or the solve. This module reads the tree's attributes
only and imports neither jax nor the JAX package.
'''

import numpy as np
import torch

from .solver.helmholtz import HelmholtzOperator
from .solver.multigrid import MGHierarchy, MGLevel
from .solver.stratified import StratPCR


def tensor_from_numpy(a, device='cpu'):
    '''
    A numpy array as a tensor on ``device``. bfloat16 arrays (numpy dtype
    name 'bfloat16', as ml_dtypes gives them) are carried bit for bit:
    viewed as 16-bit integers, then as torch.bfloat16 — never through
    float.
    '''

    a = np.array(a)     # an owned, writable, contiguous copy
    if a.dtype.name == 'bfloat16':
        t = torch.from_numpy(a.view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def model_from_numpy(c, rho, device='cpu', dtype=torch.complex128):
    '''
    The (c, rho) model arrays as tensors: c complex of ``dtype``, rho real
    of the matching precision.
    '''

    ct = torch.from_numpy(np.asarray(c, dtype=np.complex128)).to(
        device=device, dtype=dtype)
    rt = torch.from_numpy(np.asarray(rho, dtype=np.float64)).to(
        device=device, dtype=ct.real.dtype)
    return ct, rt


def _opt(a, device):
    return None if a is None else tensor_from_numpy(a, device)


def _hier_from_numpy(h, device):
    'The port\'s MGHierarchy from a JAX one with numpy leaves.'
    if any(getattr(lv, 'linez', None) is not None for lv in h.levels):
        raise NotImplementedError('operator_from_numpy: line-smoother '
                                  '(TTI) levels are not ported')
    levels = tuple(
        MGLevel(tensor_from_numpy(lv.planes, device),
                tensor_from_numpy(lv.dinv, device),
                tensor_from_numpy(lv.mask, device))
        for lv in h.levels)
    piv = h.coarse_piv
    if piv is not None:
        # JAX's lu_factor pivots are 0-based; torch's (LAPACK) 1-based
        piv = np.asarray(piv).astype(np.int32) + 1
    return MGHierarchy(levels, _opt(h.coarse_lu, device),
                       _opt(piv, device), _opt(h.coarse_inv, device))


def operator_from_numpy(tree, device='cpu'):
    '''
    The port's HelmholtzOperator from a JAX HelmholtzOperator whose
    leaves went through ``np.asarray``, the transposed hierarchy and
    planes included when the JAX operator was prepared
    ``with_transpose=True``. A tree that needs an unported path raises
    NotImplementedError.
    '''

    if getattr(tree, 'fft_sinv', None) is not None:
        raise NotImplementedError("operator_from_numpy: fft_mode='2d' "
                                  'symbol solves are not ported')
    hier = _hier_from_numpy(tree.hier, device)
    hierT = (None if getattr(tree, 'hierT', None) is None
             else _hier_from_numpy(tree.hierT, device))
    strat = None
    if tree.strat is not None:
        s = tree.strat
        if not hasattr(s, 'ldu') or getattr(s, 'dft', None) is not None:
            raise NotImplementedError('operator_from_numpy: only the '
                                      'scalar FFT stratified solve is '
                                      'ported')
        strat = StratPCR(tensor_from_numpy(s.alphas, device),
                         tensor_from_numpy(s.gammas, device),
                         tensor_from_numpy(s.dinv, device),
                         tensor_from_numpy(s.ldu, device))
    return HelmholtzOperator(tensor_from_numpy(tree.planes, device), hier,
                             strat, _opt(tree.cplanes, device), hierT,
                             _opt(getattr(tree, 'planesT', None), device))
