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

from .core.device import DEFAULT_DEVICE, resolve_device
from .solver.helmholtz import HelmholtzOperator
from .solver.multigrid import MGHierarchy, MGLevel
from .solver.stratified import StratPCR, StratPCRBlock


def tensor_from_numpy(a, device=DEFAULT_DEVICE):
    '''
    A numpy array as a tensor on ``device`` (the card unless 'cpu' is
    asked for). bfloat16 arrays (numpy dtype name 'bfloat16', as
    ml_dtypes gives them) are carried bit for bit: viewed as 16-bit
    integers, then as torch.bfloat16 — never through float.
    '''

    device = resolve_device(device)
    a = np.array(a)     # an owned, writable, contiguous copy
    if a.dtype.name == 'bfloat16':
        t = torch.from_numpy(a.view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def model_from_numpy(c, rho, device=DEFAULT_DEVICE, dtype=torch.complex128):
    '''
    The (c, rho) model arrays as tensors: c complex of ``dtype``, rho real
    of the matching precision, on ``device`` (the card unless 'cpu' is
    asked for).
    '''

    device = resolve_device(device)
    ct = torch.from_numpy(np.asarray(c, dtype=np.complex128)).to(
        device=device, dtype=dtype)
    rt = torch.from_numpy(np.asarray(rho, dtype=np.float64)).to(
        device=device, dtype=ct.real.dtype)
    return ct, rt


def _opt(a, device):
    return None if a is None else tensor_from_numpy(a, device)


def _block_pcr_from_numpy(s, device):
    'A StratPCRBlock (bf16 factors bit for bit) from a JAX one, or None.'
    if s is None:
        return None
    return StratPCRBlock(*(tensor_from_numpy(a, device)
                           for a in (s.alphas, s.gammas, s.dinv, s.ldu)))


def _hier_from_numpy(h, device):
    'The port\'s MGHierarchy from a JAX one with numpy leaves.'
    levels = tuple(
        MGLevel(tensor_from_numpy(lv.planes, device),
                tensor_from_numpy(lv.dinv, device),
                tensor_from_numpy(lv.mask, device),
                _block_pcr_from_numpy(getattr(lv, 'linez', None), device),
                _block_pcr_from_numpy(getattr(lv, 'linex', None), device))
        for lv in h.levels)
    piv = h.coarse_piv
    if piv is not None:
        # JAX's lu_factor pivots are 0-based; torch's (LAPACK) 1-based
        piv = np.asarray(piv).astype(np.int32) + 1
    return MGHierarchy(levels, _opt(h.coarse_lu, device),
                       _opt(piv, device), _opt(h.coarse_inv, device))


def operator_from_numpy(tree, device=DEFAULT_DEVICE):
    '''
    The port's HelmholtzOperator from a JAX HelmholtzOperator whose
    leaves went through ``np.asarray``, the transposed hierarchy and
    planes included when the JAX operator was prepared
    ``with_transpose=True``, a scalar operator's global or x-panel
    stratified state with its DFT matrices (``strat_dft``), and a block
    (TTI) operator's block stratified state and line-smoother levels. A
    tree that needs an unported path raises NotImplementedError.
    '''

    device = resolve_device(device)
    if getattr(tree, 'fft_sinv', None) is not None:
        raise NotImplementedError("operator_from_numpy: fft_mode='2d' "
                                  'symbol solves are not ported')
    hier = _hier_from_numpy(tree.hier, device)
    hierT = (None if getattr(tree, 'hierT', None) is None
             else _hier_from_numpy(tree.hierT, device))
    strat = None
    if tree.strat is not None and np.ndim(tree.strat.ldu) == 5:
        # (3, 2, 2, nz, nx): the block family
        strat = _block_pcr_from_numpy(tree.strat, device)
    elif tree.strat is not None:
        # the global or the x-panel family (bands P*W wide), with the DFT
        # matrix pair when the JAX state carries one
        s = tree.strat
        dft = getattr(s, 'dft', None)
        if dft is not None:
            dft = tuple(tensor_from_numpy(m, device) for m in dft)
        strat = StratPCR(tensor_from_numpy(s.alphas, device),
                         tensor_from_numpy(s.gammas, device),
                         tensor_from_numpy(s.dinv, device),
                         tensor_from_numpy(s.ldu, device), dft)
    return HelmholtzOperator(tensor_from_numpy(tree.planes, device), hier,
                             strat, _opt(tree.cplanes, device), hierT,
                             _opt(getattr(tree, 'planesT', None), device))
