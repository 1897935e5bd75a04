'''
Carry the JAX package's prepared state into the port.

The JAX package (``zephyr_tpu``) keeps a prepared Helmholtz system as a
pytree of NamedTuples (HelmholtzOperator -> MGHierarchy -> MGLevel,
StratPCR). After ``jax.tree_util.tree_map(np.asarray, op)`` every leaf is
a numpy array; ``operator_from_numpy`` rebuilds the port's
HelmholtzOperator from such a tree by attribute name, so the two packages
can be fed the same prepared state and a mismatch is isolated to either
the preparation or the solve; ``multifreq_ops_from_numpy`` does so for
each frequency of a stacked multi-frequency operator. ``system_config``
carries a JAX-side systemConfig (the model as numpy arrays, the classes
by name) over to the port's classes. This module reads attributes and class names only and
imports neither jax nor the JAX package.
'''

import numpy as np
import torch

from .core.device import DEFAULT_DEVICE, resolve_device, resolve_dtype
from .solver.helmholtz import HelmholtzOperator
from .solver.multigrid import MGHierarchy, MGLevel
from .solver.stratified import StratPCR, StratPCRBlock, pack_pcr_factors


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
    stratified state with its DFT matrices (``strat_dft``), a block
    (TTI) operator's block stratified state and line-smoother levels, the
    inverse interior symbol ``fft_sinv`` of an ``fft_mode='2d'`` operator,
    and iterative hierarchies (no coarse LU, no inverse). Interior-masked
    levels come through their masks as they are.
    '''

    device = resolve_device(device)
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
        alphas, gammas, dinv = (tensor_from_numpy(a, device)
                                for a in (s.alphas, s.gammas, s.dinv))
        packed = (pack_pcr_factors(alphas, gammas, dinv)
                  if alphas.dtype == torch.bfloat16 else None)
        strat = StratPCR(alphas, gammas, dinv,
                         tensor_from_numpy(s.ldu, device), dft, packed)
    return HelmholtzOperator(tensor_from_numpy(tree.planes, device), hier,
                             strat, _opt(tree.cplanes, device), hierT,
                             _opt(getattr(tree, 'planesT', None), device),
                             _opt(getattr(tree, 'fft_sinv', None), device))


def _take(node, i):
    '''
    Entry i of every leaf of a tree of NamedTuples, tuples and numpy
    leaves with a leading batch axis (None stays None).
    '''
    if node is None:
        return None
    if isinstance(node, tuple) and hasattr(node, '_fields'):
        return type(node)(*(_take(x, i) for x in node))
    if isinstance(node, (tuple, list)):
        return type(node)(_take(x, i) for x in node)
    return np.asarray(node)[i]


def multifreq_ops_from_numpy(tree, device=DEFAULT_DEVICE):
    '''
    The port's per-frequency operator list from the JAX package's
    ``build_multifreq_ops`` result (one HelmholtzOperator pytree whose
    leaves carry a leading frequency axis) after ``np.asarray`` of every
    leaf: the leading axis is sliced and each frequency goes through
    ``operator_from_numpy``, on ``device`` (the card unless 'cpu' is asked
    for).
    '''

    nfreq = np.shape(tree.planes)[0]
    return [operator_from_numpy(_take(tree, i), device)
            for i in range(nfreq)]


def system_config(sc, device=DEFAULT_DEVICE, dtype=None):
    '''
    A copy of a JAX-side systemConfig for the port: its ``Disc``,
    ``SystemWrapper`` and ``remDists`` entries, and the geometry's
    ``GeneratorClass``, become the port's classes of the same
    ``__name__`` (compared as strings: the JAX package is never
    imported), and ``device`` (the card unless 'cpu' is asked for) and
    ``dtype`` (default complex64 on the card, complex128 on the CPU) are
    added. The model stays the numpy arrays it was. A class the port
    does not carry raises NotImplementedError.
    '''

    from . import backend
    device = resolve_device(device)

    def swap(cls):
        if not isinstance(cls, type):
            return cls
        port = getattr(backend, cls.__name__, None)
        if not isinstance(port, type):
            raise NotImplementedError('system_config: %s is not ported to '
                                      'zephyr_tpu_torch' % cls.__name__)
        return port

    out = dict(sc)
    for key in ('Disc', 'SystemWrapper'):
        if key in out:
            out[key] = swap(out[key])
    if out.get('remDists'):
        out['remDists'] = [swap(c) for c in out['remDists']]
    geom = out.get('geom')
    if isinstance(geom, dict) and 'GeneratorClass' in geom:
        out['geom'] = dict(geom, GeneratorClass=swap(geom['GeneratorClass']))
    out['device'] = str(device)
    out['dtype'] = resolve_dtype(dtype, device)
    return out
