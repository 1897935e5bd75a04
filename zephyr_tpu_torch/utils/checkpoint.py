'''
Checkpoint / resume for zephyr_tpu_torch inversions: the port of
``zephyr_tpu.utils.checkpoint``.

The reference has no training-style checkpointing; its resume mechanism
is the FULLWV convention of iteration-numbered model files picked up by
the datastore regexes (zephyr/middleware/db.py:19-33). Both are provided:

- ``InversionCheckpointer``: checkpoints of the full FWI state (model,
  optimizer memory, frequency-block index, misfit history) with atomic
  saves and restore-latest. The JAX package writes them with orbax; the
  port with ``torch.save``, so the two formats differ.
- ``save_fullwv_model`` / ``latest_fullwv_model``: the OMEGA-era
  iteration-numbered SEG-Y convention, for interop with reference-style
  workflows.
'''

import glob
import os
import re

import numpy as np
import torch

#: the file of a step directory that holds its state
STATE_FILE = 'state.pt'


def _encode(x):
    '''
    A state tree in the types ``torch.load(weights_only=True)`` accepts:
    numpy arrays and numpy scalars become tagged CPU tensors, tensors move
    to the CPU, dicts, lists and tuples are walked, Python scalars,
    strings and None pass through.
    '''
    if isinstance(x, dict):
        return {k: _encode(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_encode(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, (np.ndarray, np.generic)):
        # copy(): C-contiguous, and 0-d stays 0-d (ascontiguousarray
        # would make it 1-d)
        return {'__numpy__': torch.from_numpy(np.asarray(x).copy()),
                'scalar': isinstance(x, np.generic)}
    if x is None or isinstance(x, (bool, int, float, complex, str)):
        return x
    raise TypeError('InversionCheckpointer: cannot save a %s'
                    % type(x).__name__)


def _decode(x):
    'The inverse of ``_encode``: tagged tensors back to numpy.'
    if isinstance(x, dict):
        if '__numpy__' in x:
            a = x['__numpy__'].numpy()
            return a[()] if x['scalar'] else a
        return {k: _decode(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_decode(v) for v in x)
    return x


class InversionCheckpointer(object):
    '''
    ``torch.save``-backed checkpointing of FWI state: one ``step_%08d``
    directory a step. A state saved as numpy arrays and scalars restores
    as numpy, one saved as tensors as tensors on the CPU (loaded with
    ``weights_only=True``).
    '''

    def __init__(self, directory):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step):
        return os.path.join(self.directory, 'step_%08d' % step)

    def save(self, step, state):
        '''
        Args:
            step: integer step/iteration
            state: pytree (dict) of numpy arrays, tensors and scalars

        The state is written to a temporary file in the step directory
        and renamed over ``state.pt`` (``os.replace``), so a step is
        either saved whole or not listed; saving a step again replaces it.
        '''
        path = self._path(step)
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, '.%s.tmp' % STATE_FILE)
        torch.save(_encode(state), tmp)
        os.replace(tmp, os.path.join(path, STATE_FILE))

    def steps(self):
        out = []
        for fn in glob.glob(os.path.join(self.directory, 'step_*')):
            m = re.match(r'.*step_(\d+)$', fn)
            if m and os.path.exists(os.path.join(fn, STATE_FILE)):
                out.append(int(m.group(1)))
        return sorted(out)

    def restore(self, step=None):
        'Restore the given (or latest) step; returns (step, state).'
        steps = self.steps()
        if not steps:
            return None, None
        if step is None:
            step = steps[-1]
        state = torch.load(os.path.join(self._path(step), STATE_FILE),
                           weights_only=True)
        return step, _decode(state)


def save_fullwv_model(projnm, iteration, model, key='vp'):
    '''
    Write an iteration-numbered model file (e.g. proj12.vp) in the
    FULLWV/OMEGA convention the datastore regexes recognize. ``model`` is
    an (nz, nx) array or tensor.
    '''
    from ..middleware.segy import writeSEGY
    if isinstance(model, torch.Tensor):
        model = model.detach().cpu().numpy()
    fn = '%s%d.%s' % (projnm, iteration, key)
    writeSEGY(fn, np.asarray(model).T)  # SEG-Y stores one trace per x
    return fn


def latest_fullwv_model(projnm, key='vp'):
    'Find the latest iteration-numbered model file; returns (iter, path).'
    best = (-1, None)
    pattern = re.compile(r'^%s(\d+)\.%s$' % (re.escape(projnm),
                                             re.escape(key)))
    for fn in glob.glob('%s*.%s' % (projnm, key)):
        m = pattern.match(fn)
        if m:
            it = int(m.group(1))
            if it > best[0]:
                best = (it, fn)
    return best
