'''
The port's utils (profiling, tracing, checkpoints), its driver entry
points (zephyr_tpu_torch.entry) and its examples, on the CPU, against
the JAX package's (tests/test_utils_realio.py:147-200,
__graft_entry__.py, examples/*.py).

Tolerances: the entry forward against the JAX package's 1e-4 relative
(both complex64, solver tol 1e-5); checkpoints restore bit for bit; the
FULLWV model files 1e-6 relative (IEEE float32 SEG-Y).
'''

import glob
import json
import os

import numpy as np
import pytest
import torch

import zephyr_tpu.utils as jutils
import zephyr_tpu_torch.utils as putils
from zephyr_tpu.middleware.segy import SEGYFile as JSEGYFile
from zephyr_tpu_torch.middleware.segy import SEGYFile
from zephyr_tpu_torch import entry as pentry
from zephyr_tpu_torch.examples import (forward_modelling_demo, fwi_demo,
                                       multiscale_fwi_demo)

PACKAGES = {'jax': jutils, 'port': putils}


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    '''
    One torch thread for this file: its small shapes gain nothing from
    more (the 200x100 demo: 17.2 s on one thread, 17.6 s on eight), and
    beside the suite's other workers more threads than cores slowed it
    up to 50x.
    '''
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('pkg', list(PACKAGES))
def test_profiling_decorators(pkg):
    u = PACKAGES[pkg]

    @u.timeIt
    def f(x):
        return x + 1

    @u.count
    def g(x):
        return x * 2

    for i in range(3):
        f(i)
        g(i)
    st = u.stats()
    fk = [k for k in st if k.endswith('test_profiling_decorators.<locals>.f')]
    gk = [k for k in st if k.endswith('test_profiling_decorators.<locals>.g')]
    assert st[fk[0]]['calls'] >= 3 and st[fk[0]]['total'] > 0
    assert st[gk[0]]['calls'] >= 3


def test_trace_annotate(tmp_path):
    '''
    trace() writes a Chrome trace into its logdir that holds the
    annotate() region; a timeIt-wrapped call inside it is in stats().
    '''
    @putils.timeIt
    def work(n):
        return torch.ones(n).cumsum(0)[-1]

    logdir = str(tmp_path / 'trace')
    with putils.trace(logdir) as d:
        assert d == logdir
        with putils.annotate('dd_solve'):
            work(1000)
    files = glob.glob(os.path.join(logdir, '*.pt.trace.json'))
    assert len(files) == 1
    events = json.load(open(files[0]))['traceEvents']
    assert any(e.get('name') == 'dd_solve' for e in events)
    key = [k for k in putils.stats() if k.endswith('<locals>.work')]
    assert putils.stats()[key[0]]['calls'] == 1


def test_checkpointer_roundtrip(tmp_path):
    'tests/test_utils_realio.py:168-182 on the port.'
    ckpt = putils.InversionCheckpointer(str(tmp_path / 'ckpt'))
    state = {'model': np.arange(12.).reshape(3, 4),
             'misfit': np.array(0.5),
             'block': np.array(2)}
    ckpt.save(3, state)
    ckpt.save(7, {k: v * 2 for k, v in state.items()})
    assert ckpt.steps() == [3, 7]
    step, restored = ckpt.restore()
    assert step == 7
    assert np.allclose(restored['model'], state['model'] * 2)
    step, restored = ckpt.restore(3)
    assert np.allclose(restored['model'], state['model'])


def test_checkpointer_types_bit_for_bit(tmp_path):
    '''
    numpy leaves (0-d, non-contiguous, complex, numpy scalars) come back
    as numpy of the same dtype and shape, tensors as CPU tensors, both
    bit for bit; a step directory without its state file is not listed,
    and saving a step again replaces it.
    '''
    ckpt = putils.InversionCheckpointer(str(tmp_path / 'ckpt'))
    rng = np.random.default_rng(0)
    state = {'model': rng.standard_normal((6, 5))[:, ::2],
             'misfit': np.array(0.5, np.float32),
             'field': (rng.standard_normal((3, 4))
                       + 1j * rng.standard_normal((3, 4))).astype(
                           np.complex64),
             'scalar': np.float64(1.25),
             'tensors': [torch.randn(4, dtype=torch.float64),
                         torch.tensor(3)],
             'history': [1.0, 0.5], 'name': 'block0', 'none': None}
    ckpt.save(1, state)
    os.makedirs(os.path.join(str(tmp_path / 'ckpt'), 'step_00000009'))
    assert ckpt.steps() == [1]
    _, back = ckpt.restore()
    for k in ('model', 'misfit', 'field'):
        assert isinstance(back[k], np.ndarray)
        assert back[k].dtype == state[k].dtype
        assert back[k].shape == state[k].shape
        assert np.array_equal(back[k], state[k])
    assert isinstance(back['scalar'], np.float64)
    assert back['scalar'] == state['scalar']
    for a, b in zip(back['tensors'], state['tensors']):
        assert a.device.type == 'cpu' and torch.equal(a, b)
    assert back['history'] == [1.0, 0.5] and back['name'] == 'block0'
    assert back['none'] is None
    ckpt.save(1, {'model': np.zeros(2)})
    assert np.array_equal(ckpt.restore(1)[1]['model'], np.zeros(2))
    with pytest.raises(TypeError):
        ckpt.save(2, {'bad': object()})


@pytest.mark.parametrize('writer', list(PACKAGES))
def test_fullwv_model_convention(tmp_path, monkeypatch, writer):
    '''
    tests/test_utils_realio.py:185-200: each package's model files are
    found by both packages' latest_fullwv_model and read by both SEG-Y
    readers.
    '''
    monkeypatch.chdir(tmp_path)
    model = 2000. * np.ones((30, 40))
    model[10:20] += np.arange(40.)
    u = PACKAGES[writer]
    u.save_fullwv_model('proj', 1, model)
    u.save_fullwv_model('proj', 12, model + 100)
    for reader in PACKAGES.values():
        it, fn = reader.latest_fullwv_model('proj')
        assert it == 12 and fn == 'proj12.vp'
    for segy in (SEGYFile, JSEGYFile):
        assert np.allclose(segy(fn)[:].T, model + 100, rtol=1e-6)


def test_fullwv_model_from_tensor(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    model = torch.full((8, 6), 1500., dtype=torch.float64)
    fn = putils.save_fullwv_model('t', 3, model)
    assert np.allclose(SEGYFile(fn)[:].T, model.numpy())


def test_entry_matches_jax():
    'The forward step of entry() on the CPU against the JAX package.'
    import __graft_entry__ as g

    fn_j, args_j = g.entry()
    d_re, d_im = fn_j(*args_j)
    ref = np.asarray(d_re) + 1j * np.asarray(d_im)
    fn, args = pentry.entry(device='cpu')
    assert args[1].dtype == torch.complex64
    out = fn(*args).detach().numpy()
    assert out.shape == ref.shape == (2, 2, 3)
    assert np.linalg.norm(out - ref) <= 1e-4 * np.linalg.norm(ref)


def test_dryrun_multichip_cpu():
    'The dry-run on a 4-device virtual CPU mesh, within its bounds.'
    out = pentry.dryrun_multichip(4, device='cpu')
    assert out['mesh'] == {'freq': 2, 'src': 2}
    assert out['dd_mesh'] == {'z': 2, 'x': 2}
    assert out['grad_rel'] <= pentry.DRYRUN_GRAD_BOUND
    assert out['misfit_rel'] <= pentry.DRYRUN_MISFIT_BOUND
    assert out['dd_rel'] <= pentry.DRYRUN_DD_BOUND


def test_entry_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError):
        pentry.entry()


def test_forward_modelling_demo():
    out = forward_modelling_demo.main(['--device', 'cpu'])
    assert out['minizephyr'] < 1e-2 and out['eurus'] < 3e-2
    assert abs(out['dispersion']) > 1e-3


def test_fwi_demo_small(tmp_path):
    'The FWI demo at 32^2, 2 frequencies, 2 L-BFGS iterations.'
    path = str(tmp_path / 'm.npy')
    out = fwi_demo.main(['--device', 'cpu', '--nx', '32', '--nz', '32',
                         '--maxiter', '2', '--freqs', '100', '200',
                         '--out', path])
    assert out['f'] < out['f0']
    assert np.load(path).shape == (32, 32)


def test_multiscale_fwi_demo_small(tmp_path):
    '''
    The multiscale demo with 2 frequencies (one a block) and one L-BFGS
    iteration a block: checkpoints and FULLWV files written and resumed.
    '''
    out = multiscale_fwi_demo.main(['--device', 'cpu', '--outdir',
                                    str(tmp_path), '--maxiter', '1',
                                    '--freqs', '90', '130'])
    assert len(out['history']) == 2
    assert out['inner'] < -20.
    assert sorted(os.listdir(str(tmp_path / 'ckpt'))) == [
        'step_00000000', 'step_00000001']
