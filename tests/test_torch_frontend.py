'''
The port's frontend (zephyr_tpu_torch.frontend: the job classes and the
argparse CLI) against the JAX package's (tests/test_frontend.py), driven
end to end on the same synthetic 40x30 OMEGA project (ini + SEG-Y
velocity, two frequencies, two sources, three receivers), on the CPU
(``--device cpu`` / ``supplementalConfig={'device': 'cpu'}``).

Tolerances: the modelled data, complex128, solved to tol 1e-11
(``solverOpts`` through ``supplementalConfig``), within rel 1e-8 of the
JAX job's; at the default tol 1e-7 the two BiCGStab trajectories differ
by rounding, which moves the data by ~tol (3.5e-7 here), so the CLI's
data are held to the .utout file's float32 storage (1e-5 of the largest
value, as the JAX test holds its file to its data).
'''

import os

import numpy as np
import pytest
import torch

from zephyr_tpu.frontend.jobs import OmegaJob as JaxOmegaJob
from zephyr_tpu_torch.frontend import cli
from zephyr_tpu_torch.frontend.jobs import OmegaJob
from zephyr_tpu_torch.middleware import FullwvDatastore, utoutRead, SEGYFile
from zephyr_tpu_torch.middleware.segy import writeSEGY

from test_io import _write_mini_ini

NX, NZ = 40, 30
FREQS = [50., 100.]
CPU = {'device': 'cpu'}
TIGHT = {'solverOpts': {'tol': 1e-11}}


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    '''
    The port's side on one intra-op thread for this module (its tensors
    are small; the parallel test run shares the cores), restored after.
    '''
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel())


@pytest.fixture
def project(tmp_path):
    srcs = [(5., 5.), (10., 5.)]
    recs = [(5., 25.), (15., 25.), (25., 25.)]
    cwd = os.getcwd()
    os.chdir(tmp_path)
    _write_mini_ini('demo.ini', NX, NZ, FREQS, srcs, recs)
    writeSEGY('demo.vp', 2000. * np.ones((NX, NZ)), format=5)
    yield 'demo'
    os.chdir(cwd)


def test_omega_job_end_to_end(project):
    'OmegaJob: the data, its .utout file, and the JAX job\'s data.'
    job = OmegaJob(project, supplementalConfig=dict(TIGHT, **CPU))
    assert job.systemConfig['device'] == 'cpu'
    data = job.run()
    assert data.shape == (3, 2, 2)
    assert data.dtype == np.complex128
    assert np.isfinite(data).all()
    assert os.path.exists('demo.utout')
    freqs, back = utoutRead('demo.utout', 3)
    assert back.shape == (3, 2, 2)
    assert np.allclose(back, data, atol=np.abs(data).max() * 1e-5)
    ref = JaxOmegaJob(project, supplementalConfig=TIGHT).run()
    assert _rel(data, ref) < 1e-8


def test_cli_inspect_and_model(project, capsys):
    'inspect prints the grid; model writes the JAX job\'s data.'
    assert cli.main(['inspect', project, '--device', 'cpu']) == 0
    out = capsys.readouterr().out
    assert 'Grid:        40 x 30' in out
    assert 'Frequencies: 2 (50 - 100 Hz)' in out
    assert 'Sources:     2' in out and 'Receivers:   3' in out

    assert cli.main(['model', project, '--device', 'cpu']) == 0
    assert os.path.exists('demo.utout')
    _, back = utoutRead('demo.utout', 3)
    ref = JaxOmegaJob(project).run()
    assert np.allclose(back, ref, atol=np.abs(ref).max() * 1e-5)


def test_cli_pack_unpack(project, capsys):
    assert cli.main(['pack', project, '--device', 'cpu']) == 0
    assert os.path.exists('demo.pickle')
    assert cli.main(['unpack', project, '--device', 'cpu']) == 0
    out = capsys.readouterr().out
    assert 'Packed demo -> demo.pickle' in out
    assert 'nx' in out and 'Unpacked demo.pickle' in out


def test_cli_invert_and_migrate(project, capsys, monkeypatch):
    '''
    migrate and invert against observed utobs data files made from a
    perturbed model (a finite, non-zero image; a finite model that moved
    from the start), on the project cut to 24x20 cells (each misfit
    gradient factorises the single-level hierarchy's dense LU); clean
    asks for confirmation and removes the outputs.
    '''
    nx, nz = 24, 20
    _write_mini_ini('demo.ini', nx, nz, FREQS, [(5., 5.), (10., 5.)],
                    [(5., 15.), (12., 15.), (19., 15.)])
    true_model = 2000. * np.ones((nx, nz))
    true_model[8:14, 7:12] -= 150.
    writeSEGY('demo.vp', true_model, format=5)
    data = OmegaJob('demo', supplementalConfig=CPU).run()
    for i, f in enumerate(FREQS):
        panel = data[:, :, i]
        inter = np.empty((2 * panel.shape[1], panel.shape[0]))
        inter[0::2] = panel.T.real
        inter[1::2] = panel.T.imag
        writeSEGY('demo.utobs%0.3f' % f, inter, format=5)
    writeSEGY('demo.vp', 2000. * np.ones((nx, nz)), format=5)

    assert cli.main(['migrate', 'demo', '--device', 'cpu']) == 0
    assert os.path.exists('demo1.gvp')
    img = SEGYFile('demo1.gvp')[:].T
    assert img.shape == (nz, nx)
    assert np.isfinite(img).all() and np.abs(img).max() > 0

    assert cli.main(['invert', 'demo', '--maxiter', '1',
                     '--device', 'cpu']) == 0
    assert os.path.exists('demo1.vp')
    m = SEGYFile('demo1.vp')[:]
    assert np.isfinite(m).all() and np.abs(m - 2000.).max() > 0

    monkeypatch.setattr('builtins.input', lambda prompt: 'n')
    assert cli.main(['clean', 'demo', '--device', 'cpu']) == 1
    assert os.path.exists('demo1.vp')
    assert cli.main(['clean', 'demo', '--yes', '--device', 'cpu']) == 0
    assert not os.path.exists('demo1.vp')
    assert not os.path.exists('demo.utout')
    assert 'Removed 3 output files' in capsys.readouterr().out


def test_omega_job_supplemental_config_and_default_device(project,
                                                          monkeypatch):
    '''
    A subset of the project through ``supplementalConfig`` (one
    frequency, one source, solverOpts with the 2D symbol solve), as the
    JAX test drives the reference's own project: the data equal the JAX
    job's with the same subset (rel 1e-8) and the .utout file holds that
    one frequency. Without ``--device`` the job runs on the card, so on a
    machine without one it refuses to start.
    '''
    sc = FullwvDatastore(project).systemConfig
    sub = {'freqs': [FREQS[1]],
           'geom': dict(sc['geom'], src=sc['geom']['src'][:1]),
           'solverOpts': dict(tol=1e-11, fft_mode='2d')}
    data = OmegaJob(project, supplementalConfig=dict(sub, **CPU)).run()
    assert data.shape == (3, 1, 1)
    freqs, d = utoutRead('demo.utout', nrec=3)
    assert d.shape[2] == 1
    assert np.allclose(np.real(freqs[0]), 2 * np.pi * FREQS[1], rtol=1e-5)
    ref = JaxOmegaJob(project, supplementalConfig=sub).run()
    assert _rel(data, ref) < 1e-8

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(['model', project])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OmegaJob(project)
