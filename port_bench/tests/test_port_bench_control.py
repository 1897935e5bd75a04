'''
The comparison that decides ``correct`` fails what it must, on the CPU
in a tiny copy (tiny.py): the lower-precision control (the reference in
bfloat16 storage in the program's place) and a run whose timed path is
broken underneath, once for each fault the cell can have: a solve that
returns its state unchanged, half of the batch left out, one
answer altered where it is produced. (No cell runs on more than one
chip, so none has an exchange between chips to leave out.)
'''

import json
import os
import subprocess
import sys

import pytest

import tiny

DRIVERS = {w['name']: json.load(open(os.path.join(
    tiny.BENCH_DIR, 'traffic', w['traffic'] + '.json')))['driver']
    for w in tiny.bench()['workloads']}
MODEL_CELLS = [k for k, v in DRIVERS.items() if v == 'model_batches']

#: the chunked solver, broken: (name, what it does to (x, iters, relres))
SOLVER_FAULTS = {
    'unchanged': 'x = torch.zeros_like(x)',
    'half_batch': 'x = x.clone(); x[x.shape[0] // 2:] = 0',
    'altered': 'x = x.clone(); x[3] = x[3] * 1.05',
}
@pytest.fixture(scope='module')
def copy(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp('bench'))


def _solver_fault(body):
    return ('import torch\n'
            'from zephyr_tpu_torch.solver import helmholtz as H\n'
            '_make = H.make_chunked_solver\n'
            'def make(config, chunk=64):\n'
            '    solve = _make(config, chunk=chunk)\n'
            '    def broken(op, b, max_chunks=None, trace=None):\n'
            '        x, iters, relres = solve(op, b, max_chunks, trace)\n'
            '        if max_chunks is None:\n'
            '            %s\n'
            '        return x, iters, relres\n'
            '    return broken\n'
            'H.make_chunked_solver = make\n' % body)


@pytest.mark.parametrize('fault', sorted(SOLVER_FAULTS))
@pytest.mark.parametrize('workload', MODEL_CELLS)
def test_a_broken_solve_is_not_correct(copy, workload, fault):
    rc, out, err = tiny.drive(copy, workload,
                              before=_solver_fault(SOLVER_FAULTS[fault]))
    assert rc == 0, err[-3000:]
    res = tiny.result(out)
    assert not res['correct'], res['checks']


@pytest.mark.parametrize('workload', MODEL_CELLS)
def test_the_lower_precision_control_fails(copy, workload):
    script = ('import sys\nsys.path[:0] = [%r, %r]\nimport control\n'
              'sys.exit(control.main(["--workload", %r, "--seeds", "4,5", '
              '"--seconds", "0.3"], device="cpu"))\n'
              % (os.path.join(copy, 'port_bench'), tiny.REPO, workload))
    p = subprocess.run([sys.executable, '-c', script], cwd=copy,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    summary = json.loads(p.stdout.strip().splitlines()[-1])
    assert summary['control_fails_every_seed']
    limits = json.load(open(os.path.join(
        copy, 'port_bench', 'traffic', workload + '.json')))['limits']
    for k, lim in limits.items():
        assert summary['program_max'][k] <= lim
