'''
A tiny copy of the benchmark for the CPU tests: the benchmark's files
and BENCHMARK.json in a temporary directory, with each configuration cut
to a 48 x 144 grid (32 shots, 30 receivers) and each traffic mix to a
matching frequency, and a way to drive one run there on the CPU.
'''

import json
import os
import shutil
import subprocess
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH_DIR)

def bench():
    return json.load(open(os.path.join(REPO, 'BENCHMARK.json')))


CELLS = [w['name'] for w in bench()['workloads']]


def make(tmp):
    '''Copy the benchmark into ``tmp`` and cut it down; returns ``tmp``.'''
    tmp = str(tmp)
    shutil.copytree(BENCH_DIR, os.path.join(tmp, 'port_bench'),
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    b = bench()
    json.dump(b, open(os.path.join(tmp, 'BENCHMARK.json'), 'w'))
    for c in b['configs']:
        path = os.path.join(tmp, c['file'])
        cfg = json.load(open(path))
        cfg['grid'] = {'nz': 48, 'nx': 144}
        cfg['shots'] = {'x0_cells': 20.0, 'dx_cells': 3.25, 'count': 32,
                        'z_cells': 16}
        cfg['receivers'] = {'x0_cells': 14.0, 'dx_cells': 4.0, 'count': 30,
                            'z_cells': 16}
        json.dump(cfg, open(path, 'w'))
    for w in b['workloads']:
        path = os.path.join(tmp, 'port_bench', 'traffic',
                            w['traffic'] + '.json')
        t = json.load(open(path))
        if t['driver'] == 'model_batches':
            t['freq_hz'] = 150.0 / json.load(open(os.path.join(
                tmp, [c['file'] for c in b['configs']
                      if c['name'] == w['config']][0])))['spacing_m']
        json.dump(t, open(path, 'w'))
    return tmp


def drive(tmp, workload, seed=2 ** 31 + 11, seconds=0.5, trace=0,
          before='', script=None):
    '''
    Run ``run.run`` of the copy in ``tmp`` on the CPU in a fresh process
    (``before``: Python run first, e.g. to break the program); returns
    (exit code, stdout, stderr).
    '''
    code = script or (
        'import sys, time\n'
        'sys.path[:0] = [%r, %r]\n'
        '%s\n'
        'import run\n'
        'a = run.parse(["--workload", %r, "--seed", "%d", "--seconds", '
        '"%s", "--trace", "%d"])\n'
        'sys.exit(run.run(a, device="cpu", t_start=time.perf_counter()))\n'
        % (os.path.join(tmp, 'port_bench'), REPO, before, workload, seed,
           seconds, trace))
    p = subprocess.run([sys.executable, '-c', code], cwd=tmp,
                       capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, PYTHONPATH=REPO))
    return p.returncode, p.stdout, p.stderr


def result(stdout):
    return json.loads(stdout.strip().splitlines()[-1])
