'''
Whole runs of the benchmark on the CPU, in a tiny copy (tiny.py): each
cell's driver with and without the trace, the refusal without a card, a
cell and metrics added as files only, and the check that the run loads
nothing of JAX or the JAX package.
'''

import json
import os
import subprocess
import sys

import pytest

import tiny

CELLS = tiny.CELLS


@pytest.fixture(scope='module')
def copy(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp('bench'))


@pytest.mark.parametrize('trace', [0, 1])
@pytest.mark.parametrize('workload', CELLS)
def test_each_cell_runs_and_is_correct(copy, workload, trace):
    rc, out, err = tiny.drive(copy, workload, trace=trace)
    assert rc == 0, err[-3000:]
    res = tiny.result(out)
    assert res['correct'] and res['failed'] == 0 and res['attempted'] > 0
    assert list(res)[-1] == 'checks'
    if not trace:
        assert 'setup_s' in res['metrics']
        assert len(res['metrics']) == 2
    for name, c in res['checks'].items():
        assert c['value'] <= c['limit'], name
    assert err.strip().splitlines()[-1].startswith('check ')


def test_no_card_is_refused():
    p = subprocess.run([sys.executable, 'port_bench/run.py', '--workload',
                        CELLS[0], '--seed', '1', '--seconds', '1',
                        '--trace', '0'], cwd=tiny.REPO, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ''
    assert 'no CUDA device' in p.stderr


def test_a_run_without_the_program_fails(tmp_path):
    'A checkout holding only BENCHMARK.json and port_bench cannot run.'
    tiny.make(tmp_path)
    code = ('import sys, time\nsys.path[:0] = [%r]\nimport run\n'
            'a = run.parse(["--workload", %r, "--seed", "1", "--seconds", '
            '"0.2"])\nsys.exit(run.run(a, device="cpu"))\n'
            % (os.path.join(str(tmp_path), 'port_bench'), CELLS[0]))
    p = subprocess.run([sys.executable, '-c', code], cwd=str(tmp_path),
                       capture_output=True, text=True, timeout=300,
                       env={k: v for k, v in os.environ.items()
                            if k != 'PYTHONPATH'})
    assert p.returncode != 0 and p.stdout.strip() == ''


def test_jax_loaded_is_refused(copy):
    rc, out, err = tiny.drive(
        copy, CELLS[0], before='import types\n'
        'sys.modules["jax"] = types.ModuleType("jax")')
    assert rc != 0 and out.strip() == ''
    assert 'jax' in err


def test_the_command_loads_no_jax(copy):
    'Every module of the harness and a whole run: no jax, no zephyr_tpu.'
    script = (
        'import sys, time, glob, os\n'
        'sys.path[:0] = [%r, %r]\n'
        'import run, harness, tracing, control\n'
        'for kind in ("drivers", "metrics", "work", "media"):\n'
        '    for f in glob.glob(os.path.join(harness.HERE, kind, "*.py")):\n'
        '        harness.load_module(kind, os.path.basename(f)[:-3])\n'
        'from reference import blocksolve, modelling, planes, stamps\n'
        'a = run.parse(["--workload", %r, "--seed", "3", "--seconds", '
        '"0.3"])\n'
        'rc = run.run(a, device="cpu", t_start=time.perf_counter())\n'
        'top = {m.split(".")[0] for m in sys.modules}\n'
        'print("LOADED", sorted(top & {"jax", "jaxlib", "flax", '
        '"zephyr_tpu"}), "zephyr_tpu_torch" in top)\n'
        'sys.exit(rc)\n'
        % (os.path.join(copy, 'port_bench'), tiny.REPO, CELLS[-1]))
    rc, out, err = tiny.drive(copy, None, script=script)
    assert rc == 0, err[-3000:]
    line = [ln for ln in out.splitlines() if ln.startswith('LOADED')][0]
    assert line == 'LOADED [] True'


def test_the_reference_imports_nothing_of_the_program():
    script = ('import sys\nsys.path[:0] = [%r]\n'
              'from reference import blocksolve, modelling, planes, stamps\n'
              'print(sorted({m.split(".")[0] for m in sys.modules} & '
              '{"zephyr_tpu_torch", "zephyr_tpu", "jax"}))\n'
              % tiny.BENCH_DIR)
    p = subprocess.run([sys.executable, '-c', script], capture_output=True,
                       text=True, timeout=300)
    assert p.stdout.strip() == '[]', p.stderr


def test_a_cell_and_metrics_are_added_as_files_only(tmp_path):
    '''
    A new configuration, traffic mix, end-to-end and per-layer metric and
    kernel work file, each a new file plus its entry: nothing edited.
    '''
    root = tiny.make(tmp_path)
    pb = os.path.join(root, 'port_bench')
    cfg = json.load(open(os.path.join(pb, 'configs',
                                      'marmousi_acoustic.json')))
    cfg['name'] = 'dummy_acoustic'
    cfg['medium']['params']['seed'] = 8
    json.dump(cfg, open(os.path.join(pb, 'configs', 'dummy_acoustic.json'),
                        'w'))
    traffic = json.load(open(os.path.join(pb, 'traffic',
                                          'marmousi-model-20hz.json')))
    traffic['freq_hz'] = 30.0
    json.dump(traffic, open(os.path.join(pb, 'traffic', 'dummy-30hz.json'),
                            'w'))
    with open(os.path.join(pb, 'metrics', 'batches_done.py'), 'w') as f:
        f.write('def read(record):\n    return len(record["units"])\n')
    with open(os.path.join(pb, 'metrics', 'first_batch_s.py'), 'w') as f:
        f.write('def read(record):\n'
                '    return record["units"][0]["seconds"]\n')
    with open(os.path.join(pb, 'work', 'fused_kernel.py'), 'w') as f:
        f.write('def work(args):\n    return 8, 1\n')
    bench = json.load(open(os.path.join(root, 'BENCHMARK.json')))
    bench['configs'].append({'name': 'dummy_acoustic', 'source': 'test',
                             'file': 'port_bench/configs/dummy_acoustic.json',
                             'reduced': [], 'why': 'test'})
    bench['workloads'].append({'name': 'dummy-30hz',
                               'config': 'dummy_acoustic',
                               'traffic': 'dummy-30hz', 'chips': 1,
                               'why': 'test'})
    bench['end_to_end'].append({'name': 'batches_done', 'unit': 'batches',
                                'better': 'higher', 'bound': 0.1,
                                'source': 'host_clock',
                                'workloads': ['dummy-30hz']})
    bench['per_layer'].append({'name': 'first_batch_s', 'unit': 's',
                               'better': 'lower', 'source': 'host_clock',
                               'layer': 'solver.helmholtz',
                               'moves': 'batches_done'})
    json.dump(bench, open(os.path.join(root, 'BENCHMARK.json'), 'w'))
    rc, out, err = tiny.drive(root, 'dummy-30hz')
    assert rc == 0, err[-3000:]
    res = tiny.result(out)
    assert res['correct'] and set(res['metrics']) == {'batches_done',
                                                      'setup_s'}
    rc, out, err = tiny.drive(root, 'dummy-30hz', trace=1)
    assert rc == 0, err[-3000:]
    assert 'first_batch_s' in tiny.result(out)['metrics']
    script = ('import sys\nsys.path[:0] = [%r]\nimport harness\n'
              'print(harness.load_module("work", "fused_kernel").work(()))\n'
              % pb)
    p = subprocess.run([sys.executable, '-c', script], capture_output=True,
                       text=True, timeout=300)
    assert p.stdout.strip() == '(8, 1)', p.stderr
