'''
The benchmark's files: BENCHMARK.json keeps to its contract, and every
configuration, traffic mix, driver, medium, metric and kernel work file
it names is found by name and loads.
'''

import json
import os
import re
import sys

import pytest

import tiny
from tiny import BENCH_DIR, REPO

sys.path.insert(0, BENCH_DIR)
import harness  # noqa: E402

BENCH = json.load(open(os.path.join(REPO, 'BENCHMARK.json')))
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


def test_top_level_keys_and_command():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert BENCH['paths'] == ['port_bench']
    assert BENCH['command'] == ['python3', 'port_bench/run.py']
    assert 1 <= BENCH['run_seconds'] <= 51
    runs = 2 + 14 * 24
    assert (runs * (BENCH['run_seconds'] + 60) + 24 * 180 + 1200
            <= 43200)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_entries():
    names = []
    for c in BENCH['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert c['file'].startswith('port_bench/configs/')
        names.append(c['name'])
    for w in BENCH['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['chips'] == 1 and len(w['why']) <= 200
        assert w['config'] in names
    cells = [w['name'] for w in BENCH['workloads']]
    e2e = {m['name']: m for m in BENCH['end_to_end']}
    assert 'setup_s' in e2e and e2e['setup_s']['bound'] <= 0.25
    for m in BENCH['end_to_end']:
        assert set(m) <= {'name', 'unit', 'better', 'bound', 'source',
                          'workloads'}
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    for m in BENCH['per_layer']:
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}
        assert m['moves'] in e2e
        assert set(m['workloads']) <= set(
            e2e[m['moves']].get('workloads', cells))
    for m in BENCH['end_to_end'] + BENCH['per_layer']:
        assert NAME.match(m['name']) and UNIT.match(m['unit'])
        assert m['better'] in ('lower', 'higher')
        names.append(m['name'])
    names += cells
    assert len(names) == len(set(names))
    for cell in cells:
        reported = [m for m in BENCH['end_to_end']
                    if cell in m.get('workloads', [cell])]
        assert len(reported) >= 2
        assert any(cell in m['workloads'] for m in BENCH['per_layer'])


@pytest.mark.parametrize('workload', tiny.CELLS)
def test_cell_files_load_by_name(workload):
    bench = tiny.bench()
    entry, config, traffic = harness.cell(bench, workload)
    assert config['name'] == entry['config']
    for key in config['reduced']:
        assert key in config
    assert harness.load_module('media', config['medium']['generator']).make
    driver = harness.load_module('drivers', traffic['driver'])
    assert driver.Cell and driver.control_quantize
    assert set(traffic['limits'])
    for traced in (False, True):
        for m in harness.metrics_of(bench, workload, traced):
            assert callable(harness.load_module('metrics', m['name']).read)


@pytest.mark.parametrize('name', sorted(
    f[:-5] for f in os.listdir(os.path.join(BENCH_DIR, 'configs'))))
def test_every_configuration_makes_its_medium(name):
    'Every configuration file makes its medium.'
    config = json.load(open(os.path.join(BENCH_DIR, 'configs',
                                         name + '.json')))
    assert config['name'] == name
    config['grid'] = {'nz': 64, 'nx': 192}
    c = harness.medium(config)
    assert c.shape == (64, 192) and c.min() > 1000 and c.max() < 5000


#: each kernel's launch arguments (pointers as 1) at R = 16, 256 x 512,
#: in the order of its C signature
LAUNCH_ARGS = {
    'apply_stencil': (1, 1, 1, 16, 256, 512),
    'presmooth_restrict': (1,) * 6 + (16, 256, 512, 2, 16),
    'pcr_sweep': (1, 1, 1, 16, 256, 512, 9, 8, 8, 4, 1, 4),
    'prolong_add_smooth': (1,) * 7 + (16, 256, 512),
    'jacobi_sweep': (1,) * 5 + (16, 256, 512),
    'jacobi_sweep2': (1,) * 5 + (16, 256, 512, 16),
    'jacobi_sweep2_zero': (1, 1, 1, 0, 1, 16, 256, 512, 16),
    'presmooth_residual': (1,) * 6 + (16, 256, 512, 16),
    'restrict': (1, 1, 16, 256, 512),
    'prolong': (1, 1, 16, 128, 256, 256, 512),
    'apply_block_stencil': (1, 1, 1, 16, 256, 512, 16),
}


def test_every_port_kernel_has_a_work_file():
    from zephyr_tpu_torch.ops import cuda_kernels
    assert set(cuda_kernels.LAUNCHES) == set(LAUNCH_ARGS)
    for name, args in LAUNCH_ARGS.items():
        nbytes, flops = harness.load_module('work', name).work(args)
        # at least the R fine fields read or written once
        assert nbytes >= 8 * 16 * 256 * 512
        assert flops > 0


def test_a_missing_file_is_an_error():
    with pytest.raises(FileNotFoundError):
        harness.load_module('work', 'no_such_kernel')


@pytest.mark.parametrize('complete', [[False, True], [False, False],
                                      [True]])
def test_an_incomplete_trace_is_taken_again(monkeypatch, complete):
    'A trace that lacks launches is retraced once; the last one stands.'
    import tracing
    seen = iter(complete)

    def once(run):
        ok = next(seen)
        return run(), {'complete': ok, 'port_kernel_events': 9 + ok,
                       'launches': [('apply_stencil', ())] * 10}

    monkeypatch.setattr(tracing, '_traced_once', once)
    windows = []
    value, out = tracing.traced(lambda: windows.append(1) or len(windows))
    assert out['attempts'] == len(complete) == value == len(windows)
    assert out['complete'] == complete[-1]
