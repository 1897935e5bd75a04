'''
What every cell of the benchmark shares: finding a cell's files by the
names in BENCHMARK.json, the checks that the run used the card and none
of the JAX package, the device readings, and the result line.

A cell is found so: its entry in BENCHMARK.json names a configuration
(``configs/<config>.json``, whose ``medium.generator`` names
``media/<generator>.py``) and a traffic mix (``traffic/<traffic>.json``,
whose ``driver`` names ``drivers/<driver>.py``). Each metric is computed
by ``metrics/<metric name>.py``, and each CUDA kernel's work by
``work/<kernel name>.py``. Adding a cell, a metric or a kernel is adding
files and entries; nothing here names one.
'''

import importlib.util
import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: modules that may not be loaded in a run (compared by whole top-level
#: name: the port's own name begins with the JAX package's)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'zephyr_tpu')


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark():
    return load_json(os.path.join(ROOT, 'BENCHMARK.json'))


def load_module(kind, name):
    '''The module ``<kind>/<name>.py`` of the benchmark (by file path).'''
    path = os.path.join(HERE, kind, name + '.py')
    if not os.path.exists(path):
        raise FileNotFoundError('port_bench: no %s/%s.py' % (kind, name))
    spec = importlib.util.spec_from_file_location(
        'port_bench_%s_%s' % (kind, name.replace('.', '_').replace('-', '_')),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(bench, workload):
    '''(workload entry, configuration dict, traffic dict) of a cell.'''
    for w in bench['workloads']:
        if w['name'] == workload:
            break
    else:
        raise KeyError('port_bench: no workload %r in BENCHMARK.json'
                       % workload)
    for c in bench['configs']:
        if c['name'] == w['config']:
            break
    else:
        raise KeyError('port_bench: no configuration %r' % w['config'])
    config = load_json(os.path.join(ROOT, c['file']))
    traffic = load_json(os.path.join(HERE, 'traffic', w['traffic'] + '.json'))
    return w, config, traffic


def metrics_of(bench, workload, traced):
    '''
    The metric entries a run of ``workload`` reports: its end-to-end
    metrics untraced, its per-layer metrics traced. An entry with a
    ``workloads`` list applies to those cells; one without applies to
    every cell (an end-to-end metric), or to every cell that reports the
    metric it moves (a per-layer metric).
    '''
    def applies(m):
        return workload in m.get('workloads', [workload])

    e2e = [m for m in bench['end_to_end'] if applies(m)]
    if not traced:
        return e2e
    names = {m['name'] for m in e2e}
    return [m for m in bench['per_layer']
            if applies(m) and ('workloads' in m or m['moves'] in names)]


def line(spec):
    '(n, 2) grid-unit (x, z) positions of a line of shots or receivers.'
    import numpy as np
    x = spec['x0_cells'] + spec['dx_cells'] * np.arange(spec['count'])
    return np.stack([x, np.full(len(x), float(spec['z_cells']))], axis=1)


def medium(config):
    '''
    The (nz, nx) float32 velocity of a configuration: the same for every
    run (its small-scale detail is drawn from the configuration's own
    ``seed``): a seeded medium changes the work (PERF.md §2).
    '''
    g = config['grid']
    gen = load_module('media', config['medium']['generator'])
    return gen.make(g['nz'], g['nx'], config['spacing_m'],
                    **config['medium']['params'])


def sync(device):
    'Wait for the device (a no-op on the CPU).'
    if str(device) != 'cpu':
        import torch
        torch.cuda.synchronize()


def forbidden_modules():
    return sorted({name.split('.')[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line():
    'nvidia-smi name, power limit (or what went wrong).'
    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return 'nvidia-smi unavailable (%s)' % e


def finite(x):
    return x is not None and math.isfinite(x)


def result_line(correct, attempted, failed, metrics, device, checks,
                breakdown=None):
    '''
    The run's last stdout line. ``checks`` ({name: (value, limit)}) is
    the last key, and is also printed as the last lines of stderr.
    '''
    out = {'correct': bool(correct), 'attempted': int(attempted),
           'failed': int(failed), 'metrics': metrics, 'device': device}
    if breakdown is not None:
        out['breakdown'] = breakdown
    out['checks'] = {k: {'value': v, 'limit': lim}
                     for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print('check %s %r limit %r' % (k, v, lim), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
