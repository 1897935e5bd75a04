'''
The port's CUDA kernels' share of their roofline, in percent: the sum
over every launch in the traced window of its least time (the larger of
its bytes over the device's bandwidth and its float32 operations over
the device's rate, peaks.json), over those launches' device time. Each
launch's work comes from ``work/<kernel>.py`` and the launch's shapes; a
kernel with no such file stops the run.
'''

import json
import os

import harness


def read(record):
    prof = record.get('profile')
    if 'solves_ok' not in record or not prof or not prof['launches']:
        return None
    if prof['port_kernel_events'] != len(prof['launches']):
        raise RuntimeError('kernel_roofline: %d launches recorded, %d in '
                           'the trace' % (len(prof['launches']),
                                          prof['port_kernel_events']))
    with open(os.path.join(harness.HERE, 'peaks.json')) as f:
        peaks = json.load(f)
    fns = {}
    least = 0.0
    for name, args in prof['launches']:
        if name not in fns:
            fns[name] = harness.load_module('work', name).work
        nbytes, flops = fns[name](args)
        least += max(nbytes / peaks['device_bytes_per_s'],
                     flops / peaks['f32_flops_per_s'])
    return 100.0 * least / prof['port_kernel_s']
