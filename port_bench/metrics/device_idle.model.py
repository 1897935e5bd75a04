'''
Percent of the traced window in which no operation ran on the device
(1 - the union of device activity over the window).
'''


def read(record):
    prof = record.get('profile')
    if 'solves_ok' not in record or not prof:
        return None
    return 100.0 * (1.0 - prof['busy_s'] / prof['trace_window_s'])
