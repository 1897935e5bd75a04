'''
Solves that ended at or below tol, over the whole window (host clock,
ended by a device synchronise).
'''


def read(record):
    if 'solves_ok' not in record:
        return None
    return record['solves_ok'] / record['window_s']
