'''The traced window's milliseconds over its outer iterations.'''


def read(record):
    if 'solves_ok' not in record or 'profile' not in record:
        return None
    iters = sum(u['iters'] for u in record['units'])
    return 1e3 * record['profile']['window_s'] / iters if iters else None
