'''
Device milliseconds an outer iteration in kernels that are neither the
port's CUDA kernels nor cuFFT's: the eager torch vector algebra
(elementwise, reductions, copies) around them.
'''


def read(record):
    if 'solves_ok' not in record or 'profile' not in record:
        return None
    iters = sum(u['iters'] for u in record['units'])
    return 1e3 * record['profile']['algebra_s'] / iters if iters else None
