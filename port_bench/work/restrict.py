'''K7 zt_restrict(v, out, R, nz, nx): full-weighting restriction.'''


def work(args):
    R, nz, nx = args[2:5]
    N = nz * nx
    Nc = ((nz + 1) // 2) * ((nx + 1) // 2)
    return 8 * R * (N + Nc), 36 * R * Nc
