'''K1 zt_apply_stencil(planes, u, out, R, nz, nx): A u for R fields.'''


def work(args):
    R, nz, nx = args[3:6]
    N = nz * nx
    return 8 * (9 * N + 2 * R * N), 72 * R * N
