'''K5 zt_jacobi_sweep(planes, D, b, u, out, R, nz, nx): one sweep.'''


def work(args):
    R, nz, nx = args[5:8]
    N = nz * nx
    return 8 * (10 * N + 3 * R * N), 82 * R * N
