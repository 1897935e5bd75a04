'''K6 zt_jacobi_sweep2(planes, D, b, u, out, R, nz, nx, g): two sweeps from u.'''


def work(args):
    R, nz, nx = args[5:8]
    N = nz * nx
    return 8 * (10 * N + 3 * R * N), 164 * R * N
