'''
K6 zt_jacobi_sweep2(planes, D, b, NULL, out, R, nz, nx, g): two sweeps
from zero (D b, then one sweep).
'''


def work(args):
    R, nz, nx = args[5:8]
    N = nz * nx
    return 8 * (10 * N + 2 * R * N), 88 * R * N
