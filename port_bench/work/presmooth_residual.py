'''
K9 zt_presmooth_residual(planes, D, mask, b, u, res, R, nz, nx, g): two
sweeps from zero and the masked residual.
'''


def work(args):
    R, nz, nx = args[6:9]
    N = nz * nx
    return 8 * (10 * N + 3 * R * N) + 4 * N, 164 * R * N
