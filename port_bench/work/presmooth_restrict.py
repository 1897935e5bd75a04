'''
K2 zt_presmooth_restrict(planes, D, mask, b, u, rc, R, nz, nx, nsweeps,
g): damped-Jacobi sweeps from zero, the masked residual, restricted.
'''


def work(args):
    R, nz, nx, nsweeps = args[6:10]
    N = nz * nx
    Nc = ((nz + 1) // 2) * ((nx + 1) // 2)
    return (8 * (10 * N + 2 * R * N + R * Nc) + 4 * N,
            R * (82 * nsweeps * N + 36 * Nc))
