'''
K4 zt_prolong_add_smooth(planes, D, mask, b, u, ec, out, R, nz, nx):
prolong the coarse correction, add it, one damped-Jacobi sweep.
'''


def work(args):
    R, nz, nx = args[7:10]
    N = nz * nx
    Nc = ((nz + 1) // 2) * ((nx + 1) // 2)
    return 8 * (10 * N + 3 * R * N + R * Nc) + 4 * N, 102 * R * N
