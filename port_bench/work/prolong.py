'''K7 zt_prolong(vc, out, R, nzc, nxc, nz, nx): bilinear prolongation.'''


def work(args):
    R, nzc, nxc, nz, nx = args[2:7]
    N = nz * nx
    Nc = nzc * nxc
    return 8 * R * (Nc + N), 16 * R * N
