'''K8 zt_apply_block_stencil(planes, u, out, R, nz, nx, g): 2x2 block A u.'''


def work(args):
    R, nz, nx = args[3:6]
    N = nz * nx
    return 8 * (36 * N + 4 * R * N), 292 * R * N
