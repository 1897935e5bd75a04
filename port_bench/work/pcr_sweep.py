'''
K3 zt_pcr_sweep(packed, b, out, R, nz, nx, nsteps, levels, k, g, w, cb):
the PCR sweep of R batches of nx columns of depth nz, bf16 factors.
'''


def work(args):
    R, nz, nx, nsteps = args[3:7]
    N = nz * nx
    return 8 * nsteps * N + 4 * N + 16 * R * N, R * N * (16 * nsteps + 6)
