'''
The plain reference against the program at small sizes (this test may
import both; the reference imports nothing of the program): the operator,
the Kaiser stamps and the direct solve, and the receiver data of
forward modelling against the program's chunked solve.
'''

import sys

import numpy as np
import pytest
import torch

from tiny import BENCH_DIR

sys.path.insert(0, BENCH_DIR)
from reference import blocksolve, modelling, planes, stamps  # noqa

from zephyr_tpu_torch.ops.minizephyr_coeff import minizephyr_planes  # noqa
from zephyr_tpu_torch.parallel.multifreq import _kaiser_stamps  # noqa
from zephyr_tpu_torch.solver.helmholtz import SolverConfig  # noqa

RNG = np.random.default_rng(5)
C = 1500.0 + 800.0 * RNG.random((40, 72))


@pytest.mark.parametrize('dx,dz', [(1.0, 1.0), (2.5, 1.5)])
def test_planes_match_the_program(dx, dz):
    P = planes.helmholtz_planes(torch.tensor(C), 30.0, dx, dz)
    Q = minizephyr_planes(torch.tensor(C).to(torch.complex128),
                          torch.ones(C.shape, dtype=torch.float64), 30.0,
                          dx=dx, dz=dz)
    assert float((P - Q).abs().max() / Q.abs().max()) < 1e-14


@pytest.mark.parametrize('receiver', [False, True])
def test_stamps_match_the_program(receiver):
    pos = np.array([[12.25, 14.0], [30.5, 14.0], [3.0, 5.0],
                    [50.75, 20.5], [70.5, 38.5]])
    for h in (1.0, 1.8):
        i1, v1 = stamps.stamps(C.shape, h, h, pos, 4, receiver=receiver)
        i2, v2 = _kaiser_stamps(C.shape, h, h, pos, 4, receiver=receiver)
        d1 = stamps.dense(C.shape, i1, v1)
        d2 = stamps.dense(C.shape, i2.astype(np.int64), v2)
        assert np.abs(d1 - d2).max() < 1e-14


def test_direct_solve_and_transpose():
    P = planes.helmholtz_planes(torch.tensor(C), 150.0 / 8)
    pos = np.array([[20.0, 14.0], [44.5, 20.0]])
    b = torch.tensor(stamps.dense(C.shape, *stamps.stamps(C.shape, 1.0, 1.0,
                                                           pos)))
    x = blocksolve.solve(P, b)
    assert float((planes.apply(P, x) - b).norm() / b.norm()) < 1e-12
    u = torch.randn(2, *C.shape, dtype=torch.complex128)
    v = torch.randn(2, *C.shape, dtype=torch.complex128)
    lhs = (v * planes.apply(P, u)).sum()
    rhs = (u * planes.apply(planes.transpose(P), v)).sum()
    assert float(abs(lhs - rhs) / abs(lhs)) < 1e-12




def test_modelling_matches_the_program():
    'Receiver data of shots between nodes: the direct solve and the port.'
    from zephyr_tpu_torch.ops.kaiser import extract, inject
    from zephyr_tpu_torch.ops.minizephyr_coeff import minizephyr_planes
    from zephyr_tpu_torch.solver.helmholtz import (make_chunked_solver,
                                                   prepare_operator,
                                                   resolve_panels,
                                                   resolve_solver_config,
                                                   shifted_velocity)
    import harness
    drv = harness.load_module('drivers', 'model_batches')
    freq = 150.0 / 8
    src = np.array([[20.3, 14.0], [44.71, 16.0], [57.5, 14.0]])
    rec = np.stack([np.arange(14.0, 60.0, 4.5), np.full(11, 14.0)], 1)
    cfg = resolve_panels(resolve_solver_config(
        {'tol': 1e-11, 'maxiter': 2000, 'mg_coarse': 'inv',
         'mg_min_size': 8}, torch.complex128), C)
    c = torch.tensor(C).to(torch.complex128)
    rho = torch.ones(C.shape, dtype=torch.float64)
    P = minizephyr_planes(c, rho, freq)[None, None]
    PP = minizephyr_planes(shifted_velocity(c, cfg.shift), rho, freq,
                           pml_cap=cfg.pml_cap)[None, None]
    op = prepare_operator(P, PP, cfg, with_transpose=False)
    scols, svals = drv.stamps(C.shape, src, 4, 'cpu')
    rcols, rvals = drv.stamps(C.shape, rec, 4, 'cpu', receiver=True)
    b = inject(scols, svals.to(torch.complex128), *C.shape)[:, None]
    x, _, relres = make_chunked_solver(cfg, chunk=64)(op, b)
    assert relres <= 1e-11
    got = extract(torch.conj(x[:, 0]), rcols,
                  rvals.to(torch.complex128)).numpy()
    ref, worst = modelling.receiver_data(C, freq, src, rec)
    assert worst < 1e-12
    # model_batches builds its stamps in complex64: agreement to their rounding
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-6
