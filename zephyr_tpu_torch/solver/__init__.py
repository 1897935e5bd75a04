'''
zephyr_tpu_torch solver: the hybrid (stratified PCR + multigrid)
preconditioned BiCGStab Helmholtz solve, differentiable through its
implicit adjoint.
'''

from .helmholtz import (SolverConfig, HelmholtzOperator, check_config,
                        prepare_operator, resolve_solver_config,
                        resolve_panels, shifted_velocity, solve,
                        solve_batched, solve_info, make_chunked_solver)
from .krylov import bicgstab
from .multigrid import build_hierarchy, transpose_hierarchy, v_cycle
