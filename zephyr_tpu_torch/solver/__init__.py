'''
zephyr_tpu_torch solver: the hybrid (stratified PCR + multigrid)
preconditioned BiCGStab Helmholtz solve, differentiable through its
implicit adjoint.
'''

from .helmholtz import (SolverConfig, HelmholtzOperator, check_config,
                        prepare_operator, resolve_solver_config,
                        resolve_panels, shifted_velocity, solve,
                        solve_batched, solve_batched_jit, solve_info,
                        make_chunked_solver)
from .krylov import (bicgstab, bicgstab_batched, bicgstab_fixed, gmres,
                     gmres_cycle)
from .multigrid import build_hierarchy, transpose_hierarchy, v_cycle
