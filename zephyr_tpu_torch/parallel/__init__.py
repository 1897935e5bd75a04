'''
zephyr_tpu_torch parallel: multi-frequency modelling and FWI on one
device (the per-frequency operators and solves, the differentiable
forward map and misfit, the chunked and 2.5D forward modelling, the
chunked adjoint-state gradient and its grid plan). The device-mesh
pieces of zephyr_tpu.parallel (``make_sharded_fwi_step``,
``split_premul``, the mesh and the spatial decomposition) are not ported
yet: ROADMAP Queue 1, item 15.
'''

from .multifreq import (viscous_velocity, build_multifreq_ops,
                        multifreq_solve, multifreq_dpred,
                        multifreq_dpred_25d, multifreq_dpred_chunked,
                        fwi_misfit, ky_summed_fields, freq_grid_plan,
                        fwi_misfit_grad_chunked)
