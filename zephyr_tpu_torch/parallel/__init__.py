'''
zephyr_tpu_torch parallel: device-mesh sharding of the modelling and
inversion axes (the port of zephyr_tpu.parallel).

- ``multifreq``: multi-frequency modelling and FWI on one device (the
  per-frequency operators and solves, the differentiable forward map and
  misfit, the chunked and 2.5D forward modelling, the chunked
  adjoint-state gradient and its grid plan) and ``make_sharded_fwi_step``,
  the FWI step over a ('freq', 'src') or ('host', 'freq', 'src') mesh;
- ``mesh``: the device meshes (virtual meshes that repeat one device,
  and multi-process meshes over ``torch.distributed``);
- ``spatial``: spatial domain decomposition with halo exchange (the DD
  solve and forward modelling over x slabs or (z, x) tiles).

``split_premul`` is not ported: it only feeds ``core/realio.py``, which
works around a TPU runtime's missing complex transfer (ROADMAP Queue 3).
'''

from .mesh import make_mesh, freq_src_sharding, replicated
from .multifreq import (viscous_velocity, build_multifreq_ops,
                        multifreq_solve, multifreq_dpred,
                        multifreq_dpred_25d, multifreq_dpred_chunked,
                        fwi_misfit, ky_summed_fields, freq_grid_plan,
                        fwi_misfit_grad_chunked,
                        make_sharded_fwi_step)
from .spatial import (halo_exchange_x, apply_stencil_sharded,
                      make_sharded_apply, make_dd_solver)
