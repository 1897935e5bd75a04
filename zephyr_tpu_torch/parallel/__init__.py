'''
zephyr_tpu_torch parallel: multi-frequency FWI on one device (the
chunked adjoint-state gradient routine and its grid plan).
'''

from .multifreq import (viscous_velocity, freq_grid_plan,
                        fwi_misfit_grad_chunked)
