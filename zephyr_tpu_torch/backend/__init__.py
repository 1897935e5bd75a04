'''
zephyr_tpu_torch backend: forward-modelling layer, with the public names
of zephyr_tpu.backend that this port carries.
'''

from .base import BaseModelDependent
from .discretization import BaseDiscretization
from .minizephyr import MiniZephyr, MiniZephyrHD
from .source import (BaseSource, SimpleSource, StackedSimpleSource,
                     SparseKaiserSource, HC_KAISER)
from .analytical import AnalyticalHelmholtz
from .interpolation import (BaseGridInterpolator, SplineGridInterpolator,
                            resample_field)
