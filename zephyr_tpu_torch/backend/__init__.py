'''
zephyr_tpu_torch backend: forward-modelling layer, with the public names
of zephyr_tpu.backend that this port carries.
'''

from .base import BaseModelDependent, BaseAnisotropic
from .discretization import BaseDiscretization
from .minizephyr import MiniZephyr, MiniZephyrHD
from .eurus import Eurus, EurusHD
from .source import (BaseSource, SimpleSource, StackedSimpleSource,
                     SparseKaiserSource, AnisotropicKaiserSource, HC_KAISER)
from .analytical import AnalyticalHelmholtz
from .interpolation import (BaseGridInterpolator, SplineGridInterpolator,
                            resample_field)
