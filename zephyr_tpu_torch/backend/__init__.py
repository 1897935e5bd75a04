'''
zephyr_tpu_torch backend: forward-modelling layer, with the public names
of zephyr_tpu.backend that this port carries.
'''

from .base import BaseModelDependent, BaseAnisotropic
from .discretization import BaseDiscretization, DiscretizationWrapper
from .minizephyr import MiniZephyr, MiniZephyrHD
from .eurus import Eurus, EurusHD
from .distributors import (BaseDist, BaseMPDist, BaseIPYDist, MultiFreq,
                           ViscoMultiFreq, SerialMultiFreq,
                           MultiGridMultiFreq, ViscoMultiGridMultiFreq,
                           MultiGridHelper)
from .source import (BaseSource, FakeSource, SimpleSource,
                     StackedSimpleSource, SparseKaiserSource, KaiserSource,
                     AnisotropicKaiserSource, HC_KAISER)
from .analytical import AnalyticalHelmholtz
from .interpolation import (BaseGridInterpolator, SplineGridInterpolator,
                            resample_field)
