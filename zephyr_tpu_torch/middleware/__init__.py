'''
zephyr_tpu_torch middleware: the inverse-problem layer, with the public
names of zephyr_tpu.middleware: surveys, the 2D and 2.5D problems, the
inversion drivers and the host-side I/O helpers.
'''

from .problem import (HelmBaseProblem, Helm2DProblem, Helm2DViscoProblem,
                      Helm2DViscoMultiGridProblem, Helm25DProblem,
                      Helm25DViscoProblem)
from .survey import (HelmBaseSurvey, Helm2DSurvey, Helm2DMultiGridSurvey,
                     Helm25DSurvey, Helm25DMultiGridSurvey, HelmSrc,
                     HelmRx, HelmMultiGridSurvey)
from .fields import HelmFields
from .maps import IdentityMap, NodalIdentityMap, SquaredSlownessMap
from .regularization import (BaseRegularization, HelmBaseRegularization,
                             SmoothRegularization)
from .optimization import (Minimize, GradientDescent, ProjectedGradient,
                           LBFGS)
from .inversion import (l2_DataMisfit, BaseInvProblem, BaseInversion,
                        FrequencyContinuation)
from .mesh import TensorMesh2D
from .time import (dwavelet, dftreal, idftreal, BaseTimeSensitive,
                   TimeMachine)
from .util import readini, str2bool, compileDict
from .segy import SEGYFile, writeSEGY
from .db import (UtoutWriter, utoutRead, BaseDatastore, FullwvDatastore,
                 FlatDatastore, PickleDatastore, HDF5Datastore, ftypeRegex)
