'''
zephyr_tpu_torch frontend: the job classes and the command-line
interface (``zephyr-tpu-torch``), with the public names of
zephyr_tpu.frontend.
'''

from . import jobs
from .jobs import (Job, ForwardModelingJob, InversionJob, Visco2DJob,
                   IsotropicVisco2DJob, AnisotropicVisco2DJob, IniInputJob,
                   PythonInputJob, PickleInputJob, UtoutOutputJob,
                   PickleOutputJob, OmegaIOJob, OmegaJob, PythonUtoutJob,
                   AnisoOmegaJob, AnisoPythonUtoutJob, OmegaInversionJob,
                   MigrationJob, OmegaMigrationJob)
