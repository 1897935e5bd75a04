'''
zephyr_tpu_torch utils: profiling, tracing, and checkpoint/resume.
'''

from .profiling import timeIt, count, stats, report, trace, annotate
from .checkpoint import (InversionCheckpointer, save_fullwv_model,
                         latest_fullwv_model)
