"""Misc runtime layer: RNG, logging, file I/O, histograms, perf counters.

Mirrors the role of the reference's ``xerus::misc`` namespace
(include/xerus/misc/*.h) with host-side Python equivalents, as
``xerus_tpu.misc`` does; the profiling hook and the finiteness guard work
on torch.
"""

from .random import randomEngine, set_seed, normal, uniform  # noqa: F401
from .io import FileFormat, save_to_file, load_from_file  # noqa: F401
from .histogram import LogHistogram  # noqa: F401
from .log import (get_logger, set_log_level, enable_log_on_error,
                  RingBufferHandler)  # noqa: F401
from .performance import pa_start, pa_section, get_analysis, clear_analysis  # noqa: F401
from .profiling import profile_trace  # noqa: F401
from .log import log  # noqa: F401
from .numerics import (integrate, integrate_segmented,  # noqa: F401
                       find_root_bisection, Polynomial,
                       ShanksTransformation, RichardsonExtrapolation)


def xethrow():
    """Raise a generic library error (python/misc.cpp:121 `xethrow` test
    helper; the Python traceback plays the role of get_call_stack)."""
    raise ValueError("xerus_tpu_torch generic error (xethrow)")
