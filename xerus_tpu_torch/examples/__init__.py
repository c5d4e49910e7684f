from .poisson import qtt_poisson_instance, host_poisson_residual
from .rounding import (bench_round_instance, cliff_instance, cpu_round_sweep,
                       host_tt_distance, host_tt_log_norm)
