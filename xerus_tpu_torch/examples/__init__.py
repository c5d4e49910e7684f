from .generators import (laplace_operator, poisson_rhs, peaking_diagonals,
                         random_low_rank, heisenberg_mpo)
from .completion import (inverse_index_norm, inverse_index_ratio,
                         completion_instance, full_grid_positions,
                         host_full_tensor, workload5_instance)
from .poisson import qtt_poisson_instance, host_poisson_residual
from .rounding import (bench_round_instance, cliff_instance, cpu_round_sweep,
                       host_tt_distance, host_tt_log_norm)
from . import cascade
