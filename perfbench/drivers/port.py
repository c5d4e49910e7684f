"""What every driver takes from the port: its counters by name, the scope
its objects compute in, and the freeing of its programs' state.

The names are those the port gives its counters: the registered ones of
``ops/programs.py`` (``programs.counter_values()``), ``Program.eager_runs``
/ ``captures`` / ``replays``, and the counters the port keeps on its
functions.  A driver adds the counts its entry returns under names of its
own.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch


def counters() -> Dict[str, float]:
    from xerus_tpu_torch.ops import df_loops, df_matvec, gemm_exact, programs
    from xerus_tpu_torch.ops import round_kernels as rk
    out = dict(programs.counter_values())
    P = programs.Program
    out.update({
        "Program.eager_runs": P.eager_runs,
        "Program.captures": P.captures,
        "Program.replays": P.replays,
        "host_bool.reads": rk.host_bool.reads,
        "df_matvec.launches": df_matvec.df_matvec.launches,
        "df_qr_launch.launches": df_loops.df_qr_launch.launches,
        "gemm_exact_kernel.launches": gemm_exact.gemm_exact_kernel.launches,
    })
    for name in gemm_exact.TRUNC_COUNTERS:
        out[f"trunc_step_gemm_exact.{name}"] = getattr(
            gemm_exact.trunc_step_gemm_exact, name)
    return out


@contextlib.contextmanager
def scope(device: torch.device, dtype: str = "float64"):
    """The port's objects in ``dtype`` (its value dtype), computing on
    ``device``: the card, or the CPU through ``xt.host()``."""
    import xerus_tpu_torch as xt
    saved = xt.value_dtype()
    xt.set_value_dtype(np.dtype(dtype))
    try:
        with (xt.host() if device.type == "cpu" else contextlib.nullcontext()):
            yield
    finally:
        xt.set_value_dtype(saved)


def free() -> None:
    """Drop every captured program and its memory pool."""
    from xerus_tpu_torch.ops import programs
    programs.clear()


def host_cores(cores):
    """Host numpy copies of device cores, for the port's converters."""
    return [c.detach().cpu().numpy() for c in cores]
