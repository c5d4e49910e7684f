"""Per-iteration solver tracing.

The port's own copy of ``xerus_tpu/algorithms/performance_data.py``,
which has no JAX in it.  Re-design of xerus::PerformanceData (include/xerus/performanceData.h:43-157,
src/xerus/performanceData.cpp): data points carry (iteration, elapsed time,
residual, error, ranks, flags); residual evaluation can be excluded from the
clock via stop/continue (used by check_for_end_of_sweep, als.cpp:440-442).
"""

from __future__ import annotations

import math
import time
from typing import Callable, List, Optional

from ..misc.histogram import LogHistogram


class DataPoint:
    __slots__ = ("iteration", "elapsed_time", "residual", "error", "ranks", "flags")

    def __init__(self, iteration, elapsed_time, residual, error, ranks, flags):
        self.iteration = iteration
        self.elapsed_time = elapsed_time
        self.residual = residual
        self.error = error
        self.ranks = ranks
        self.flags = flags

    @property
    def iterationCount(self):
        """Reference field name (performanceData.h:46)."""
        return self.iteration

    @property
    def elapsedTime(self):
        """Reference field name (performanceData.h:47)."""
        return self.elapsed_time


class PerformanceData:
    def __init__(self, active: bool = True, print_progress: bool = False,
                 error_function: Optional[Callable] = None,
                 checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = 1):
        self.active = active
        self.print_progress = print_progress
        self.error_function = error_function
        self.data: List[DataPoint] = []
        self.start_time = None
        self._stop_time = None
        self.additional_information = ""
        # solver checkpointing (new design; the reference only has generic
        # object persistence, SURVEY.md §5.4): every `checkpoint_every`
        # recorded points, the current iterate is saved to checkpoint_path.
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = max(int(checkpoint_every), 1)

    def __bool__(self) -> bool:
        return self.active

    @property
    def errorFunction(self) -> Optional[Callable]:
        """Reference binding name (python/leastSquares.cpp:41-46): the
        per-datapoint error callback ``f(x) -> float``."""
        return self.error_function

    @errorFunction.setter
    def errorFunction(self, f: Optional[Callable]) -> None:
        self.error_function = f

    def __lshift__(self, text) -> "PerformanceData":
        """Append free-form text to the header block (the reference's
        ``perfData << "..."`` stream syntax, performanceData.h)."""
        if self.active:
            self.additional_information += str(text)
        return self

    def start(self) -> None:
        self.start_time = time.perf_counter()
        self.data = []

    def stop_timer(self) -> None:
        self._stop_time = time.perf_counter()

    def continue_timer(self) -> None:
        if self._stop_time is not None and self.start_time is not None:
            self.start_time += time.perf_counter() - self._stop_time
        self._stop_time = None

    def get_elapsed_time(self) -> float:
        if self.start_time is None:
            return 0.0
        return time.perf_counter() - self.start_time

    def get_runtime(self) -> float:
        """Wall time since start(); frozen while the timer is stopped
        (performanceData.h:119-125)."""
        if self.start_time is None:
            return 0.0
        if self._stop_time is not None:
            return self._stop_time - self.start_time
        return time.perf_counter() - self.start_time

    def reset(self) -> None:
        """Clear recorded points and timers (performanceData.h:90-96)."""
        self.data = []
        self.start_time = None
        self._stop_time = None
        self.additional_information = ""

    def add(self, residual: float, x=None, flags: int = 0,
            iteration: Optional[int] = None) -> None:
        if not self.active:
            return
        if self.start_time is None:
            self.start()
        error = self.error_function(x) if (self.error_function and x is not None) else 0.0
        ranks = list(x.ranks()) if (x is not None and hasattr(x, "ranks")) else []
        it = iteration if iteration is not None else (
            self.data[-1].iteration + 1 if self.data else 0)
        self.data.append(DataPoint(it, self.get_elapsed_time(), float(residual),
                                   float(error), ranks, flags))
        if self.print_progress:
            print(f"[perf] iter {it}: residual {residual:.3e} ranks {ranks}")
        if (self.checkpoint_path and x is not None
                and len(self.data) % self.checkpoint_every == 0):
            try:
                from ..misc.io import save_to_file
                self.stop_timer()
                save_to_file(x, self.checkpoint_path)
                self.continue_timer()
            except Exception:
                pass  # checkpointing must never kill a solve

    def dump_to_file(self, path: str) -> None:
        with open(path, "w") as f:
            f.write("# iteration\ttime\tresidual\terror\tflags\tranks\n")
            if self.additional_information:
                for line in self.additional_information.splitlines():
                    f.write(f"# {line}\n")
            for p in self.data:
                f.write(f"{p.iteration}\t{p.elapsed_time}\t{p.residual}\t"
                        f"{p.error}\t{p.flags}\t{','.join(map(str, p.ranks))}\n")

    def get_histogram(self, base: float,
                      assume_convergence: bool = False) -> LogHistogram:
        """Convergence-rate histogram (performanceData.cpp:110-140): model
        each step as ``x2 = x1 * 2^(-rate * dt_us)`` and bucket the decay
        rate, weighted by the step's duration.  ``assume_convergence``
        measures residuals relative to the final one (and drops the final
        point), as the reference does for its benchmark histograms."""
        hist = LogHistogram(base)
        points = [(p.elapsed_time, p.residual) for p in self.data]
        if assume_convergence and points:
            final = points[-1][1]
            points = [(t, r - final) for t, r in points[:-1]]
        for (t0, r0), (t1, r1) in zip(points, points[1:]):
            if r0 <= 0 or r1 <= 0 or r1 >= r0:
                continue
            exponent = math.log2(r1 / r0)
            # microsecond resolution like the reference; 0us -> 1us
            delta_t = max(int(round((t1 - t0) * 1e6)), 1)
            rate = -exponent / delta_t
            if math.isfinite(rate) and rate > 0:
                hist.add(rate, delta_t)
        return hist


NoPerfData = PerformanceData(active=False)
