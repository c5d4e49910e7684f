"""On-device kernel profiling hook.

The reference's XERUS_PERFORMANCE_ANALYSIS macros time host kernel calls
(misc/performanceAnalysis.h:31-38); on the card the equivalent is a
torch.profiler trace (Chrome trace format, viewable in Perfetto)."""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Context manager: profiles the CPU and, with a card, all device work
    in the block; writes ``log_dir/trace.json`` and yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def guard_finite(array_like, context: str = "") -> None:
    """Raise if the tensor contains NaN/Inf (failure-detection guard,
    enabled via config.nan_checks).  Takes a Tensor, a torch tensor or an
    array."""
    from ..config import config
    if not config.nan_checks:
        return
    import torch
    arr = array_like._torch() if hasattr(array_like, "_torch") \
        else torch.as_tensor(array_like)
    if not bool(torch.isfinite(arr).all()):
        raise FloatingPointError(
            f"non-finite values detected{': ' + context if context else ''}")
