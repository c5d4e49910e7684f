"""The roofline of one kernel from the device trace: the least time the
card could take for the work the inputs need, counted from shapes, over
the kernel's device time found by name.

The least time of one piece of work is the larger of its bytes (each
input byte read once, each output byte written once) over the card's
memory bandwidth and its operations over the peak rate of its type, both
from ``peaks.json`` (the data sheet's).
"""

from __future__ import annotations

import json
import os
from typing import Optional

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "peaks.json")) as _fh:
    PEAKS = json.load(_fh)


def least_s(nbytes: float, flops: float, rate: str) -> float:
    return max(nbytes / PEAKS["hbm_bytes_per_s"],
               flops / PEAKS["flops_per_s"][rate])


def kernel_time(run, name_part: str):
    """(launches, device seconds) of the traced device operations whose
    name holds ``name_part``."""
    hits = [(a, b) for name, a, b in run.device_events if name_part in name]
    return len(hits), sum(b - a for a, b in hits) * 1e-9


def share(least: float, spent: float) -> Optional[float]:
    """The roofline share in percent, or None where no time was spent."""
    return 100.0 * least / spent if spent > 0 else None
