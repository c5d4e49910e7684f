"""Reading torch.profiler's raw results: device intervals, busy time, and
the breakdown of device time and idle gaps.

The events come from kineto's raw results (``prof.profiler.kineto_results``)
and not from torch's event tree: building that tree for the ~70,000 device
operations of one replayed Poisson solve takes most of a minute on the
host.  Kineto puts host and device events on one nanosecond clock.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Sequence, Tuple

Event = Tuple[str, int, int]          # name, start ns, end ns

# the benchmark's own span around each traced call
CALL_SPAN = "perfbench.call"
# a breakdown entry's name is cut to this many characters (kernel names of
# templates run to hundreds)
NAME_CHARS = 160


def events(prof) -> Tuple[List[Event], List[Event]]:
    """(device events, host events) of a finished profiler: every device
    activity (kernels, copies, sets; a kernel replayed in a CUDA graph
    counts like one launched alone) and every host event (torch ops, CUDA
    runtime calls, the benchmark's spans)."""
    from torch.autograd import DeviceType
    dev, host = [], []
    raw = list(prof.profiler.kineto_results.events())
    # a host span (record_function) also shows on the device's timeline,
    # as an annotation over the kernels it launched: not a device operation
    spans = {e.name() for e in raw
             if e.device_type() == DeviceType.CPU and e.is_user_annotation()}
    spans.add(CALL_SPAN)
    for e in raw:
        item = (e.name(), e.start_ns(), e.end_ns())
        if e.device_type() == DeviceType.CUDA:
            if e.name() not in spans:
                dev.append(item)
        elif e.device_type() == DeviceType.CPU:
            host.append(item)
    return dev, host


def window(host: Sequence[Event]) -> Tuple[int, int]:
    """The traced window: from the first call span's start to the last
    one's end."""
    spans = [(a, b) for name, a, b in host if name == CALL_SPAN]
    if not spans:
        raise ValueError("the trace holds no call span")
    return min(a for a, _ in spans), max(b for _, b in spans)


def _merged(dev: Sequence[Event], lo: int, hi: int) -> List[Tuple[int, int]]:
    spans = sorted((max(a, lo), min(b, hi)) for _, a, b in dev
                   if b > lo and a < hi)
    out: List[Tuple[int, int]] = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def busy_ns(dev: Sequence[Event], lo: int, hi: int) -> int:
    """The length of the union of the device intervals inside [lo, hi]."""
    return sum(b - a for a, b in _merged(dev, lo, hi))


def idle_gaps(dev: Sequence[Event], lo: int, hi: int
              ) -> List[Tuple[int, int]]:
    """The stretches of [lo, hi] in which no device operation ran."""
    gaps, t = [], lo
    for a, b in _merged(dev, lo, hi):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def _covering(host_sorted: List[Event], starts: List[int], t: int,
              reach: int = 4000) -> str:
    """The innermost (shortest) host event that covers time ``t``; the
    scan goes back at most ``reach`` events from the last one that starts
    before ``t``; the benchmark's call span where none is found."""
    i = bisect.bisect_right(starts, t)
    best, best_len = CALL_SPAN, None
    for j in range(i - 1, max(-1, i - 1 - reach), -1):
        name, a, b = host_sorted[j]
        if b >= t and (best_len is None or b - a < best_len):
            best, best_len = name, b - a
    return best


def breakdown(dev: Sequence[Event], host: Sequence[Event], lo: int, hi: int,
              top: int = 10) -> Dict[str, List[List]]:
    """``device_ops``: the ``top`` device operations by summed seconds in
    the window; ``idle_gaps``: the idle seconds in the window summed by
    the host event that covered each gap's middle (the innermost one: a
    torch op, a CUDA runtime call or a benchmark span), the ``top`` of
    them."""
    by_op: Dict[str, float] = {}
    for name, a, b in dev:
        if b > lo and a < hi:
            by_op[name] = by_op.get(name, 0.0) + (min(b, hi) - max(a, lo)) * 1e-9
    host_sorted = sorted(host, key=lambda e: e[1])
    starts = [e[1] for e in host_sorted]
    by_host: Dict[str, float] = {}
    for a, b in idle_gaps(dev, lo, hi):
        name = _covering(host_sorted, starts, (a + b) // 2)
        by_host[name] = by_host.get(name, 0.0) + (b - a) * 1e-9
    rank = lambda d: [[k[:NAME_CHARS], v] for k, v in
                      sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(by_op), "idle_gaps": rank(by_host)}
