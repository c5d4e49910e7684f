"""call_p90_ms: the 90th percentile of the window's per-call walls (host
clock, each call synchronized), over all calls of the window."""

from perfbench.harness import quantile


def read(run):
    return 1e3 * quantile(run.walls, 0.9)
