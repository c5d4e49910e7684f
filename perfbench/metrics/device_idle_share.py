"""device_idle_share: 1 - (the union of the device operations' intervals)
/ (the traced calls' wall), from the profiler's trace of one card."""


def read(run):
    if not run.device_events or not run.trace_window_s:
        return None
    return 1.0 - run.busy_s / run.trace_window_s
