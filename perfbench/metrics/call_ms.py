"""call_ms: the window's wall time over the calls completed in it, host
clock; each call ends synchronized with its result on the device."""


def read(run):
    return 1e3 * run.window_s / run.calls
