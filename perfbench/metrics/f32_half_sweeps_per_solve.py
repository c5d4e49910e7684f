"""f32_half_sweeps_per_solve: the float32 half-sweeps of each solve (the
length of the history ``als_spd_fused`` returns), over the window's
solves."""


def read(run):
    n = run.counters.get("f32_half_sweeps")
    return n / run.calls if n is not None and run.calls else None
