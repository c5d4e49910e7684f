"""replayed_share: of the port's program runs in the window (ops/programs.py
``Program``: eager runs, captures, replays), the share that were replays."""


def read(run):
    c = run.counters
    runs = (c.get("Program.replays", 0) + c.get("Program.eager_runs", 0)
            + c.get("Program.captures", 0))
    return c["Program.replays"] / runs if runs else None
