"""idle_pct.bake: share of the traced window in which no operation ran
on the device, from the profiler's timeline."""

UNIT = "%"
MOVES = "bake_mrays_per_s"


def read(r):
    if r.kind != "bake" or r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
