"""stragglers_pct.bake: the share of the two-pass trace's pass-1 rays
that pass 2 re-traces, in %: 100 x the program's counter
`twopass.rays.stragglers` / `twopass.rays.pass1` (host values, counted
only while a profiler records: the traced window's batches)."""

from port_bench import program

UNIT = "%"
MOVES = "bake_mrays_per_s"


def read(r):
    c = program.counters() if r.kind == "bake" else None
    if not c or c.get("twopass.rays.pass1", 0) <= 0:
        return None
    return 100.0 * c.get("twopass.rays.stragglers", 0) / c[
        "twopass.rays.pass1"]
