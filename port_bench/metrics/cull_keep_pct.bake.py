"""cull_keep_pct.bake: the share of (exit group, cluster) pairs that the
cull keeps as candidates for the walk, in %: 100 x the program's counter
`cull.candidates` / `cull.pairs`, both counted by cull_blocks while a
profiler records (the traced window)."""

from port_bench import program

UNIT = "%"
MOVES = "bake_mrays_per_s"


def read(r):
    c = program.counters() if r.kind == "bake" else None
    if not c or c.get("cull.pairs", 0) <= 0:
        return None
    return 100.0 * c.get("cull.candidates", 0) / c["cull.pairs"]
