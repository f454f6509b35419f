"""pack_program_s: the program's share of pack_s: host seconds in its
packing functions (the counters `pack.bvh`, `pack.tbl`, `pack.fan`,
`pack.clusters`, `pack.occluders`, `pack.texels`), the harness's scene
generation left out."""

from port_bench import program

UNIT = "s"
MOVES = "setup_s"


def read(r):
    c = program.counters()
    parts = [v for k, v in (c or {}).items() if k.startswith("pack.")]
    return sum(parts) if parts else None
