"""cull_launches.bake: kernel-launch runtime calls a batch
(cudaLaunchKernel*, cuLaunchKernel*) made inside the program's `texir.cull`
span (ops/pallas_culled.py::cull_blocks, occluder removal included), in
both passes of the two-pass trace."""

from port_bench import program

UNIT = "launches"
MOVES = "bake_mrays_per_s"
LAUNCH = ("cudaLaunchKernel", "cuLaunchKernel")


def read(r):
    if r.kind != "bake" or r.trace is None:
        return None
    culls = program.merged(program.spans(r.trace, "cull"))
    launches = sorted(iv.start for iv in r.trace.host
                      if iv.name.startswith(LAUNCH))
    if not culls or not launches:
        return None
    return r.per_unit(program.count_inside(launches, culls))
