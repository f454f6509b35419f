"""walk_ms.bake: device ms a batch of kernel B1's launches
(csrc/culled_walk.cu, every culled_walk_kernel* name)."""

UNIT = "ms"
MOVES = "bake_mrays_per_s"
KERNEL = "culled_walk_kernel"


def read(r):
    if r.kind != "bake" or r.trace is None:
        return None
    ms = r.trace.kernel_ms(lambda name: KERNEL in name)
    return r.per_unit(ms) if ms > 0 else None
