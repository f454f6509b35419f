"""walk_roofline.bake: the least time the card needs for the walk's
work over kernel B1's device time, in %.  The work is counted by the
frozen plain walk (port_bench.roofline) on the traced batches' own rays:
the larger of tests x 30 float32 operations at 67 TFLOP/s and the
inputs' and outputs' bytes at 3.35 TB/s (H100 SXM at 700 W)."""

UNIT = "%"
MOVES = "bake_mrays_per_s"
KERNEL = "culled_walk_kernel"


def read(r):
    if r.kind != "bake" or r.trace is None or r.walk is None:
        return None
    ms = r.trace.kernel_ms(lambda name: KERNEL in name)
    if ms <= 0:
        return None
    return 100.0 * r.walk.bound_ms / ms
