"""launches.bake: device kernels launched a batch, from the traced window."""

UNIT = "launches"
MOVES = "bake_mrays_per_s"


def read(r):
    if r.kind != "bake" or r.trace is None:
        return None
    return r.per_unit(r.trace.launches)
