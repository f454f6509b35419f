"""launches.mat: device kernels launched a step, from the traced window."""

UNIT = "launches"
MOVES = "mat_steps_per_s"


def read(r):
    if r.kind != "mat" or r.trace is None:
        return None
    return r.per_unit(r.trace.launches)
