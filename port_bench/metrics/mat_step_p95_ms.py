"""mat_step_p95_ms: the 95th percentile of the Mat steps' intervals over
the whole window of a run, from CUDA events recorded on the stream
between the steps (the last step of an epoch ends at an event before the
epoch's losses are read)."""

import statistics

UNIT = "ms"
MOVES = "mat_steps_per_s"


def read(r):
    ms = r.host.get("step_ms") if r.kind == "mat" else None
    if not ms or len(ms) < 20:
        return None
    return statistics.quantiles(ms, n=20)[-1]
