"""enqueue_ms.mat: the median host ms that enqueueing one Mat step takes
over the window (host clock around MatTrainRunner._step, no sync).  Where
it reads above the step's device time the host paces the card; where the
launch queue is full it reads the card's pace instead."""

import statistics

UNIT = "ms"
MOVES = "mat_steps_per_s"


def read(r):
    ms = r.host.get("enqueue_ms") if r.kind == "mat" else None
    if not ms:
        return None
    return statistics.median(ms)
