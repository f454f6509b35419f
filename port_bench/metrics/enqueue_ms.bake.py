"""enqueue_ms.bake: the median host ms a `texir.bake.batch` span
(IrradianceTextureBaker.bake_batch) in the traced window takes to
enqueue its work: the span less the `texir.twopass.sync` spans inside
it, where the host waits for the card to count the stragglers.  Set
against a batch's device time: where it reads above it, the host paces
the card."""

import statistics

from port_bench import program

UNIT = "ms"
MOVES = "bake_mrays_per_s"


def read(r):
    if r.kind != "bake" or r.trace is None:
        return None
    syncs = program.spans(r.trace, "twopass.sync")
    ms = []
    for b in program.spans(r.trace, "bake.batch"):
        waited = sum(s.end - s.start for s in syncs
                     if b.start <= s.start and s.end <= b.end)
        ms.append((b.end - b.start - waited) / 1e6)
    return statistics.median(ms) if ms else None
