"""sync_idle_ms.bake: device-idle ms a batch from the end of each
`texir.twopass.sync` span (the straggler count's device-to-host read,
which drains the card) to the end of the `texir.twopass.retrace` span
that follows it (pass 2: its cull, walk and scatter enqueued): the card
waiting for the host to enqueue pass 2."""

from port_bench import program
from port_bench.trace import Interval

UNIT = "ms"
MOVES = "bake_mrays_per_s"


def read(r):
    if r.kind != "bake" or r.trace is None:
        return None
    syncs = program.spans(r.trace, "twopass.sync")
    retraces = program.spans(r.trace, "twopass.retrace")
    if not syncs or not retraces or not r.trace.busy_intervals():
        return None
    starts = sorted(s.start for s in syncs)
    after = []
    for s in syncs:
        nxt = [rt for rt in retraces if rt.start >= s.end]
        if not nxt:
            continue
        rt = min(nxt, key=lambda iv: iv.start)
        # the re-trace of this sync's call: no other sync begins between
        if not any(s.end <= t < rt.start for t in starts):
            after.append(Interval(s.end, rt.end, "after_sync"))
    if not after:
        return None
    return r.per_unit(program.idle_ns(r.trace, program.merged(after)) / 1e6)
