"""cull_ms.bake: device ms a batch of the kernels launched under the
harness's span around ops/pallas_culled.py::cull_blocks."""

UNIT = "ms"
MOVES = "bake_mrays_per_s"
SPAN = "cull"


def read(r):
    if r.kind != "bake" or r.trace is None or not r.trace.span_count(SPAN):
        return None
    return r.per_unit(r.trace.span_ms(SPAN))
