"""optim_ms.mat: device ms a step of the kernels launched under the
harness's spans around optimizer.step() (torch.optim.Adam) and
clamp_material_params."""

UNIT = "ms"
MOVES = "mat_steps_per_s"
SPAN = "optim"


def read(r):
    if r.kind != "mat" or r.trace is None or not r.trace.span_count(SPAN):
        return None
    return r.per_unit(r.trace.span_ms(SPAN))
