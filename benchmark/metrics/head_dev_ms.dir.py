"""Device milliseconds a ``serve.batch`` of the operations launched inside
``detect.head`` (RetinaNet's two towers and output convs over every level,
and the level concat), over the traced sub-window; None where the trace
holds no kernel or no such span."""


def read(ctx):
    if ctx.trace is None or ctx.trace["by_span"]["kernel_s"] <= 0:
        return None
    sp = ctx.trace["by_span"]["spans"]
    if "serve.batch" not in sp or "detect.head" not in sp:
        return None
    return sp["detect.head"]["device_s"] * 1e3 / sp["serve.batch"]["count"]
