"""Device milliseconds a ``serve.batch`` of the operations launched inside
``nms.prefilter`` (RetinaNet's raw-logit prefilter: row max, sigmoid, gate,
the top 2048 rows and their gathers), over the traced sub-window; None
where the trace holds no kernel or no such span."""


def read(ctx):
    if ctx.trace is None or ctx.trace["by_span"]["kernel_s"] <= 0:
        return None
    sp = ctx.trace["by_span"]["spans"]
    if "serve.batch" not in sp or "nms.prefilter" not in sp:
        return None
    return sp["nms.prefilter"]["device_s"] * 1e3 / sp["serve.batch"]["count"]
