"""Device milliseconds a ``serve.batch`` of the operations launched inside
``detect.roi_align``, over the traced sub-window.

Computed by ``benchmark/spans.py readings``."""


def read(ctx):
    return ctx.span_readings.get("roi_align_dev_ms.dir")
