"""Device milliseconds a ``serve.batch`` of the operations launched inside
``detect.box_head``, over the traced sub-window.

Computed by ``benchmark/spans.py readings``."""


def read(ctx):
    return ctx.span_readings.get("box_head_dev_ms.dir")
