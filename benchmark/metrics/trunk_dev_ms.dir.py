"""Device milliseconds a ``serve.batch`` of the operations launched inside
``detect.trunk`` (backbone, FPN, RPN head), over the traced sub-window.

Computed by ``benchmark/spans.py readings``."""


def read(ctx):
    return ctx.span_readings.get("trunk_dev_ms.dir")
