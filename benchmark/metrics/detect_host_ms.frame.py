"""Mean host milliseconds of a frame's ``detect`` (its request root: the
model step from the prepared frame to the rows on the card), over the
window.

Computed by ``benchmark/spans.py readings``."""


def read(ctx):
    return ctx.span_readings.get("detect_host_ms.frame")
