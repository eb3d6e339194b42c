"""Mean host milliseconds a frame in the NMS tail's spans (every
``nms.*``, an ``nms.*`` span inside another counted once), over the
window.

Computed by ``benchmark/spans.py readings``."""


def read(ctx):
    return ctx.span_readings.get("nms_host_ms.frame")
