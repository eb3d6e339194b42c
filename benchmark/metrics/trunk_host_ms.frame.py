"""Mean host milliseconds a frame in ``detect.trunk`` (the network's
forward pass, as launched from the host), over the window.

Computed by ``benchmark/spans.py readings``."""


def read(ctx):
    return ctx.span_readings.get("trunk_host_ms.frame")
