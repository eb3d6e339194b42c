"""Mean host milliseconds a batch in ``serve.h2d``, the copy of the
prepared batch to the card inside each ``serve.batch``, over the window.

Computed by ``benchmark/spans.py readings``."""


def read(ctx):
    return ctx.span_readings.get("serve_h2d_ms.dir")
