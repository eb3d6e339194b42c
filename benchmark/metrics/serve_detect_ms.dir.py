"""Mean host milliseconds a batch in ``detect``, the model step inside
each ``serve.batch`` (the host launching the step's work), over the
window.

Computed by ``benchmark/spans.py readings``."""


def read(ctx):
    return ctx.span_readings.get("serve_detect_ms.dir")
