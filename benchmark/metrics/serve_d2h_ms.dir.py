"""Mean host milliseconds a batch in ``serve.d2h``, the copy of the rows
back to the host inside each ``serve.batch`` (it holds the wait for the
device), over the window.

Computed by ``benchmark/spans.py readings``."""


def read(ctx):
    return ctx.span_readings.get("serve_d2h_ms.dir")
