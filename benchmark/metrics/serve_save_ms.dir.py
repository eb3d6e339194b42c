"""Mean host milliseconds a batch in ``serve.save``, the writing of the
batch's ``.npy`` files inside each ``serve.batch``, over the window.

Computed by ``benchmark/spans.py readings``."""


def read(ctx):
    return ctx.span_readings.get("serve_save_ms.dir")
