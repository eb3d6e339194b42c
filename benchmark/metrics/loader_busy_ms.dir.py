"""Host milliseconds of ``load.batch`` (decode and resize on the loader's
threads) over the window, per ``serve.batch``.

Computed by ``benchmark/spans.py readings``."""


def read(ctx):
    return ctx.span_readings.get("loader_busy_ms.dir")
