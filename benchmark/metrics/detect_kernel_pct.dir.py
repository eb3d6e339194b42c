"""Share of the traced sub-window's kernel time launched inside ``detect``:
what is left is the serving loop's own kernels.

Computed by ``benchmark/spans.py readings``."""


def read(ctx):
    return ctx.span_readings.get("detect_kernel_pct.dir")
