"""Kernels launched inside a frame's ``detect``, over the traced
sub-window.

Computed by ``benchmark/spans.py readings``."""


def read(ctx):
    return ctx.span_readings.get("launches.frame")
