"""Convolutions' share of the card's f32 peak (TF32 off): the conv FLOPs of
the requests served in the traced sub-window, counted on the frozen
reference's shapes at 2 per multiply-add, over the device time of the
kernels launched under ``aten::convolution``."""


def read(ctx):
    if ctx.trace is None or ctx.trace["conv_s"] <= 0:
        return None
    return 100.0 * ctx.flops_traced["conv"] / (ctx.trace["conv_s"] * ctx.f32_peak)
