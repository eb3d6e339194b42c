"""The detection head's share of the card's f32 peak (TF32 off): the head's
FLOPs of the requests served in the traced sub-window (towers and output
convs, counted on the frozen reference's shapes at 2 per multiply-add) over
the device time of the operations launched inside ``detect.head``; None
where the trace holds no kernel or no such span, or off the card."""


def read(ctx):
    if ctx.trace is None or ctx.f32_peak is None or ctx.trace["by_span"]["kernel_s"] <= 0:
        return None
    head_s = ctx.trace["by_span"]["spans"].get("detect.head", {}).get("device_s", 0.0)
    flops = ctx.flops_traced.get("head", 0)
    if head_s <= 0 or flops <= 0:
        return None
    return 100.0 * flops / (head_s * ctx.f32_peak)
