"""The whole step's share of the card's f32 peak (TF32 off): every model
FLOP (convolutions and linear layers, counted on the frozen reference at 2
per multiply-add; Faster R-CNN's box head for the proposals each image
keeps) of the window's requests, over the window's time."""


def read(ctx):
    flops = ctx.flops_window["conv"] + ctx.flops_window["linear"]
    if ctx.f32_peak is None or flops <= 0 or ctx.window_s <= 0:
        return None
    return 100.0 * flops / (ctx.window_s * ctx.f32_peak)
