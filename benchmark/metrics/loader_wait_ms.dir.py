"""Mean milliseconds that ``run_detection`` waited for its next prepared
batch (decode and resize in the loader threads) over the window."""


def read(ctx):
    waits = ctx.spans.get("loader_wait")
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
