"""Share of the traced sub-window in which no device operation (kernel,
copy or fill) runs: one minus the union of their intervals over the
window, never a sum of their times."""


def read(ctx):
    if ctx.trace is None or ctx.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
