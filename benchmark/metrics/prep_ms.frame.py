"""Mean host milliseconds per frame of the frame's preparation (letterbox or
square resize) over the window."""


def read(ctx):
    prep = ctx.spans.get("prep")
    if not prep:
        return None
    return 1e3 * sum(prep) / len(prep)
