"""Median over the window's frames of the host time the System spent
turning the frame's host images into float32 tensors on the card: the
frame's summed sys.upload spans, one an image (the program's spans,
recorded while it traces). No frame with an upload span: nothing."""

import statistics

NAME = "sys.upload"


def read(ctx):
    if NAME not in ctx.get("stages", {}):
        return None
    per = [fs[NAME] for fs in ctx.get("frame_stages", []) if NAME in fs]
    return 1e3 * statistics.median(per) if per else None
