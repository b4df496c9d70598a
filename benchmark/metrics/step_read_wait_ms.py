"""Median over the window's frame-step frames (those whose stages hold
frame.mm or frame.ref) of the host time the frame spent blocked in the
program's device->host reads: its summed read.* spans (the motion
model's verdict, the packed fetch, the pose; the program's spans,
recorded while it traces). No read.* sample in the window, or no
frame-step frame: nothing."""

import statistics

FRAME_STEP = ("frame.mm", "frame.ref")
PREFIX = "read."


def read(ctx):
    if not any(k.startswith(PREFIX) for k in ctx.get("stages", {})):
        return None
    per = [sum(v for k, v in fs.items() if k.startswith(PREFIX))
           for fs in ctx.get("frame_stages", []) if any(k in fs for k in FRAME_STEP)]
    return 1e3 * statistics.median(per) if per else None
