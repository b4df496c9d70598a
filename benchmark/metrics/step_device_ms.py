"""Median over the window's frame-step frames (those whose stages hold
frame.mm or frame.ref) of the device-side span of the frame's graph
replays: its summed dev.launch.* samples, each the stream's time from a
replay's start to its end from a CUDA event pair, read without a
synchronization (the program's spans, recorded while it traces). No
dev.launch.* sample in the window, or no frame-step frame: nothing."""

import statistics

FRAME_STEP = ("frame.mm", "frame.ref")
PREFIX = "dev.launch."


def read(ctx):
    if not any(k.startswith(PREFIX) for k in ctx.get("stages", {})):
        return None
    per = [sum(v for k, v in fs.items() if k.startswith(PREFIX))
           for fs in ctx.get("frame_stages", []) if any(k in fs for k in FRAME_STEP)]
    return 1e3 * statistics.median(per) if per else None
