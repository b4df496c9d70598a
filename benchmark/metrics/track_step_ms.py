"""Median over the window's frames of the time the frame spent in the
tracker's track.* stages (the step's dispatch and its packed fetch, the
stereo front end), track.relocalize left out; stage_sync is on in the
traced run, so the fetch waits for the step's device work. A
localization-mode frame of a depth sensor times only its front end."""

import statistics


def read(ctx):
    per = [sum(v for k, v in fs.items() if k.startswith("track.") and k != "track.relocalize")
           for fs in ctx.get("frame_stages", [])]
    per = [x for x in per if x > 0]
    return 1e3 * statistics.median(per) if per else None
