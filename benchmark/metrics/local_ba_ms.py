"""Median over the window's keyframe jobs of the two local-BA chunks
(map.local_ba1 + map.local_ba2 of the same frame), device time with
stage_sync on."""

import statistics


def read(ctx):
    per = [fs.get("map.local_ba1", 0.0) + fs.get("map.local_ba2", 0.0)
           for fs in ctx.get("frame_stages", []) if "map.local_ba1" in fs]
    return 1e3 * statistics.median(per) if per else None
