"""Median over the window's keyframe jobs of the map.front stage
(mapping_front's segments: triangulation, insertion, fusion, culling),
device time with stage_sync on."""

import statistics


def read(ctx):
    xs = ctx["stages"].get("map.front", [])
    return 1e3 * statistics.median(xs) if xs else None
