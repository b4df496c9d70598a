"""Median over the window's keyframe jobs of the map.loop stage (the
keyframe's hand-off to loop closing: BoW vector, database query,
candidate checks, and a closure when one is found)."""

import statistics


def read(ctx):
    xs = ctx["stages"].get("map.loop", [])
    return 1e3 * statistics.median(xs) if xs else None
