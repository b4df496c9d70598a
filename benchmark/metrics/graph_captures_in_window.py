"""CUDA graphs captured during the window by the tracker's three graph sets
(tracking, keyframe job, global BA) and its loop closer's: a capture in the
window is a frame that pays for it."""


def read(ctx):
    return ctx["counters1"]["captures"] - ctx["counters0"]["captures"]
