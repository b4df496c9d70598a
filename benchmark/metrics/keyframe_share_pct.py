"""Keyframes the tracker inserted in the window over the frames of the
window, in percent (its frames.keyframe counter)."""


def read(ctx):
    if not ctx["frames"]:
        return None
    return 100.0 * (ctx["counters1"]["keyframes"] - ctx["counters0"]["keyframes"]) / ctx["frames"]
