"""Share of the profiled slice's wall time in which no operation ran on
the device (1 - the union of device activity over the slice), in percent."""


def read(ctx):
    sl = ctx.get("slice")
    if not sl or not sl["wall_s"] or not sl["busy_ns"]:
        return None
    return 100.0 * max(0.0, 1.0 - sl["busy_ns"] / 1e9 / sl["wall_s"])
