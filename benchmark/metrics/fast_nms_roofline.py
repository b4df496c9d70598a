"""Share of its roofline that the FAST+NMS kernel (csrc/fast_nms.cu,
fast_nms_pyramid_kernel) reached in the profiled slice: the least time of
its launches at the slice's frames (benchmark/roofline.py's bound, the
pixels that score counted on these frames) over the kernel's summed device
time, in percent. No launch seen in the slice: nothing."""

KERNEL = "fast_nms_pyramid_kernel"


def read(ctx):
    sl = ctx.get("slice")
    if not sl:
        return None
    hits = [v for name, v in sl["kernels"].items() if KERNEL in name]
    ns, n = sum(h[0] for h in hits), sum(h[1] for h in hits)
    if not n or not ns:
        return None
    return 100.0 * n * sl["bounds"]["fast_nms"] / (ns / 1e9)
