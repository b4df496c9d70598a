"""Share of its roofline that the patch gather (csrc/gather_patches.cu,
gather_u8_kernel / gather_f32_kernel) reached in the profiled slice: the
least time of its launches (each B x n_features windows from the frame's
atlas, benchmark/roofline.py) over the kernels' summed device time, in
percent. No launch seen in the slice: nothing."""

KERNELS = ("gather_u8_kernel", "gather_f32_kernel")


def read(ctx):
    sl = ctx.get("slice")
    if not sl:
        return None
    hits = [v for name, v in sl["kernels"].items() if any(k in name for k in KERNELS)]
    ns, n = sum(h[0] for h in hits), sum(h[1] for h in hits)
    if not n or not ns:
        return None
    return 100.0 * n * sl["bounds"]["gather_patches"] / (ns / 1e9)
