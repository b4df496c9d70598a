"""The chip's peaks and the least time each kernel could take at a frame's
shapes: copies of chip_smoke.py's fast_bound_ms and gather_bound_ms (commit
431b9431), with the same counting rules.

FAST+NMS: each pixel read and written once as float32, against 48
operations a pixel (16 differences, 32 comparisons) plus ~180 for each
pixel that scores (the arc search and its NMS window), counted on these
inputs. Gather: the atlas and the corners read once, the float32 windows
written once. The bound is the larger of bytes over the bandwidth and
operations over the float32 rate.
"""

from __future__ import annotations

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and
# float32 operations/s outside the tensor cores, at the 700 W limit.
PEAKS = {"NVIDIA H100 80GB HBM3": {"hbm_bytes_s": 3.35e12, "f32_ops_s": 67e12}}
DEFAULT_PEAK = "NVIDIA H100 80GB HBM3"
PSIZE = 47


def peak(kind: str) -> dict:
    return PEAKS.get(kind, PEAKS[DEFAULT_PEAK])


def fast_bound_s(level_shapes, scoring_px: int, kind: str) -> float:
    """Seconds at the peak for one launch over levels of these (B, H, W)
    shapes, `scoring_px` of whose pixels score above the threshold."""
    pk = peak(kind)
    px = sum(b * h * w for b, h, w in level_shapes)
    return max(8 * px / pk["hbm_bytes_s"], (48 * px + 180 * scoring_px) / pk["f32_ops_s"])


def gather_bound_s(atlas_shape, atlas_itemsize: int, n_windows: int, kind: str) -> float:
    """Seconds at the peak for one gather of n windows from an atlas."""
    Ha, Wa = atlas_shape
    nbytes = Ha * Wa * atlas_itemsize + n_windows * 2 * 4 + n_windows * PSIZE * PSIZE * 4
    return nbytes / peak(kind)["hbm_bytes_s"]
