"""The arithmetic of the end-to-end metrics, of a set's spread and of the
kernels' bounds, on synthetic numbers."""

import statistics

import pytest

from benchmark import roofline, stats
from benchmark.reference import kernels as ref_k

KIND = "NVIDIA H100 80GB HBM3"


def test_rate_and_percentiles_with_a_stall():
    # 99 frames of 100 ms and one stall of 2 s: the rate counts the stall,
    # the median does not, the 95th percentile does not either.
    lat = [0.1] * 99 + [2.0]
    m = stats.window_metrics(lat, window_s=sum(lat))
    assert m["frames_per_s"] == pytest.approx(100 / 11.9)
    assert m["frame_ms_p50"] == pytest.approx(100.0)
    assert m["frame_ms_p95"] == pytest.approx(100.0)
    # Six stalls of 2 s in 100 frames: the 95th percentile is a stall.
    lat = [0.1] * 94 + [2.0] * 6
    m = stats.window_metrics(lat, window_s=sum(lat) + 0.5)  # host gaps between frames count
    assert m["frames_per_s"] == pytest.approx(100 / (9.4 + 12.0 + 0.5))
    assert m["frame_ms_p95"] == pytest.approx(2000.0)


def test_no_frame_is_an_error():
    with pytest.raises(ValueError):
        stats.window_metrics([], 1.0)


def test_spread_is_the_interquartile_range_over_the_median():
    xs = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / med)


@pytest.mark.parametrize("B, H, W, n_feat", [(1, 480, 640, 1000), (2, 376, 1241, 2000)])
def test_kernel_bounds_at_the_cells_shapes(B, H, W, n_feat):
    shapes = [(B, h, w) for h, w in ref_k.pyramid_shapes(H, W, 8, 1.2)]
    px = sum(b * h * w for b, h, w in shapes)
    # FAST+NMS: bytes bound (each pixel read and written once as float32)
    # when few pixels score, operations bound when many do.
    assert roofline.fast_bound_s(shapes, 0, KIND) == pytest.approx(8 * px / 3.35e12)
    heavy = roofline.fast_bound_s(shapes, px, KIND)
    assert heavy == pytest.approx((48 + 180) * px / 67e12) and heavy > 8 * px / 3.35e12
    # Gather: the uint8 atlas (every level edge-padded by 8, as wide as
    # level 0 plus 16) read once, the int32 corners read, the float32
    # windows written.
    Ha = sum(h + 16 for h, _ in ref_k.pyramid_shapes(H, W, 8, 1.2))
    n = B * n_feat
    nbytes = B * Ha * (W + 16) + n * 8 + n * 47 * 47 * 4
    assert roofline.gather_bound_s((B * Ha, W + 16), 1, n, KIND) == pytest.approx(nbytes / 3.35e12)


def test_atlas_layout_matches_the_bound_shapes():
    import torch

    imgs = torch.zeros((2, 60, 90))
    lv = ref_k.pyramid(imgs, 4, 1.2)
    a = ref_k.atlas(lv)
    assert a.shape == (2 * sum(h + 16 for h, _ in ref_k.pyramid_shapes(60, 90, 4, 1.2)), 90 + 16)
    assert a.dtype == torch.uint8
