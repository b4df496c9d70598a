"""The scene and the routes come from the seed alone: the same seed gives
the same frames, another seed other frames over the same set of depths;
seeds past 32 bits are taken."""

import numpy as np
import pytest
import torch

from benchmark.reference.points import ray_depths
from benchmark.traffic import routes
from benchmark.traffic.frames import FrameSource
from benchmark.traffic.scene import Corridor

DEPTHS = [3.5, 5.0, 4.2, 6.5, 3.8, 5.8, 4.6, 7.0]
CAM = dict(fx=130.0, fy=130.0, cx=80.0, cy=60.0, width=160, height=120)
ROUTE = {"x0": -3.0, "speed": 0.02, "yaw_rate": 0.002, "yaw_amp": 0.15, "bob": 0.01}


def _scene(seed):
    return Corridor(seed, 16, DEPTHS, 1.2, 60.0, ssaa=1, device="cpu")


@pytest.mark.parametrize("seed", [0, 2**31 + 12345, 9_000_000_000])
def test_same_seed_same_frames(seed):
    a = FrameSource(_scene(seed), CAM, ROUTE).render(3, 2)
    b = FrameSource(_scene(seed), CAM, ROUTE).render(3, 2)
    assert all(np.array_equal(x[0], y[0]) for x, y in zip(a, b))
    assert a[0][0].dtype == np.uint8 and a[0][0].shape == (120, 160)


def test_other_seed_other_texture_same_depths():
    s1, s2 = _scene(1), _scene(2)
    assert not torch.equal(s1.strip, s2.strip)
    assert np.array_equal(s1.depths, s2.depths) and np.array_equal(s1.depths[:8], DEPTHS)


def test_stereo_pair_and_truth():
    src = FrameSource(_scene(5), dict(CAM, bf=40.0), ROUTE, baseline=40.0 / 130.0)
    (left, right), = src.render(0, 1)
    assert left.shape == right.shape and not np.array_equal(left, right)
    R, t = src.truth([0, 1])
    C = -np.einsum("nji,nj->ni", R, t)
    assert np.allclose(C[1] - C[0], [0.02, 0.01 * np.sin(0.3), 0.0], atol=1e-9)


def test_routes():
    R, t = routes.poses(ROUTE, np.arange(2000))
    yaw = np.arctan2(R[:, 0, 2], R[:, 0, 0])
    assert np.abs(yaw).max() <= 0.15 + 1e-12  # the sway stays bounded on a long route
    assert np.allclose(np.einsum("nij,nkj->nik", R, R), np.eye(3), atol=1e-12)
    _, C = routes.centres(ROUTE, np.arange(40))
    assert np.allclose(np.diff(C[:, 0].numpy()), 0.02) and not C[:, 2].any()
    assert routes.length_frames(ROUTE, -9.6, 9.6, 2.0) == int((9.6 - 2.0 + 3.0) / 0.02)


def test_bfloat16_route_is_the_truth_rounded():
    ids = np.arange(100, 110)
    Rg, tg = routes.poses(ROUTE, ids)
    Rb, tb = routes.poses(ROUTE, ids, dtype=torch.bfloat16)
    assert not np.array_equal(tb, tg) and np.abs(tb - tg).max() < 0.05


def test_ray_depths_meet_the_nearest_slab_in_its_band():
    s = _scene(3)
    xc = s.x_lo + s.band * (np.arange(16) + 0.5)
    C = np.stack([xc, np.zeros(16), np.zeros(16)], 1)
    straight = np.tile([0.0, 0.0, 1.0], (16, 1))
    assert np.allclose(ray_depths(C, straight, s.depths, s.x_lo, s.band), s.depths)
    # A ray aimed at band 1 (5.0 m) from over band 0: it passes band 0's
    # plane (3.5 m) outside band 0 and meets band 1's.
    d = np.array([[(s.band * 1.5 - s.band * 0.5) / 5.0, 0.0, 1.0]])
    assert ray_depths(C[:1], d, s.depths, s.x_lo, s.band)[0] == pytest.approx(5.0)
    assert np.isnan(ray_depths(C[:1], np.array([[-1.0, 0.0, 1e-3]]), s.depths, s.x_lo, s.band)[0])
