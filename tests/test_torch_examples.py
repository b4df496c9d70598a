"""The port's drivers (tpuslam_torch/examples) on the CPU: each writes the
trajectory file that System.save_trajectory_* writes when the same frames
are fed to a System directly. The dataset drivers read folders written here
without PIL (testing.write_tum_rgbd, png_bytes): the RGB-D driver at the
default capacities, the others with their System made at small ones (a
keyframe job over 200,000 point slots takes about a minute on the CPU);
run_synthetic renders its own scene. tests/test_torch_ar_demo.py runs
ar_demo."""

import functools
import os

import numpy as np
import pytest
import torch

from tpuslam_torch.examples import mono_tum, rgbd_tum, run_synthetic, stereo_euroc, stereo_kitti
from tpuslam_torch.geometry.camera import PinholeCamera
from tpuslam_torch.io.datasets import load_grayscale
from tpuslam_torch.io.native import decode_png_raw
from tpuslam_torch.io.settings import Settings
from tpuslam_torch.ops.orb import ORBConfig
from tpuslam_torch.pipeline.system import SensorType, System
from tpuslam_torch.testing import (
    StepWallScene,
    orbit_trajectory,
    png_bytes,
    render_rgbd_frames,
    render_stereo_frames,
    write_tum_rgbd,
)

torch.set_num_threads(2)

CAM = PinholeCamera(fx=350.0, fy=350.0, cx=160.0, cy=120.0, bf=40.0, width=320, height=240)
SMALL = dict(max_keyframes=16, max_points=4096)
SETTINGS = Settings(cam=CAM, orb=ORBConfig(n_features=500), fps=30.0, th_depth_factor=40.0,
                    depth_map_factor=1.0 / 5000.0)


def _system(sensor, settings=SETTINGS, **kw):
    """The System a dataset driver builds from `settings`."""
    return System(settings.cam, sensor, orb=settings.orb, device="cpu",
                  kf_max_frames=int(settings.fps), **kw)


@pytest.fixture
def small(monkeypatch):
    """The drivers' Systems at small capacities."""
    for mod in (mono_tum, stereo_kitti, stereo_euroc):
        monkeypatch.setattr(mod, "System", functools.partial(System, **SMALL))


def _tum_lines(path):
    lines = open(path).read().splitlines()
    assert lines and all(len(x.split()) == 8 for x in lines)
    return lines


@pytest.fixture(scope="module")
def tum_folder(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tum"))
    frames = render_rgbd_frames(StepWallScene(np.random.default_rng(6)), CAM, orbit_trajectory(6, step=0.04))
    return root, write_tum_rgbd(root, frames), frames


def test_png_writer_round_trips(rng):
    from PIL import Image
    import io

    for a in (rng.integers(0, 256, (7, 9), dtype=np.uint8), rng.integers(0, 65536, (7, 9)).astype(np.uint16),
              rng.integers(0, 256, (7, 9, 3), dtype=np.uint8)):
        data = png_bytes(a)
        np.testing.assert_array_equal(decode_png_raw(data).reshape(a.shape), a)
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), a)


def test_rgbd_tum_driver_equals_direct_feed(tum_folder, tmp_path):
    root, assoc, frames = tum_folder
    out = str(tmp_path / "traj.txt")
    res = rgbd_tum.run(SETTINGS, root, assoc, out, device="cpu")
    assert len(res.track_ms) == len(res.decode_ms) == 6
    lines = _tum_lines(out)
    assert len(lines) == 6 and float(lines[0].split()[0]) == pytest.approx(1305031102.175304, abs=1e-6)
    # The decoded first frame is the rounded render (grey in all three
    # channels: the luma is exact).
    items = [x.split() for x in open(assoc).read().splitlines()]
    g = load_grayscale(os.path.join(root, items[0][1]))
    np.testing.assert_array_equal(g, np.clip(np.round(frames[0][0].numpy()), 0, 255))

    direct = _system(SensorType.RGBD, th_depth_factor=40.0)
    for t, rgb, _, depth in items:
        d = load_grayscale(os.path.join(root, depth)) * SETTINGS.depth_map_factor
        direct.track_rgbd(load_grayscale(os.path.join(root, rgb)), d, float(t))
    direct.save_trajectory_tum(str(tmp_path / "direct.txt"))
    assert open(out).read() == open(tmp_path / "direct.txt").read()


def test_mono_tum_driver_equals_direct_feed(tum_folder, tmp_path, small):
    root, assoc, _ = tum_folder
    out = str(tmp_path / "mono.txt")
    res = mono_tum.run(SETTINGS, root, out, device="cpu")
    assert len(res.track_ms) == 6
    direct = _system(SensorType.MONOCULAR, th_depth_factor=40.0, **SMALL)
    for line in open(os.path.join(root, "rgb.txt")).read().splitlines()[1:]:
        t, rel = line.split()
        direct.track_monocular(load_grayscale(os.path.join(root, rel)), float(t))
    direct.save_trajectory_tum(str(tmp_path / "direct.txt"))
    assert open(out).read() == open(tmp_path / "direct.txt").read()


def _stereo_pairs(n):
    cam = PinholeCamera(fx=350.0, fy=350.0, cx=160.0, cy=120.0, bf=42.0, width=320, height=240)
    pairs = render_stereo_frames(StepWallScene(np.random.default_rng(5)), cam, orbit_trajectory(n, step=0.05))
    u8 = [tuple(np.clip(np.round(x.numpy()), 0, 255).astype(np.uint8) for x in p) for p in pairs]
    return cam, u8


def test_stereo_kitti_driver_equals_direct_feed(tmp_path, small):
    cam, pairs = _stereo_pairs(4)
    for d in ("image_0", "image_1"):
        (tmp_path / d).mkdir()
    for i, (L, R) in enumerate(pairs):
        (tmp_path / "image_0" / f"{i:06d}.png").write_bytes(png_bytes(L))
        (tmp_path / "image_1" / f"{i:06d}.png").write_bytes(png_bytes(R))
    (tmp_path / "times.txt").write_text("".join(f"{i * 0.1:.6e}\n" for i in range(4)))
    settings = Settings(cam=cam, orb=ORBConfig(n_features=500), fps=10.0, th_depth_factor=35.0)
    out = str(tmp_path / "kitti.txt")
    stereo_kitti.run(settings, str(tmp_path), out, device="cpu")
    rows = open(out).read().splitlines()
    assert len(rows) == 4 and all(len(r.split()) == 12 for r in rows)
    direct = _system(SensorType.STEREO, settings, th_depth_factor=35.0, **SMALL)
    for i, (L, R) in enumerate(pairs):
        direct.track_stereo(L.astype(np.float32), R.astype(np.float32), i * 0.1)
    direct.save_trajectory_kitti(str(tmp_path / "direct.txt"))
    assert open(out).read() == open(tmp_path / "direct.txt").read()


def test_stereo_euroc_driver_rectifies_then_tracks(tmp_path, small):
    """Identity rectification blocks (no distortion, R = I, P = [K | 0]):
    the remapped pair equals the stored one away from the clamped last row
    and column, and the driver tracks every pair."""
    cam, pairs = _stereo_pairs(4)
    stamps = [str(1403636579763555584 + 50_000_000 * i) for i in range(4)]
    for c, side in (("cam0", 0), ("cam1", 1)):
        d = tmp_path / "mav0" / c / "data"
        d.mkdir(parents=True)
        for s, p in zip(stamps, pairs):
            (d / f"{s}.png").write_bytes(png_bytes(p[side]))
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]])
    block = {"K": K, "D": np.zeros((1, 5)), "R": np.eye(3), "P": np.concatenate([K, np.zeros((3, 1))], 1)}
    settings = Settings(cam=cam, orb=ORBConfig(n_features=500), fps=20.0, th_depth_factor=35.0,
                        left_rect=block, right_rect=dict(block))
    out = str(tmp_path / "euroc.txt")
    res = stereo_euroc.run(settings, str(tmp_path), out, device="cpu")
    lines = _tum_lines(out)
    assert len(lines) == 4 and res.system.state.name == "OK"
    assert float(lines[0].split()[0]) == pytest.approx(float(stamps[0]) * 1e-9, abs=1e-6)
    rect = stereo_euroc.StereoRectifier(block, block, 320, 240, device="cpu")
    L, _ = rect(pairs[0][0], pairs[0][1])
    np.testing.assert_allclose(L.numpy()[:-1, :-1], pairs[0][0][:-1, :-1], atol=1e-3)


def test_run_synthetic_equals_direct_feed(tmp_path):
    out = str(tmp_path / "syn.txt")
    system = run_synthetic.run("rgbd", 6, out, device="cpu")
    lines = _tum_lines(out)
    assert len(lines) == 6 and system.state.name == "OK"
    cam = PinholeCamera(fx=350.0, fy=350.0, cx=160.0, cy=120.0, bf=350.0 * run_synthetic.BASELINE,
                        width=320, height=240)
    scene = StepWallScene(np.random.default_rng(11))
    direct = System(cam, SensorType.RGBD, orb=ORBConfig(n_features=400), device="cpu", max_keyframes=60,
                    max_points=8000, kf_max_frames=10, init_min_matches=60)
    for i, (R, t) in enumerate(orbit_trajectory(6, step=0.045)):
        img, depth = scene.render(cam, R, t, with_depth=True)
        direct.track_rgbd(img, depth, i / 30.0)
    direct.save_trajectory_tum(str(tmp_path / "direct.txt"))
    assert open(out).read() == open(tmp_path / "direct.txt").read()
