"""The port's settings loader against the JAX package's, on settings files
written here with the reference's values (its Examples/ tree is not part of
this repo): KITTI00-02.yaml's stereo block, TUM1.yaml's RGB-D block with
DepthMapFactor 5000, and a EuRoC-style file with the LEFT.* / RIGHT.*
rectification matrices."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tpuslam.io.settings import load_settings as jax_load_settings
from tpuslam_torch.io.settings import load_settings

KITTI = """%YAML:1.0

# Camera calibration and distortion parameters (OpenCV)
Camera.fx: 718.856
Camera.fy: 718.856
Camera.cx: 607.1928
Camera.cy: 185.2157

Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0

Camera.width: 1241
Camera.height: 376

# Camera frames per second
Camera.fps: 10.0

# stereo baseline times fx
Camera.bf: 386.1448

Camera.RGB: 1

# Close/Far threshold. Baseline times.
ThDepth: 35

ORBextractor.nFeatures: 2000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7

Viewer.KeyFrameSize: 0.6
Viewer.PointSize:2
"""

TUM1_RGBD = """%YAML:1.0

Camera.fx: 517.306408
Camera.fy: 516.469215
Camera.cx: 318.643040
Camera.cy: 255.313989

Camera.k1: 0.262383
Camera.k2: -0.953104
Camera.p1: -0.005358
Camera.p2: 0.002628
Camera.k3: 1.163314

Camera.width: 640
Camera.height: 480

Camera.fps: 30.0

# IR projector baseline times fx (aprox.)
Camera.bf: 40.0

Camera.RGB: 1

ThDepth: 40.0

# Deptmap values factor
DepthMapFactor: 5000.0

ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""

EUROC = """%YAML:1.0

Camera.fx: 435.2046959714599
Camera.fy: 435.2046959714599
Camera.cx: 367.4517211914062
Camera.cy: 252.2008514404297
Camera.width: 752
Camera.height: 480
Camera.fps: 20.0
Camera.bf: 47.90639384423901
Camera.RGB: 1
ThDepth: 35

LEFT.height: 480
LEFT.width: 752
LEFT.D: !!opencv-matrix
   rows: 1
   cols: 5
   dt: d
   data:[-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0]
LEFT.K: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [458.654, 0.0, 367.215, 0.0, 457.296, 248.375, 0.0, 0.0, 1.0]
LEFT.R:  !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [0.999966347530033, -0.001422739138722922, 0.008079580483432283, 0.001365741834644127, 0.9999741760894847, 0.007055629199258132, -0.008089410156878961, -0.007044357138835809, 0.9999424675829176]
LEFT.P:  !!opencv-matrix
   rows: 3
   cols: 4
   dt: d
   data: [435.2046959714599, 0, 367.4517211914062, 0,  0, 435.2046959714599, 252.2008514404297, 0,  0, 0, 1, 0]
RIGHT.D: !!opencv-matrix
   rows: 1
   cols: 5
   dt: d
   data:[-0.28368365, 0.07451284, -0.00010473, -3.555907e-05, 0.0]
RIGHT.K: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [457.587, 0.0, 379.999, 0.0, 456.134, 255.238, 0.0, 0.0, 1]
RIGHT.R:  !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [0.9999633526194376, -0.003625811871560086, 0.007755443660172947, 0.003680398547259526, 0.9999684752771629, -0.007035845251224894, -0.007729688520722713, 0.007064130529506649, 0.999945173484644]
RIGHT.P:  !!opencv-matrix
   rows: 3
   cols: 4
   dt: d
   data: [435.2046959714599, 0, 367.4517211914062, -47.90639384423901, 0, 435.2046959714599, 252.2008514404297, 0, 0, 0, 1, 0]

ORBextractor.nFeatures: 1200
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""

FILES = {"KITTI00-02.yaml": KITTI, "TUM1.yaml": TUM1_RGBD, "EuRoC.yaml": EUROC}


@pytest.mark.parametrize("name", list(FILES))
def test_settings_match_the_jax_loader(tmp_path, name):
    path = tmp_path / name
    path.write_text(FILES[name])
    got = load_settings(str(path))
    ref = jax_load_settings(str(path))
    assert got.cam._asdict() == ref.cam._asdict()
    assert dataclasses.asdict(got.orb) == dataclasses.asdict(ref.orb)
    for field in ("fps", "rgb", "th_depth_factor", "depth_map_factor"):
        assert getattr(got, field) == getattr(ref, field), field
    for side in ("left_rect", "right_rect"):
        g, r = getattr(got, side), getattr(ref, side)
        assert (g is None) == (r is None)
        if g is not None:
            assert set(g) == set(r) == {"K", "D", "R", "P"}
            for k in g:
                np.testing.assert_array_equal(g[k], r[k])


def test_kitti_and_tum_operating_points(tmp_path):
    """The values the stereo and RGB-D operating points are taken from."""
    (tmp_path / "k.yaml").write_text(KITTI)
    (tmp_path / "t.yaml").write_text(TUM1_RGBD)
    k = load_settings(str(tmp_path / "k.yaml"))
    t = load_settings(str(tmp_path / "t.yaml"))
    assert (k.cam.width, k.cam.height, k.orb.n_features, k.th_depth_factor) == (1241, 376, 2000, 35.0)
    assert k.cam.bf == 386.1448 and k.cam.baseline == pytest.approx(0.5372, abs=1e-4)
    assert k.fps == 10.0
    assert (t.cam.width, t.cam.height, t.orb.n_features, t.th_depth_factor) == (640, 480, 1000, 40.0)
    assert t.depth_map_factor == 1.0 / 5000.0
    assert t.th_depth_factor * t.cam.baseline == pytest.approx(3.092, abs=1e-3)


def test_importing_the_loader_needs_no_yaml():
    """PyYAML is imported by load_settings alone: the package imports on a
    machine without it."""
    code = ("import sys; sys.modules['yaml'] = None\n"
            "import tpuslam_torch.io.settings as s\n"
            "try:\n"
            "    s.load_settings('missing.yaml')\n"
            "except ImportError:\n"
            "    print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
