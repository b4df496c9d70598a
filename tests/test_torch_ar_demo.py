"""The port's AR demo (tpuslam_torch/examples/ar_demo.py) on the CPU:
45 frames through the live runner, a plane from the well-observed map
points (in 20 frames, the demo's default, neither package's map has 50
points seen three times), and a cube drawn on the tracked frames."""

import numpy as np
import torch
from PIL import Image

from tpuslam_torch.examples import ar_demo

torch.set_num_threads(2)


def test_ar_demo_finds_a_plane_and_draws(tmp_path):
    plane, n_out = ar_demo.run(45, str(tmp_path), device="cpu")
    assert plane is not None and bool(plane.success)
    # StepWallScene's slabs face the camera: the plane is one of them.
    assert abs(float(plane.normal[2])) > 0.99 and int(plane.inliers.sum()) >= 20
    assert n_out > 20 and len(list(tmp_path.glob("ar_*.png"))) == n_out
    img = np.asarray(Image.open(sorted(tmp_path.glob("ar_*.png"))[-1]))
    assert ((img[..., 0] > 200) & (img[..., 1] < 100)).sum() > 20  # the red wireframe
