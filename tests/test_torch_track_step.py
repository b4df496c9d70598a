"""The port's tracking step as a whole against the JAX package's
(__graft_entry__.entry_batched's step), on a coherent scene.

A frame is rendered at pose A; its keypoints, back-projected through A's
depth, are the last frame's points and the local map. The step tracks the
frame rendered at pose B (4 cm away) from A. Random inputs would leave pose
optimization with no inliers, so they prove nothing about it.

The JAX step runs under jit, where XLA:CPU fuses multiply-adds, so keypoints
can move by a pixel here and there: hence n_inl2 within 2% and the pose
within 1e-3 rather than bit equality.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from tpuslam_torch.convert import array_to_tensor
from tpuslam_torch.geometry.camera import PinholeCamera
from tpuslam_torch.ops.orb import ORBConfig
from tpuslam_torch.pipeline.track_step import track_step_batched
from tpuslam_torch.testing import (
    TRACK_STEP_ARGS,
    StepWallScene,
    coherent_track_inputs,
    orbit_trajectory,
    pose_errors,
)

sys.path.insert(0, str(Path(__file__).parent))
import synthetic  # noqa: E402  (the JAX package's scene, for the render check)

torch.set_num_threads(2)

CAM = PinholeCamera(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480)


@pytest.fixture(scope="module")
def coherent_inputs():
    scene = StepWallScene(np.random.default_rng(5))
    poses = orbit_trajectory(2, step=0.04)
    return coherent_track_inputs(
        scene, CAM, ORBConfig(n_features=1000), [(poses[0], poses[1])], 1000,
        np.random.default_rng(1),
    )


def test_track_step_matches_jax(coherent_inputs):
    inp = coherent_inputs
    step, _ = __graft_entry__.entry_batched(1, 1000)
    jR, jt, jn, jv = (np.asarray(x) for x in jax.jit(step)(*[jnp.asarray(inp[k]) for k in TRACK_STEP_ARGS]))
    R, t, n, nv = track_step_batched(
        CAM, ORBConfig(n_features=1000), *[array_to_tensor(inp[k], "cpu") for k in TRACK_STEP_ARGS]
    )
    assert int(nv) == int(jv)
    np.testing.assert_allclose(R.numpy(), jR, rtol=0, atol=1e-3)
    np.testing.assert_allclose(t.numpy(), jt, rtol=0, atol=1e-3)
    assert abs(int(n[0]) - int(jn[0])) <= 0.02 * int(jn[0])
    # The step does its job: many inliers, and the pose moves from A to B.
    t_err, r_err = pose_errors(R.numpy(), t.numpy(), inp["R_gt"], inp["t_gt"])
    t_err0, _ = pose_errors(inp["R0"], inp["t0"], inp["R_gt"], inp["t_gt"])
    assert int(n[0]) >= 300
    assert t_err0[0] > 0.035 and t_err[0] < 0.01 and r_err[0] < 0.2


def test_track_step_batch_equals_single(coherent_inputs):
    """Two streams in one call give what each gives alone."""
    inp = coherent_inputs
    cfg = ORBConfig(n_features=1000)
    one = track_step_batched(CAM, cfg, *[array_to_tensor(inp[k], "cpu") for k in TRACK_STEP_ARGS])
    two = track_step_batched(
        CAM, cfg, *[array_to_tensor(np.concatenate([inp[k]] * 2), "cpu") for k in TRACK_STEP_ARGS]
    )
    for a, b in zip(one[:3], two[:3]):
        torch.testing.assert_close(b[1], a[0], rtol=0, atol=1e-5)
    assert int(two[3]) == 2 * int(one[3])


def test_scene_renders_like_jax_package():
    from tpuslam_torch import testing as ttesting

    cam_s = PinholeCamera(fx=125.0, fy=125.0, cx=80.0, cy=60.0, width=160, height=120)
    jscene = synthetic.StepWallScene(np.random.default_rng(5))
    tscene = ttesting.StepWallScene(np.random.default_rng(5))
    for a, b in zip(jscene.textures, tscene.textures):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-2)
    for (jR, jt), (tR, tt) in zip(synthetic.orbit_trajectory(3), ttesting.orbit_trajectory(3)):
        np.testing.assert_allclose(tR, jR, rtol=0, atol=1e-6)
        np.testing.assert_allclose(tt, jt, rtol=0, atol=1e-6)
        img_j, z_j = jscene.render(cam_s, jR, jt, with_depth=True)
        img_t, z_t = tscene.render(cam_s, tR, tt, with_depth=True)
        np.testing.assert_allclose(img_t, img_j, rtol=0, atol=1e-2)
        np.testing.assert_allclose(z_t, z_j, rtol=0, atol=1e-2)
