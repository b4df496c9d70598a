"""Map checkpoints between the port and the JAX package, and the
map-once / localize-later slice as a whole.

A checkpoint is one np.savez_compressed of every MapState field in the JAX
package's format, so a map written by either package loads into the other
bit for bit. The slice: a 14-frame stereo map (tests/test_checkpoint_viz.py's
scenario, built here with the port, which keeps JAX out of the build) is
saved once; the JAX System and the port's System on the CPU each load it and
localize frame 7. A fresh System's loop closer has no database, so both take
the brute-force branch; the port replays the JAX tracker's key chain for its
EPnP hypotheses. Poses agree within 1 cm and 0.1 deg and the map does not
change.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.geometry.camera import PinholeCamera as JCamera
from tpuslam.io import checkpoint as jax_checkpoint
from tpuslam.mapstate import core as jax_core
from tpuslam.ops.orb import ORBConfig as JORBConfig
from tpuslam.pipeline import SensorType as JSensorType, System as JSystem
from tpuslam_torch.convert import map_to_numpy, map_to_torch
from tpuslam_torch.geometry.camera import PinholeCamera
from tpuslam_torch.io.checkpoint import load_map, save_map
from tpuslam_torch.mapstate.core import MapState, make_empty_map
from tpuslam_torch.ops.orb import ORBConfig
from tpuslam_torch.pipeline.system import SensorType, System
from tpuslam_torch.pipeline.tracker import TrackingState
from tpuslam_torch.testing import StepWallScene, depth_session, orbit_trajectory, render_stereo_frames

torch.set_num_threads(2)

BASELINE_M = 0.12
CAM = PinholeCamera(fx=350.0, fy=350.0, cx=160.0, cy=120.0, bf=350.0 * BASELINE_M, width=320, height=240)
KW = dict(max_keyframes=20, max_points=5000)


def _random_fields(rng, K=5, N=12, P=40) -> dict:
    """Every MapState field with random values of its dtype and shape
    (descriptors as the JAX package's uint32 words, watermarks 0-d)."""
    out = {}
    for name, x in zip(MapState._fields, make_empty_map(K, N, P, "cpu")):
        a = x.numpy()
        if name.endswith("desc"):
            out[name] = rng.integers(0, 2**32, a.shape, dtype=np.uint32)
        elif a.dtype == np.bool_:
            out[name] = rng.uniform(size=a.shape) < 0.5
        elif a.dtype == np.int32:
            out[name] = rng.integers(-1, 1000, a.shape).astype(np.int32)
        else:
            out[name] = rng.normal(size=a.shape).astype(a.dtype)
    out["pt_max_dist"][:3] = np.inf
    return out


def _assert_bits(got: dict, want: dict):
    assert set(got) == set(want)
    for name in want:
        a, b = np.asarray(got[name]), np.asarray(want[name])
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


def test_jax_written_map_loads_into_the_port_bit_for_bit(tmp_path, rng):
    fields = _random_fields(rng)
    p = str(tmp_path / "jax_map.npz")
    jax_checkpoint.save_map(jax_core.MapState(**{k: jnp.asarray(v) for k, v in fields.items()}), p)
    m = load_map(p, device="cpu")
    assert m.n_kf.shape == () and m.n_kf.dtype == torch.int32 and m.kf_kp_desc.dtype == torch.int32
    _assert_bits(map_to_numpy(m)._asdict(), fields)


def test_port_written_map_loads_into_jax_bit_for_bit(tmp_path, rng):
    fields = _random_fields(rng)
    p = str(tmp_path / "port_map.npz")
    save_map(map_to_torch(MapState(**fields), "cpu"), p)
    _assert_bits({k: np.asarray(v) for k, v in jax_checkpoint.load_map(p)._asdict().items()}, fields)
    with np.load(p) as z:  # the file itself is the JAX package's format
        _assert_bits({k: z[k] for k in z.files}, fields)


def test_old_files_take_the_jax_defaults(tmp_path, rng):
    """A file written before the culled-keyframe spanning tree existed:
    kf_parent -1, kf_rel_R identity, kf_rel_t zero, as JAX loads it; an
    int64 watermark becomes 0-d int32."""
    fields = _random_fields(rng)
    old = {k: v for k, v in fields.items() if k not in ("kf_parent", "kf_rel_R", "kf_rel_t")}
    old["n_pt"] = np.asarray(17, np.int64)
    p = str(tmp_path / "old.npz")
    np.savez_compressed(p, **old)
    got = map_to_numpy(load_map(p, device="cpu"))._asdict()
    want = {k: np.asarray(v) for k, v in jax_checkpoint.load_map(p)._asdict().items()}
    _assert_bits(got, want)
    assert (got["kf_parent"] == -1).all() and got["n_pt"] == 17 and got["n_pt"].dtype == np.int32


@pytest.fixture(scope="module")
def mapped(tmp_path_factory):
    """The 14-frame stereo map, built by the port on the CPU and saved."""
    scene = StepWallScene(np.random.default_rng(5))
    poses = orbit_trajectory(14, step=0.05)
    frames = render_stereo_frames(scene, CAM, poses)
    system = System(CAM, SensorType.STEREO, orb=ORBConfig(n_features=400), device="cpu",
                    kf_max_frames=6, **KW)
    res = depth_session(system, frames)
    assert system.map_stats()["state"] == "OK" and all(out is not None for out, _ in res)
    p = str(tmp_path_factory.mktemp("ckpt") / "map.npz")
    system.save_map(p)
    return system, frames, poses, p


def replay_jax_keys(tracker):
    """The JAX tracker's hypotheses: split its key (PRNGKey(0)) once per
    solver call, then randint in [0, max(n_valid, k))."""
    key = [jax.random.PRNGKey(0)]

    def draw(n_hyp, size, valid):
        key[0], k = jax.random.split(key[0])
        hi = max(int(valid.sum()), size)
        return torch.from_numpy(np.array(jax.random.randint(k, (n_hyp, size), 0, hi)))

    tracker._draw_picks = draw


def _angle_deg(Ra, Rb) -> float:
    d = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    w = np.array([d[2, 1] - d[1, 2], d[0, 2] - d[2, 0], d[1, 0] - d[0, 1]]) / 2
    return float(np.degrees(np.arcsin(min(1.0, np.linalg.norm(w)))))


def test_the_loaded_map_localizes_as_the_jax_system_does(mapped):
    system, frames, poses, p = mapped
    L, R = frames[7]
    js = JSystem(JCamera(**CAM._asdict()), JSensorType.STEREO, orb=JORBConfig(n_features=400), **KW)
    js.load_map(p, localization=True)
    want = js.track_stereo(jnp.asarray(L.numpy()), jnp.asarray(R.numpy()), 99.0)

    port = System(CAM, SensorType.STEREO, orb=ORBConfig(n_features=400), device="cpu", **KW)
    replay_jax_keys(port.tracker)
    port.load_map(p, localization=True)
    tr = port.tracker
    assert tr.state == TrackingState.LOST and tr.localization_mode
    assert tr._n_kf_host == int(system.tracker.map.n_kf)
    before = map_to_numpy(tr.map)
    got = port.track_stereo(L, R, 99.0)
    assert want is not None and got is not None
    assert tr.reloc_path == "brute_force" and tr.state == TrackingState.OK
    assert tr.loop_closer.db is None  # nothing enrolled, as in the JAX tracker

    C = [-np.asarray(Rc).T @ np.asarray(tc) for Rc, tc in (want, got)]
    assert np.linalg.norm(C[0] - C[1]) < 0.01
    assert _angle_deg(want[0], got[0]) < 0.1
    Rg, tg = poses[7]
    assert np.linalg.norm(C[1] - (-Rg.T @ tg)) < 0.05
    for name, a, b in zip(MapState._fields, map_to_numpy(tr.map), before):
        assert a.tobytes() == b.tobytes(), name
    assert int(tr.map.n_kf) == int(system.tracker.map.n_kf)


def test_load_map_refuses_other_capacities(mapped):
    _, _, _, p = mapped
    other = System(CAM, SensorType.STEREO, orb=ORBConfig(n_features=400), device="cpu",
                   max_keyframes=16, max_points=5000)
    with pytest.raises(ValueError, match="capacities"):
        other.load_map(p)
