"""The comparison that decides `correct`, at a size the CPU holds.

- The control (the plain reference in the program's place, in bfloat16)
  comes out not correct, where the float32 reference in its place reads
  every number at 0 or below the limits.
- A run of the harness without a card (the stereo cell at half KITTI
  resolution, small map capacities) comes out correct with the program as
  it is, and not correct with its timed path broken underneath: a step
  that returns its state unchanged, an answer altered where it is
  produced, a kernel's output altered.
"""

import json
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import control, correct, manifest, program
from benchmark.reference import points as ref_pt
from benchmark.session import Run
from benchmark.traffic import routes
from benchmark.traffic.frames import FrameSource
from benchmark.traffic.scene import Corridor

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 4242
# Limits of the half-size CPU session: its sound run reads rpe_t ~0.2,
# rpe_r_deg ~0.2 (half the resolution, a coarser stereo depth) and
# pt_depth_err ~0.009; a state handed back unchanged reads rpe_t ~1, an
# answer moved by 0.1 m ~0.5, points moved 10% ~0.1. Its window holds too
# few keyframes for kf_rpe_*, which test_keyframe_numbers checks on a
# synthetic map.
SMALL_LIMITS = {"rpe_t": 0.35, "rpe_r_deg": 0.5, "pt_depth_err": 0.03, "fast_diff": 0, "patch_diff": 0}
SMALL_AT_LEAST = {"map_kf": 2, "map_pt": 200}


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """A copy of the benchmark whose stereo cell runs on the CPU: half
    KITTI's resolution and features, 16 keyframes, 8192 points."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "benchmark", root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    cfg_p = root / "benchmark" / "configs" / "kitti_stereo.json"
    cfg = json.loads(cfg_p.read_text())
    cam = cfg["camera"]
    cfg["camera"] = dict(fx=cam["fx"] / 2, fy=cam["fy"] / 2, cx=cam["cx"] / 2, cy=cam["cy"] / 2,
                         bf=cam["bf"] / 2, width=620, height=188)
    cfg["orb"]["n_features"] = 1000
    cfg["tracker"].update(max_keyframes=16, max_points=8192, enable_loop_closing=False)
    cfg_p.write_text(json.dumps(cfg))
    wl_p = root / "benchmark" / "workloads" / "kitti_stereo.drive.json"
    wl = json.loads(wl_p.read_text())
    wl["scene"].update(n_bands=32, ssaa=1)
    wl["route"].update(x0=-30.0, speed=0.4)
    wl.update(warmup={"min_frames": 3, "max_frames": 50}, kernel_sample=1, limits=SMALL_LIMITS,
              at_least=SMALL_AT_LEAST)
    wl_p.write_text(json.dumps(wl))
    program.load(build=False)
    return manifest.Manifest(root=root, bench_dir=root / "benchmark")


def _run(man, seconds=12.0):
    r = Run(man, man.cell("kitti_stereo.drive"), SEED, seconds, False, time.perf_counter(), device="cpu")
    return r.execute("cpu")


def test_control_fails_and_the_float32_reference_passes(small):
    cell = small.cell("kitti_stereo.drive")
    r = control.readings(small, cell, SEED, n_frames=12, kf_every=3, device="cpu")
    ok, rows = correct.decide(r, cell["limits"])
    assert not ok
    assert r["fast_diff"] > 0 and r["patch_diff"] > 0 and r["rpe_t"] > 0.1
    assert r["pt_depth_err"] > 1e-3  # at this size bfloat16 pixels round less than at the cell's
    # The float32 reference in the program's place reads nothing.
    cfg = small.config(cell["config"])
    scene = Corridor(SEED, device="cpu", **cell["scene"])
    src = FrameSource(scene, cfg["camera"], cell["route"], cfg["camera"]["bf"] / cfg["camera"]["fx"])
    k = correct.kernel_numbers(src.render(7, 1), cfg["orb"], None, torch.float32, "cpu")
    assert k == {"fast_diff": 0, "patch_diff": 0}
    ids = np.arange(3, 15)
    Rg, tg = routes.poses(cell["route"], ids)
    n, _ = correct.pose_numbers(ids, Rg, tg, Rg, tg, 0.4, True)
    assert n["rpe_t"] < 1e-9 and n["rpe_r_deg"] < 1e-5


def test_the_program_as_it_is_is_correct(small):
    res, rows = _run(small)
    assert res["correct"], rows
    assert res["attempted"] > 2 and res["failed"] == 0
    assert list(res)[-1] == "checks" and set(res["checks"]) == set(SMALL_LIMITS) | set(SMALL_AT_LEAST)
    assert set(res["metrics"]) == {"frames_per_s", "frame_ms_p50", "frame_ms_p95", "setup_s"}


def _broken_track(kind):
    real = program.track
    state = {}

    def track(system, views, ts):
        out = real(system, views, ts)
        if out is None:
            return out
        if kind == "unchanged":  # the step hands back the state it was given
            out = state.setdefault("first", out)
        elif kind == "altered":  # every answer moved where it is produced
            state["k"] = state.get("k", 0) + 1
            out = (out[0], out[1] + np.float32([0.1 * (-1) ** state["k"], 0.0, 0.0]))
        return out
    return track


@pytest.mark.parametrize("kind", ["unchanged", "altered"])
def test_a_broken_step_is_not_correct(small, monkeypatch, kind):
    monkeypatch.setattr(program, "track", _broken_track(kind))
    res, rows = _run(small)
    assert not res["correct"], rows
    assert res["checks"]["rpe_t"]["value"] > SMALL_LIMITS["rpe_t"]


def test_points_altered_where_the_keyframe_job_made_them_are_not_correct(small, monkeypatch):
    """The map's points each moved 10% off the first keyframe's camera
    after the window: pt_depth_err catches it."""
    real = program.map_host

    def map_host(system):
        m = system.tracker.map
        C = -(m.kf_R[0].T @ m.kf_t[0])
        m.pt_xyz.copy_(C + 1.1 * (m.pt_xyz - C))
        return real(system)

    monkeypatch.setattr(program, "map_host", map_host)
    res, rows = _run(small, seconds=4.0)
    assert not res["correct"], rows
    assert res["checks"]["pt_depth_err"]["value"] > SMALL_LIMITS["pt_depth_err"]


def test_an_emptied_map_is_not_correct(small, monkeypatch):
    """Keyframes culled and points dropped after the window: the fill's
    least numbers catch it."""
    real = program.map_host

    def map_host(system):
        m = system.tracker.map
        m.pt_valid[100:] = False
        return real(system)

    monkeypatch.setattr(program, "map_host", map_host)
    res, rows = _run(small, seconds=4.0)
    assert not res["correct"] and res["checks"]["map_pt"]["value"] < SMALL_AT_LEAST["map_pt"]
    assert res["checks"]["map_pt"]["sense"] == "at_least"


def test_an_altered_kernel_output_is_not_correct(small, monkeypatch):
    import tpuslam_torch.ops.fast as fast_mod

    real = fast_mod.fast_nms_pyramid

    def fast(levels, th):
        out = real(levels, th)
        out[0].view(-1)[12345] += 1.0
        return out

    monkeypatch.setattr(fast_mod, "fast_nms_pyramid", fast)
    res, rows = _run(small, seconds=1.0)
    assert not res["correct"] and res["checks"]["fast_diff"]["value"] >= 1


@pytest.mark.parametrize("metric", [True, False])
def test_keyframe_numbers(metric):
    """The keyframes of a map against the truth: the truth itself reads 0;
    the truth in another world frame (and, monocular, another scale) too;
    keyframes left where they were made (unchanged) or each moved read
    large."""
    route = {"x0": 2.0, "speed": 0.1, "yaw_rate": 0.01, "yaw_amp": 0.15, "bob": 0.01}
    fid = np.arange(100, 160, 4)
    Rg, tg = routes.poses(route, fid)

    def truth_of(ids):
        return routes.poses(route, ids)

    def numbers(R, t):
        m = {"kf_valid": np.ones(len(fid), bool), "kf_frame_id": fid, "kf_R": R, "kf_t": t}
        return correct.keyframe_numbers(m, 100, truth_of, metric)[0]

    # Another world: x_w' = s W x_w + c, so T_cw' = (R W^T, s t - R W^T c).
    W = routes._so3_y(torch.tensor([0.7], dtype=torch.float64))[0].numpy()
    s, c = (1.0 if metric else 3.0), np.array([5.0, -1.0, 2.0])
    R2 = Rg @ W.T
    t2 = s * tg - np.einsum("nij,j->ni", R2, c)
    for R, t in ((Rg, tg), (R2, t2)):
        n = numbers(R, t)
        assert n["kf_rpe_t"] < 1e-9 and n["kf_rpe_r_deg"] < 1e-5
    stuck = numbers(np.repeat(Rg[:1], len(fid), 0), np.repeat(tg[:1], len(fid), 0))
    assert stuck["kf_rpe_t"] > 0.9
    moved = numbers(Rg, tg + np.float64([0.0, 0.05, 0.05]) * (-1) ** np.arange(len(fid))[:, None])
    assert moved["kf_rpe_t"] > 0.2


@pytest.mark.parametrize("metric", [True, False])
def test_point_numbers(metric):
    """Points on the true surface, seen from the true keyframes, read 0
    (in another world frame, and monocular at another scale, too);
    triangulated in float64 they read ~0, in bfloat16 far more; points
    moved off the surface read their move."""
    scene = Corridor(7, 16, [3.5, 5.0, 4.2, 6.5, 3.8, 5.8, 4.6, 7.0], 1.2, 60.0, ssaa=1, device="cpu")
    cam = dict(fx=130.0, fy=130.0, cx=80.0, cy=60.0, width=160, height=120, bf=39.0)
    route = {"x0": -3.0, "speed": 0.05, "yaw_rate": 0.01, "yaw_amp": 0.15, "bob": 0.01}
    fid = np.arange(10, 40, 5)
    Rg, tg = routes.poses(route, fid)
    rng = np.random.default_rng(0)
    X = np.concatenate([ref_pt.surface_points(Rg[k], tg[k], cam, scene.depths, scene.x_lo, scene.band, 50, rng)
                        for k in range(len(fid))])
    obs = np.arange(len(X)).reshape(len(fid), 50)
    s = 1.0 if metric else 0.3
    m = {"kf_valid": np.ones(len(fid), bool), "kf_frame_id": fid, "kf_R": Rg, "kf_t": s * tg,
         "kf_obs_pt": obs, "pt_valid": np.ones(len(X), bool), "pt_xyz": s * X}

    def num(mm):
        return correct.point_numbers(mm, 10, lambda f: routes.poses(route, f), scene, metric)[0]["pt_depth_err"]

    assert num(m) < 1e-9
    off = np.float64([0.0, 0.0, 0.3]) * (-1) ** np.arange(len(X))[:, None]
    assert num(dict(m, pt_xyz=s * (X + off))) > 0.03
    b = control._points(scene, cam, route, fid, metric, 3)
    m2 = dict(m, kf_t=s * tg, pt_xyz=s * b["pt_xyz"], kf_obs_pt=b["kf_obs_pt"], pt_valid=b["pt_valid"])
    assert num(m2) > 1e-3  # the control's bfloat16 points; below, float64 gives them back
    # In float64, from the true poses and pixels, both give the points back.
    uv = ref_pt.project(Rg[0], tg[0], X[:50], cam)
    if metric:
        ur = ref_pt.project(Rg[0], tg[0] - np.float64([cam["bf"] / cam["fx"], 0.0, 0.0]), X[:50], cam)[:, 0]
        Xt = ref_pt.stereo_points(Rg[0], tg[0], uv, ur, cam)
    else:
        Xt = ref_pt.triangulate(Rg[0], tg[0], Rg[1], tg[1], uv, ref_pt.project(Rg[1], tg[1], X[:50], cam), cam)
    assert np.abs(Xt - X[:50]).max() < 1e-9
