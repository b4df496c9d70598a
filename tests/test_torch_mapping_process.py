"""The port's mapping process (tpuslam_torch/parallel/mapping_worker.py) on
the CPU: snapshots shipped to a worker process over pipes, the results and
the worker's BoW rows adopted by the tracker.

- One keyframe job in the worker equals the same job in process, to the
  bit (the worker takes the caller's CPU thread count); after the worker's
  reset the same job gives the same bits again.
- tests/test_mapping_process.py's stereo scenario (320x240, 400 features,
  24 keyframes, 6000 points, kf_max_frames 8, 16 frames) with
  mapping_process_platform="cpu", under its gates: OK, > 150 points,
  >= 14 frames tracked, rigid ATE < 0.06 m; the worker's BoW rows and
  vocabulary mirrored into the tracker's loop closer; shutdown closes the
  process.
- An interrupt tagged with a finished job's id is dropped; the child
  imports no jax; a worker asked for a card it does not find raises.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpuslam_torch.geometry.camera import PinholeCamera
from tpuslam_torch.ops.orb import ORBConfig
from tpuslam_torch.parallel.mapping_worker import RemoteMappingWorker
from tpuslam_torch.pipeline.system import SensorType, System
from tpuslam_torch.pipeline.tracker import Tracker, TrackerConfig
from tpuslam_torch.testing import (
    StepWallScene,
    depth_session,
    orbit_trajectory,
    render_stereo_frames,
    trajectory_ate,
)

torch.set_num_threads(2)

BASELINE_M = 0.12
CAM = PinholeCamera(fx=350.0, fy=350.0, cx=160.0, cy=120.0, bf=350.0 * BASELINE_M, width=320, height=240)
KW = dict(orb=ORBConfig(n_features=400), max_keyframes=24, max_points=6000, kf_max_frames=8)


@pytest.fixture(scope="module")
def process_run():
    poses = orbit_trajectory(16, step=0.05)
    system = System(CAM, SensorType.STEREO, device="cpu", mapping_process=True,
                    mapping_process_platform="cpu", **KW)
    rm = system.tracker._remote_mapper
    process, kept = rm.process, []

    def keep_first(m, ki, depth_mode):  # the snapshot of the first job shipped
        if not kept:
            kept.append((m, ki))
        return process(m, ki, depth_mode)

    rm.process = keep_first
    try:
        depth_session(system, render_stereo_frames(StepWallScene(np.random.default_rng(5)), CAM, poses))
        trajectory = system.tracker.export_trajectory()
        yield system, poses, trajectory, kept
    finally:
        system.shutdown()


def test_stereo_session_with_a_mapping_process(process_run):
    system, poses, trajectory, _ = process_run
    tr = system.tracker
    stats = system.map_stats()
    assert stats["state"] == "OK" and stats["n_points"] > 150
    ate, n, _ = trajectory_ate(trajectory, poses, fix_scale=True)
    assert n >= 14 and ate < 0.06, (n, ate)
    assert tr._mapping_future is None
    jobs = tr._remote_mapper.jobs
    assert len(jobs) == tr.metrics.counters["frames.keyframe"] >= 1
    assert all(j["bytes_out"] > 0 and j["bytes_in"] > 0 and j["worker"]["compute_ms"] > 0 for j in jobs)


def test_bow_rows_are_mirrored_into_the_tracker(process_run):
    tr = process_run[0].tracker
    lc = tr.loop_closer
    assert lc.voc is not None and lc.db is not None and lc._bow
    fid = tr.map.kf_frame_id.numpy()
    for slot, bow in lc._bow.items():
        assert bool(lc.db.has[slot]) and lc._slot_fid[slot] == fid[slot]
        assert torch.equal(lc.db.words[slot], bow.words) and torch.equal(lc.db.weight[slot], bow.weight)


def test_the_worker_imports_no_jax(process_run):
    info = process_run[0].tracker._remote_mapper.info
    assert info["foreign_modules"] == [] and info["device"] == "cpu" and info["startup_s"] > 0


def test_worker_job_equals_the_job_in_process(process_run):
    """The first keyframe job's snapshot through a fresh worker and through
    a fresh tracker's _mapping_compute; then the worker reset and the job
    again."""
    m, ki = process_run[3][0]
    cfg = process_run[0].tracker.cfg
    ref = Tracker(dataclasses.replace(cfg, mapping_process=False), device="cpu")
    ref._depth_mode = True
    want = ref._mapping_compute(m, ki)
    rm = RemoteMappingWorker(cfg, device="cpu")
    try:
        got, remap, rows, voc = rm.process(m, ki, True)
        for name, a, b in zip(want._fields, got, want):
            assert torch.equal(a, b), name
        assert remap is None and voc is not None
        assert [r[0] for r in rows] == sorted(ref.loop_closer._bow)
        # A stale interrupt (job 1 is over) is dropped: the next job runs
        # both local-BA chunks.
        rm.interrupt()
        rm.reset()
        again, _, rows2, voc2 = rm.process(m, ki, True)
        assert not rm.jobs[-1]["worker"]["ba2_skipped"]
        for name, a, b in zip(want._fields, again, want):
            assert torch.equal(a, b), name
        assert [r[0] for r in rows2] == [r[0] for r in rows] and voc2 is None  # rows again, vocabulary once
    finally:
        rm.close()
    assert rm._proc.poll() is not None


def test_shutdown_closes_the_process():
    system = System(CAM, SensorType.STEREO, device="cpu", mapping_process=True,
                    mapping_process_platform="cpu", enable_loop_closing=False, **KW)
    proc = system.tracker._remote_mapper._proc
    system.reset()  # the worker's state cleared over the pipe
    system.shutdown()
    assert system.tracker._remote_mapper is None and proc.poll() is not None


def test_a_worker_asked_for_the_card_without_one_raises():
    if torch.cuda.is_available():
        pytest.skip("needs a host without a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RemoteMappingWorker(TrackerConfig(cam=CAM, **KW), device="cuda")


def test_an_unknown_platform_is_refused():
    with pytest.raises(ValueError, match="mapping_process_platform"):
        Tracker(TrackerConfig(cam=CAM, mapping_process=True, mapping_process_platform="tpu", **KW), device="cpu")
