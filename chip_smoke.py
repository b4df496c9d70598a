"""Smoke run of the PyTorch port's main path on one CUDA card.

    python3 chip_smoke.py

Phases, any failure exits non-zero:
  1. device: a CUDA card is required (no CPU run); prints the card's name
     and power limit as nvidia-smi gives them;
  2. build: compiles csrc/*.cu with nvcc (tpuslam_torch/_build.py);
  3. kernels: each CUDA kernel against its plain PyTorch version on the card
     at the main path's shapes, required equal (torch.equal): fast_nms over
     the 8 levels of B=4 in one launch and over a ragged two-level set;
     gather_patches on the uint8 and float32 atlases at 4, 5, 4000 and 4001
     windows; then a child process whose window leaves the atlas must die
     of the kernel's device-side assert;
  pose kernel: pose_optimization's kernel (csrc/pose_lm.cu) against
     pose_optimization_plain on the same card tensors at the frame step's
     shapes (B=1 N=4000 stereo and mono edges, B=1 N=2000 mono, B=4 N=2000
     mono; KITTI's camera): poses within 1e-4, masks equal but on edges
     within a relative 1e-4 of their chi2 threshold; then the times of
     both in turns (per call and the device's alone), the kernel at one
     edge (its latency floor), the bytes and flops bound, and the device
     time per LM iteration;
  4. slice: track_step_batched at 640x480, 1000 ORB features, B=4 streams,
     L=4096 local-map points on a coherent synthetic scene, through a
     StepGraphs (the step one CUDA graph, captured at the first call); every
     kernel must have launched, each stream must land on its ground-truth
     pose, the same inputs through the port on the CPU must agree, and the
     step run eagerly must be torch.equal to the graphed one (ms per step
     both ways in turns, host API calls, device->host reads, the capture);
  map slice: the per-frame step the tracker runs, fused_track_frame_image
     through a StepGraphs as the tracker runs it (phase graphs runs every
     frame eagerly too), over a MapState at the tracker's default
     capacities (1536 keyframes, 2000 keypoint slots, 200,000 points; local
     subset 16384, candidate cap 8192), along a session built by
     testing.build_depth_session: every frame accepted within 1 cm / 0.2
     deg of ground truth, both branches taken, both kernels launched on
     every frame and pose_optimization's at least twice (mm or ref, then
     local), and one mid-session state through the port on the CPU
     agreeing with the card;
  graphs: the map slice's 161-frame path again, each frame's step run
     both ways in turns on the same state: eagerly (fused_track_frame_image)
     and through StepGraphs (pipeline/graphs.py: each segment of the step a
     captured CUDA graph, replayed); every output torch.equal on every
     frame, the frames counted by branch (reference keyframe without a
     velocity, motion model, the th=14 retry, the reference keyframe after
     a failed motion model), ms per frame both ways, and on the late
     snapshots per branch: CUDA-event ms in turns, device->host reads (no
     more than eager) and host API calls per frame (kernel launches, graph
     launches and copies, under 100 graphed); each capture's ms and
     instantiation ms, graph nodes and kernel nodes per segment, the
     graph pool's and the static buffers' bytes, and the device ms of the
     copy-in of a replaced map. Every session phase below runs through the
     tracker's graphs (the card's path) and prints its graph_replays and
     graph_captures; each fails unless every steady-state frame replayed.
     Each also prints its map_graph_replays and map_graph_captures (the
     keyframe jobs through tracker.map_graphs: mapping_front's six
     segments, the local-BA chunks, the normals, compaction), their
     captures' ms and kernel nodes, the pool's and buffers' bytes, and the
     keyframe frame by stage over the jobs that captured nothing; each fails
     unless every keyframe job replayed every segment (a capture replays at
     once), with at most 9 mapping captures (the mapping process: the
     worker's counts). Each also prints its gba_iters, gba_graph_replays
     and gba_graph_captures (the global BA's LM iterations, each one
     optim/ba.py's lm_step replayed) and fails unless every LM iteration
     replayed; the mono and async mono phases run the session's initial
     global BA again from its input both ways (torch.equal, ms, reads,
     host API calls per LM iteration under 50, no new capture);
  5. times: CUDA-event medians of 20 runs after warm-up, in turns, for the
     kernels against their plain versions (and gather_patches against one
     aten::index call) at B=4 and B=1, per call and as the device's time
     alone, track_step_batched and fused_track_frame_image (with its
     launches and device->host reads per frame: 1 on a motion-model frame,
     the verdict, and 0 on a reference-keyframe frame, or the run fails);
  6. mono SLAM: the port's System.track_monocular on the card at the
     tracker's default capacities (1536 keyframes, 2000 keypoint slots,
     200,000 points) and default TrackerConfig (loop closing on: the shipped
     100k-word vocabulary, detection on every keyframe), over 100 frames of the map slice's
     trajectory: it must initialize within the first 10 frames, end OK,
     track >= 95% of the frames after initialization, hold >= 10 valid
     keyframes with points that mapping_front made, keep the Sim3-aligned
     ATE below 3% of the path's span, launch FAST+NMS and the gather on
     every frame and the pose kernel at least twice on every tracked frame
     (mm or ref, then local), and close no loop (the path revisits nothing); the loop stage's
     ms and device->host reads per keyframe are printed. Then, on the
     finished map: device->host reads of a motion-model
     and a reference-keyframe frame (<= 2 and <= 1, or the run fails) and of
     one keyframe job, that job (Tracker._mapping_compute on a mid-session
     snapshot) on the CPU against the card, and a forced LOST relocalized
     from an earlier frame at its true place through the BoW database's
     keyframe candidates (the brute-force branch must not run; it is then
     timed alone on the same frame for comparison); the first call pays the
     relocalization's captures, then the same relocalization from the same
     state runs eagerly and graphed in turns (torch.equal, ms both ways,
     reads no more than eager, host API calls). Prints ms per frame by branch,
     the keyframe frames split by stage, global BA, relocalization, the
     peak memory allocated (the session, one frame, one keyframe job and
     its stages, the relocalization) and a profile of the keyframe job and
     of the relocalization.
  stereo kernels: FAST+NMS over the 8 levels of a KITTI-sized (2, 376,
     1241) stereo batch in one launch and the gather on its 1257-byte-wide
     atlas at the describe and at the SAD windows, each torch.equal to its
     plain version, then timed as in phase 5;
  stereo SLAM: System.track_stereo at KITTI00-02.yaml's operating point
     (1241x376, 2000 features, ThDepth 35, kf_max_frames 10, loop closing
     on) at the default capacities over 60 rectified pairs of a 4x-scale StepWallScene, the
     right image rendered 0.537 m along the camera's x axis: initialized on
     the first frame, OK at the end, >= 95% tracked, the span within 5% and
     the rigid ATE below 3% of it, the kernels on every frame as in mono
     SLAM, no loop
     closed (the loop stage's ms and reads per keyframe printed). Prints ms per
     frame by kind (the keyframe frames split into the stereo front end,
     mapping_front, the local-BA chunks and the rest), the front end alone
     (it must make no device->host read), reads by frame kind, peak memory,
     one frame's front end on the CPU against the card, then localization
     mode over 20 frames past the mapped region (the map must not change,
     >= 75% tracked, each tracked frame through the pose kernel; whether VO
     mode engaged), each frame eagerly and
     graphed from the same state (torch.equal, ms both ways), and the last
     frame again forced into mbVO (the motion model and the relocalization)
     both ways;
  RGB-D SLAM: System.track_rgbd at TUM1.yaml's operating point (640x480,
     1000 features, ThDepth 40, depth as uint16 at 5000 per metre; zero
     distortion: the renderer is a pinhole) over 60 frames of a StepWallScene
     at half depth, so keypoints lie on both sides of th_depth (3.09 m):
     the same gates and prints;
  mapping graphs (after RGB-D SLAM): Tracker._mapping_compute both ways
     from the same state (tracker.map_graphs replayed against
     map_graphs.run = steps.call_segment), 3 runs each in turns, on
     trackers of each session's config with loop closing off (the loop
     stage is eager both ways): the mono session's keyframe jobs 2, 45 and
     85 (kept on the host), job 85 again with its watermark forced to
     capacity (point compaction, graphed), and job 1 of the stereo and the
     RGB-D session. Every MapState
     field and the point remap torch.equal, no more device->host reads
     graphed than eager, at most 9 mapping captures a tracker, or the run
     fails. Prints per job: wall ms both ways and by stage (stage syncs on),
     reads, bytes copied into the static buffers, the first run's
     captures; for job 85 and the stereo job host API calls, peak memory
     and each stage alone under the profiler (device ms, wall ms, launches)
     both ways; per tracker the pool's and buffers' bytes and the device ms
     of a whole map's copy-in;
  MultiTracker: track_stereo over 2 KITTI-sized streams for 12 frames, one
     FAST+NMS launch per batched extraction of the 4 images (the batched
     front end one CUDA graph), past the first frame at least two pose
     kernels a stream, every frame of every stream tracked within
     the stereo gates, each frame first run eagerly and graphed from the
     same state (every stream's state torch.equal, ms both ways) (RGB-D and
     MultiTracker keep loop closing off, so the phases stay inside the time
     limit);
  place: the shipped 100k-word (k=10, L=5) and 1M-word (k=10, L=6)
     vocabularies on the card; view A of each of the 260 places of
     tpuslam/data/place_eval.npz enrolled in a SparseKeyFrameDatabase, view B
     queried (place/evaluate.py, the port's copy of
     tools/eval_place_recognition.py): the 100k tree must reach recall@1
     >= 0.85, recall@5 >= 0.92 and a positive mean margin
     (tests/test_place_scale.py's gates); the 1M tree's are reported. Prints
     ms per sparse_bow_vector of 1,000 and 2,000 descriptors for each tree
     and ms per query at 1,536 enrolled slots;
  loop: LoopCloser.on_keyframe on every keyframe of testing.build_loop_map
     at the tracker's default capacities (1536 keyframes, 2000 keypoint
     slots, 200,000 points): 240 keyframes on the circle, the last 3
     revisiting clusters 0 and 1, the shipped 100k vocabulary, the port's
     global BA after a closure. 240 live keyframes take the essential graph
     through the block-Jacobi CG over all 1536 slots. The drift per
     keyframe is the 16-keyframe test map's total (16 x 1.2%) spread over
     the 240 keyframes: at 1.2% per keyframe the 240-keyframe loop drifts
     2.9 rad, which the odometric gate rightly vetoes. At least one loop
     must close, the loop end's camera-centre error after the correction
     must be below half of that before, a 64-keyframe map without revisit
     or drift must close none, and the closing keyframe rerun on the CPU
     from the card's state just before it must pick the same candidate and
     land within 1 cm and 0.1 deg of the card's corrected poses; the
     closing keyframe rerun on the card from its snapshot graphed (the
     essential graph's GN steps and CG blocks through the closer's
     StepGraphs, the global BA's LM iterations through the tracker's
     map_graphs) and eager, twice each in turns, the second graphed run on
     the first's graphs: every MapState field and the point remap
     torch.equal, the reads equal, the second graphed run capturing
     nothing, host API calls under 300 per GN step and under 50 per LM
     iteration, or the run fails. Prints ms per keyframe without a
     candidate, the closing keyframe by stage (Sim3, fusion, the essential
     graph with its GN and CG iterations, the global BA) both ways, the
     captures, the pools' and buffers' bytes, one GN step profiled, reads
     per keyframe and peak memory.
  facade: the mono session's map (saved at the end of phase 6 with
     System.save_map, the JAX package's npz format) loaded into a fresh
     System on the card (and on the CPU, bit-equal), then 20 frames of the mono path localized against it: the
     first relocalized within 5 cm of the truth by the brute-force branch (a
     fresh System has no BoW database, as in the JAX package), >= 75%
     tracked, the map unchanged, each of the three kernels at least once a
     localized frame; one more frame
     under utils.metrics.torch_trace (a Chrome trace written, its launches
     counted); detect_plane and topdown_layout on the loaded 200,000-slot
     map and remap_bilinear of a 752x480 EuRoC pair, each on the card
     against the CPU (normals within 0.1 deg and equal inliers; equal edges
     and pixels within 1e-3; within 1e-4); then a 40-frame TUM RGB-D folder
     of the RGB-D phase's scene written without PIL (8-bit RGB, 16-bit
     depth at 5000 per metre) and run through examples.rgbd_tum with a
     LiveViewer attached (every 10 frames, /state read once over loopback):
     the RGB-D phase's gates, decode and track ms per frame, the viewer's ms
     and device->host reads per push.
  parallel: the mono session again with async_mapping (mapping and loop
     closing on a background thread with its own stream), fed at the
     camera's 30 fps (each frame's interval slept out, as ORB-SLAM2's
     examples feed a dataset), under the mono gates and drained by
     export_trajectory, the share of frames begun while a mapping job ran
     and the keyframes declined because of it, its ms per frame kind beside
     the synchronous session's, the job's ms on its thread, the keyframe
     insertions that waited on a join, InterruptBA and the second local-BA
     chunks skipped, synchronising calls per thread, peak memory; the
     async global BA on the 240-keyframe loop map at the default
     capacities (no drift, points moved by 2 cm): _schedule_gba returns at
     once, the job's 10 LM iterations all replay tracker.gba_graphs, the
     merge halves the mean reprojection error, a superseded run aborts at a
     chunk boundary and leaves the map unchanged; 30 stereo pairs at the stereo phase's point
     with mapping_process on the same card (the stereo gates, the worker's
     BoW rows in the tracker's loop closer, the worker importing no jax,
     bytes and ms per job for the copies, pickling and the pipe, the
     worker's start-up, shutdown closing the process); two BA shards and
     two map shards on the one card: both sharded solvers on a
     synthetic_ba_problem (K=64, P=16,384, 64 observations a keyframe) and
     on the loop map's global BA problem (and the tracker's own _global_ba
     through its point-sharded path) against the single-device solver (R
     within 1e-4, t and X within 1e-3), the bytes reduced per LM
     iteration, and on phase 6's saved map the sharded covisibility and
     projection search equal to the dense ones.
The host library (csrc_host/*.cc, g++ and zlib) is built in phase 2 too.
Each phase prints its wall time, and their sum at the end. The line
before the last is
{"kernels": [...]} (the launches of every phase's main-path run, and the
stereo shapes' times); the last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.request
import warnings
from pathlib import Path

import numpy as np
import torch

import tpuslam_torch._build as build
from tpuslam_torch.convert import array_to_tensor, map_to_numpy, map_to_torch
from tpuslam_torch.geometry.camera import PinholeCamera, project
from tpuslam_torch.geometry.se3 import se3_apply, se3_exp
from tpuslam_torch.mapstate.core import FrameFeatures, covisibility_weights, update_point_normals
from tpuslam_torch.matching.search import search_by_projection_points
from tpuslam_torch.ops.fast import fast_nms, fast_nms_plain, fast_nms_pyramid, fast_response
from tpuslam_torch.ops.image import build_pyramid, pyramid_shapes
from tpuslam_torch.ops.orb import (
    ORBConfig,
    ORBFeatures,
    detect_batched,
    extract_orb_batched,
    extract_orb_batched_atlas,
)
from tpuslam_torch.ops.patches import PSIZE, _gather_patches_cuda, gather_patches, gather_patches_plain
from tpuslam_torch.optim import pose_graph
from tpuslam_torch.optim.ba import bundle_adjustment
from tpuslam_torch.optim.pose import pose_optimization, pose_optimization_plain
from tpuslam_torch.parallel.dist_ba import distributed_bundle_adjustment, point_sharded_bundle_adjustment
from tpuslam_torch.parallel.sharded_map import sharded_covisibility_weights, sharded_search_local_points
from tpuslam_torch.ops.stereo import (
    _sad_refine_atlas,
    level_tables,
    row_band_match,
    sad_windows,
    stereo_match_atlas,
)
from tpuslam_torch.pipeline import loop_closing, steps
from tpuslam_torch.pipeline.loop_closing import LoopCloser
from tpuslam_torch.pipeline.multi import MultiTracker
from tpuslam_torch.pipeline.graphs import StepGraphs
from tpuslam_torch.pipeline.steps import fused_track_frame_image, local_keyframe_mask
from tpuslam_torch.pipeline.system import SensorType, System
from tpuslam_torch.pipeline.track_step import track_step_batched
from tpuslam_torch.place.database import SparseKeyFrameDatabase
from tpuslam_torch.place.evaluate import PLACE_EVAL_PATH, evaluate
from tpuslam_torch.place.vocabulary import (
    DEFAULT_VOCAB_1M_PATH,
    DEFAULT_VOCAB_PATH,
    Vocabulary,
    sparse_bow_vector,
)
from tpuslam_torch.pipeline.tracker import Tracker, TrackerConfig, TrackingState
from tpuslam_torch.testing import (
    LOOP_CAM,
    TRACK_STEP_ARGS,
    StepWallScene,
    build_depth_session,
    build_loop_map,
    coherent_track_inputs,
    depth_session,
    keep_mapping_inputs,
    mono_session,
    orbit_trajectory,
    pose_disagreement,
    pose_errors,
    pose_problem,
    render_frames,
    render_rgbd_frames,
    render_stereo_frames,
    synthetic_ba_problem,
    trajectory_ate,
)

B, N_FEATURES, N_LOCAL = 4, 1000, 4096
CAM = PinholeCamera(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480)
CFG = ORBConfig(n_features=N_FEATURES)
# The port's hand-written kernels on the main path, by name; each counts its launches.
KERNELS = {"fast_nms": fast_nms, "gather_patches": gather_patches, "pose_optimization": pose_optimization}
REPS = 20
POSE_TOL = 1e-3  # CUDA vs CPU pose: float32 sums in another order
# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 ops/s
# outside the tensor cores. A kernel's bound is the larger of its bytes and
# its operations over these.
HBM_BYTES_S, F32_OPS_S = 3.35e12, 67e12

# Map slice: the tracker's default capacities (tpuslam/pipeline/tracker.py
# TrackerConfig, kp_capacity = 2 x n_features, _local_subset_cap, _cand_cap).
MAP = dict(K=1536, N_cap=2 * N_FEATURES, P=200_000)
MAP_STEP = dict(max_local_pts=16384, cand_cap=8192, min_inliers_motion=10, accept_thr=30.0)
MAP_FRAMES, MAP_KF_EVERY = 161, 4  # 41 keyframes, more points than the local subset holds
MAP_POSES = dict(step=0.02, yaw_rate=0.002, x0=-1.6)  # the view stays on the walls
# Keyframes come at frames 4, 8, ...: 81 and 157 take the reference branch,
# 82 and 158 the motion model. The CPU check takes the first state with a
# velocity, the times the last.
MAP_SNAP = (81, 82, 157, 158)
MAP_T_TOL, MAP_R_TOL = 0.01, 0.2  # per frame, against ground truth (m, deg)
# Mono SLAM: the map slice's trajectory through the port's System; 3 more
# frames count reads on the finished map, then an earlier one relocalizes.
MONO_FRAMES, MONO_INIT_BY, MONO_TRACKED = 100, 10, 0.95
# The async mono session's camera rate, that of mono_session's timestamps
# (i / 30 s): unpaced, the tracking thread outran a mapping job ~12 frames
# to one and monocular NeedNewKeyFrame declined the keyframes it wanted.
ASYNC_FPS = 30.0
# ATE gate, a share of the path's span. tests/test_integration_mono.py holds
# its 36-frame path (4.5 cm a frame) to 2%, as tests/test_torch_tracker_mono.py
# does the port; on this path (2 cm a frame, 100 frames) the ATE moved from
# 0.65% to 2.23% over four runs of code that differed only in summation order
# (the card's float sums also come in another order each run), so the gate
# is 3%.
MONO_ATE_SHARE = 0.03
MONO_SNAP_JOB, MONO_RELOC_FRAME = 10, 50
# Phase mapping graphs: the mono session's keyframe jobs kept on the host
# (an early, a middle and a late one; the late one is run again at the
# compaction trigger) and a stereo session's, each run both ways
# MAP_GRAPH_REPS times in turns; a tracker's mapping segments (keys): the
# six of mapping_front, the local BA, the normals and compaction.
MAP_GRAPH_MONO_JOBS, MAP_GRAPH_DEPTH_JOB = (2, 45, 85), 1
MAP_GRAPH_REPS, MAP_GRAPH_KEYS = 3, 9
MAP_STAGES = ("map.compact", "map.front", "map.local_ba1", "map.local_ba2", "map.normals")
# Stereo SLAM at KITTI00-02.yaml's operating point (Examples/Stereo of the
# reference): its camera and ORBextractor block (2000 features; scale 1.2,
# 8 levels, FAST 20/7 are ORBConfig's defaults), ThDepth 35, and 10 frames
# between forced keyframes (its 10 fps, as examples/stereo_kitti.py sets
# kf_max_frames). RGB-D at TUM1.yaml's (Examples/RGB-D): ThDepth 40 and the
# depth image at 5000 per metre. The synthetic renderer is a pinhole, so the
# distortion is zero. Both at the tracker's default capacities.
KITTI_CAM = PinholeCamera(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, bf=386.1448,
                          width=1241, height=376)
KITTI_ORB = ORBConfig(n_features=2000)
STEREO_TRACKER = dict(th_depth_factor=35.0, kf_max_frames=10)
MULTI_TRACKER = dict(STEREO_TRACKER, enable_loop_closing=False)
TUM_CAM = PinholeCamera(fx=517.306408, fy=516.469215, cx=318.643040, cy=255.313989, bf=40.0,
                        width=640, height=480)
TUM_ORB = ORBConfig(n_features=1000)
RGBD_TRACKER = dict(th_depth_factor=40.0, depth_map_factor=1.0 / 5000.0, enable_loop_closing=False)
# Half of StepWallScene's default wall depths: 1.75 to 3.5 m around th_depth.
RGBD_DEPTHS = tuple(d / 2 for d in (3.5, 5.0, 4.2, 6.5, 3.8, 5.8, 4.6, 7.0))
# The stereo scene: StepWallScene at 4x scale (walls 14 to 28 m away, bands
# 4.8 m wide, texture at 10 px/m), so th_depth (35 x 0.537 = 18.8 m) splits
# it as it splits a street, and a KITTI-like 0.4 m per frame turns the view
# over: the close-point pressure then brings keyframes, as on KITTI.
STEREO_SCENE = dict(depths=tuple(4 * d for d in (3.5, 5.0, 4.2, 6.5, 3.8, 5.8, 4.6, 7.0)),
                    band=4.8, tex_scale=10.0)
DEPTH_FRAMES = 60
STEREO_POSES = dict(step=0.4, yaw_rate=0.002, x0=-16.0)
RGBD_POSES = dict(step=0.04, yaw_rate=0.002, x0=-1.2)
# tests/test_integration_stereo.py's gates: >= 95% tracked, the span within
# 5%; the rigid ATE below 3% of the span.
DEPTH_TRACKED, DEPTH_SPAN_TOL, DEPTH_ATE_SHARE = 0.95, 0.05, 0.03
LOC_FRAMES, LOC_TRACKED = 20, 0.75  # localization mode past the mapped region
MULTI_B, MULTI_FRAMES = 2, 12
MULTI_POSES = [dict(step=0.4, yaw_rate=0.002, x0=-16.0), dict(step=0.4, yaw_rate=-0.002, x0=-10.0)]
# Place recognition: tests/test_place_scale.py's gates on the 100k tree.
PLACE_R1, PLACE_R5 = 0.85, 0.92
# The loop map (testing.build_loop_map) at the default capacities.
LOOP_KF, LOOP_NO_REVISIT_KF = 240, 64
LOOP_DRIFT = 0.012 * 16 / LOOP_KF
LOOP_T_TOL, LOOP_R_TOL = 0.01, 0.1  # card against CPU on the closing keyframe (m, deg)
# Facade: the mono session's map saved, loaded into a fresh System and
# localized against over frames of the mono path; the RGB-D driver over a
# TUM folder of the RGB-D phase's scene at TUM1.yaml's point; the map's
# renderers and the EuRoC rectification on the card against the CPU.
FACADE_LOC = range(20, 40)
FACADE_RELOC_TOL, FACADE_LOC_TRACKED = 0.05, 0.75
FACADE_TUM_FRAMES, FACADE_VIEWER_EVERY = 40, 10
PLANE_TOL_DEG, LAYOUT_TOL, REMAP_TOL = 0.1, 1e-3, 1e-4
# EuRoC.yaml's LEFT / RIGHT rectification blocks (the reference's
# Examples/Stereo/EuRoC.yaml, as tests/test_torch_settings.py writes it).
EUROC_RECT = [dict(
    K=np.array([[458.654, 0.0, 367.215], [0.0, 457.296, 248.375], [0.0, 0.0, 1.0]]),
    D=np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0]),
    R=np.array([[0.999966347530033, -0.001422739138722922, 0.008079580483432283],
                [0.001365741834644127, 0.9999741760894847, 0.007055629199258132],
                [-0.008089410156878961, -0.007044357138835809, 0.9999424675829176]]),
    P=np.array([[435.2046959714599, 0, 367.4517211914062, 0], [0, 435.2046959714599, 252.2008514404297, 0],
                [0, 0, 1, 0]])), dict(
    K=np.array([[457.587, 0.0, 379.999], [0.0, 456.134, 255.238], [0.0, 0.0, 1.0]]),
    D=np.array([-0.28368365, 0.07451284, -0.00010473, -3.555907e-05, 0.0]),
    R=np.array([[0.9999633526194376, -0.003625811871560086, 0.007755443660172947],
                [0.003680398547259526, 0.9999684752771629, -0.007035845251224894],
                [-0.007729688520722713, 0.007064130529506649, 0.999945173484644]]),
    P=np.array([[435.2046959714599, 0, 367.4517211914062, -47.90639384423901],
                [0, 435.2046959714599, 252.2008514404297, 0], [0, 0, 1, 0]]))]
# Parallel paths: phase 6's mono session with mapping on a background
# thread (the default TrackerConfig otherwise); the async global BA on the
# loop map (no drift, points moved by 2 cm, as tests/test_async_mapping.py
# does); a mapping process on the card at the stereo phase's point (the
# transport then timed on PAR_TRANSPORT_JOBS more jobs of a warm worker);
# two BA shards and two map shards on the one card, held to
# tests/test_dist_ba.py's tolerances (R, t, X). The synthetic problem is
# tools/bench_scaling.py's shape, K=64, P=16,384, 64 observations a
# keyframe; its arc turns the last cameras away from the cloud (728 of its
# 4096 observations lie behind their camera) and LM takes no step there,
# so the solvers are also held on the loop map's global BA.
PAR_STEREO_FRAMES, PAR_SHARDS = 30, 2
PAR_TRANSPORT_JOBS = 3
PAR_BA = dict(K=64, P=16_384, n_obs_per_kf=64)
PAR_BA_ITERS = dict(iters=4, cg_iters=20)
PAR_BA_TOL = (1e-4, 1e-3, 1e-3)
PAR_SEARCH_KP = 1000  # keypoints of the searched frame
INT_FIELDS = [steps.FUSED_ACCEPT, steps.FUSED_INITIAL_OK, steps.FUSED_USED_MM,
              steps.FUSED_N_TRACKED, *range(steps.FUSED_GATES, steps.FUSED_GATES + 4),
              steps.FUSED_NM]


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms_turns(fns, reps: int = REPS, warmup: int = 3, ahead: bool = False) -> list[float]:
    """Median time in ms of each fn(), CUDA events around each call. The fns
    take turns (a b, b a, a b, ...), so a drift in the speed of the shared
    host falls on each of them alike. Without `ahead` the time includes the
    device's waits for the host between launches; with it, a ~10 ms sleep
    kernel runs first, so the host has queued the whole call before the
    device reaches it, and the time is the device's alone."""
    for _ in range(warmup):
        for fn in fns:
            fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for r in range(reps):
        for i in (range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if ahead:
                torch.cuda._sleep(20_000_000)
            start.record()
            fns[i]()
            end.record()
            end.synchronize()
            times[i].append(start.elapsed_time(end))
    return [statistics.median(t) for t in times]


def cuda_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    return cuda_ms_turns([fn], reps, warmup)[0]


def fast_bound_ms(levels, th: float) -> tuple:
    """(ms, "bytes" or "operations"): each pixel read and written once as
    float32, against 48 operations per pixel (16 differences, 32
    comparisons) plus ~180 for each pixel that scores (the arc search and
    its NMS window), counted on these inputs."""
    px = sum(x.numel() for x in levels)
    scoring = sum(int((fast_response(x, th) > 0).sum()) for x in levels)
    t_bytes = 8 * px / HBM_BYTES_S * 1e3
    t_ops = (48 * px + 180 * scoring) / F32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gather_bound_ms(atlas, corner) -> tuple:
    """(ms, "bytes"): the atlas and corners read once, the float32 patches
    written once; one conversion per output value is far below the rate."""
    n = corner.shape[0]
    nbytes = atlas.numel() * atlas.element_size() + corner.numel() * 4 + n * PSIZE * PSIZE * 4
    return nbytes / HBM_BYTES_S * 1e3, "bytes"


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on a card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return smi


def phase_build() -> None:
    host = build.build_host()
    log(f"host library build (g++, zlib): {host['seconds']:.2f} s -> {host['path']}")
    info = build.build()
    log(f"build: {info['seconds']:.2f} s -> {info['path']}")
    for line in info["log"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")
    build.lib()


def phase_kernels(imgs: torch.Tensor, rng):
    """Kernel vs plain on the card. Returns {name: max_abs_err}."""
    err = {"fast_nms": 0.0, "gather_patches": 0.0}
    levels = build_pyramid(imgs, CFG.n_levels, CFG.scale_factor)
    ragged = [torch.from_numpy(rng.uniform(0, 255, s).astype(np.float32)).cuda()
              for s in ((2, 97, 200), (1, 33, 31))]
    for group in (levels, ragged):
        before = fast_nms.launches
        got = fast_nms_pyramid(group, CFG.min_th_fast)
        torch.cuda.synchronize()
        if fast_nms.launches != before + 1:
            raise AssertionError("fast_nms_pyramid did not launch once")
        for x, g in zip(group, got):
            ref = fast_nms_plain(x, CFG.min_th_fast)
            torch.cuda.synchronize()
            if not torch.equal(g, ref):
                raise AssertionError(f"fast_nms differs from its plain version at {tuple(x.shape)}")
            err["fast_nms"] = max(err["fast_nms"], float((g - ref).abs().max()))
            log(f"fast_nms {tuple(x.shape)}: equal ({int((g > 0).sum())} corners)")
        log(f"  ({len(group)} levels in one launch)")

    *_, atlas, corner = detect_batched(imgs, CFG)
    Ha, Wa = atlas.shape
    edges = torch.tensor([[0, 0], [Ha - PSIZE, Wa - PSIZE], [0, Wa - PSIZE], [Ha - PSIZE, 0]],
                         dtype=torch.int32, device=atlas.device)
    five = torch.cat([edges, corner[:1]])
    more = torch.cat([corner, edges[1:2]])  # 4001: the last block of 4 is ragged
    for a, c in ((atlas, corner), (atlas, edges), (atlas, five), (atlas, more),
                 (atlas.float(), corner), (atlas.float(), more)):
        got = gather_patches(a, c)
        torch.cuda.synchronize()
        ref = gather_patches_plain(a, c)
        if not torch.equal(got, ref):
            raise AssertionError(f"gather_patches differs from its plain version ({a.dtype}, {tuple(c.shape)})")
        err["gather_patches"] = max(err["gather_patches"], float((got - ref).abs().max()))
        log(f"gather_patches {a.dtype} atlas {tuple(a.shape)} corners {tuple(c.shape)}: equal")

    # The features the kernels feed equal those of the plain versions on the CPU.
    fc = extract_orb_batched(imgs, CFG)
    fp = extract_orb_batched(imgs.cpu(), CFG)
    for name in ("xy", "level", "valid", "response"):
        if not torch.equal(getattr(fc, name).cpu(), getattr(fp, name)):
            raise AssertionError(f"extract_orb_batched {name}: CUDA differs from CPU")
    same = (fc.desc.cpu() == fp.desc).all(-1)[fp.valid].float().mean().item()
    dang = float((fc.angle.cpu() - fp.angle).abs()[fp.valid].max())
    log(f"extract_orb_batched CUDA vs CPU: xy/level/valid/response equal, "
        f"descriptors equal {same:.4f}, max angle diff {dang:.2e}")
    if same < 0.99 or dang > 1e-4:
        raise AssertionError("extract_orb_batched descriptors/angles: CUDA vs CPU")
    return err


# The frame step's pose problems: (name, batch, edges, share of stereo edges).
POSE_SHAPES = (("B=1 N=4000 stereo", (), 4000, 0.6), ("B=1 N=2000 mono", (), 2000, 0.0),
               ("B=4 N=2000 mono", (B,), 2000, 0.0))
POSE_ITERS = 40  # pose_optimization's 4 rounds of 10


def pose_bound_ms(obs) -> tuple:
    """(ms, "bytes" or "operations"): the inputs read once (7 floats and a
    byte an edge), the outputs written once, against ~90 flops an edge and
    iteration outside the Jacobian rows (the projection and residuals twice,
    the weights) and ~69 for each of its 2 (mono) or 3 (stereo) rows (the
    row, 21 entries of H and 6 of b)."""
    n_edges = obs.valid.numel()
    n_stereo = int((obs.uvr[..., 2] >= 0).sum())
    nbytes = n_edges * (7 * 4 + 1) + n_edges + obs.valid[..., 0].numel() * (12 * 4 + 12 * 4 + 8)
    flops = POSE_ITERS * (n_edges * (90 + 2 * 69) + n_stereo * 69)
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / F32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_pose_kernel(smi: str) -> dict:
    """pose_optimization's kernel against its plain version on the card, then
    both timed in turns (see the module docstring). Returns {shape: times}."""
    res = {}
    for name, batch, n, share in POSE_SHAPES:
        R0, t0, obs = pose_problem(KITTI_CAM, 17, batch, n, stereo_share=share, device="cuda")
        before = pose_optimization.launches
        got = pose_optimization(KITTI_CAM, R0, t0, obs)
        torch.cuda.synchronize()
        if pose_optimization.launches != before + 1:
            raise AssertionError("pose_optimization did not launch its kernel once")
        d = pose_disagreement(KITTI_CAM, got, pose_optimization_plain(KITTI_CAM, R0, t0, obs), obs)
        log(f"pose_optimization {name}: against the plain version {d}")
        if not (d["dR"] <= 1e-4 and d["dt"] <= 1e-4 and d["counts_match"] and d["mask_differs_far"] == 0):
            raise AssertionError(f"pose_optimization {name}: the kernel and the plain version disagree")
        R1, t1, obs1 = pose_problem(KITTI_CAM, 17, batch, 1, stereo_share=share, device="cuda")
        with launches_kept():
            fns = [lambda: pose_optimization(KITTI_CAM, R0, t0, obs),
                   lambda: pose_optimization_plain(KITTI_CAM, R0, t0, obs),
                   lambda: pose_optimization(KITTI_CAM, R1, t1, obs1)]
            per_call = cuda_ms_turns(fns)
            dev = cuda_ms_turns(fns, ahead=True)
        bound, by = pose_bound_ms(obs)
        res[name] = dict(ms=per_call[0], device_ms=dev[0], plain_ms=per_call[1], plain_device_ms=dev[1],
                         floor_ms=dev[2], bound_ms=bound, bound_by=by,
                         iteration_us=dev[0] * 1e3 / POSE_ITERS, floor_iteration_us=dev[2] * 1e3 / POSE_ITERS)
        log(f"  times on {smi} (CUDA-event medians of {REPS}, in turns): kernel {per_call[0]:.4f} ms "
            f"per call, {dev[0]:.4f} ms device ({res[name]['iteration_us']:.2f} us an LM iteration); "
            f"plain {per_call[1]:.3f} / {dev[1]:.3f} ms; the kernel at one edge (latency floor) "
            f"{dev[2]:.4f} ms ({res[name]['floor_iteration_us']:.2f} us an iteration); bytes and flops "
            f"bound {bound:.5f} ms ({by}), {bound / dev[0]:.2%} of it; {dev[2] / dev[0]:.1%} of the "
            f"device time is the floor")
    return res


def phase_device_assert() -> None:
    """A window past the atlas, in a child process (it keeps the dead CUDA
    context): it must exit non-zero with the kernel's device-side assert."""
    code = (
        "import torch\n"
        "from tpuslam_torch.ops.patches import gather_patches\n"
        "atlas = torch.zeros((2338, 656), dtype=torch.uint8, device='cuda')\n"
        "corner = torch.tensor([[0, 0], [2338 - 46, 3]], dtype=torch.int32, device='cuda')\n"
        "gather_patches(atlas, corner)\n"
        "torch.cuda.synchronize()\n"
        "print('no assert')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parent,
                         capture_output=True, text=True, timeout=300)
    said = [line for line in out.stderr.splitlines() if "ssert" in line]
    log(f"gather_patches, a window past the atlas in a child: exit {out.returncode}; "
        f"{said[:2]}")
    if out.returncode == 0 or "device-side assert" not in out.stderr:
        raise AssertionError(f"no device-side assert for a window outside the atlas:\n{out.stderr[-2000:]}")


def phase_slice(inp: dict, smi: str):
    """The batched step through a StepGraphs (its one graph captured at the
    first call, then replayed): the main path's run, the gates, the CPU
    run of the same inputs; then the step eagerly, every output torch.equal
    to the graphed one, and both ways timed in turns with their host API
    calls and device->host reads. Returns (inputs, launches, the graphed
    step)."""
    args = [array_to_tensor(inp[k], "cuda") for k in TRACK_STEP_ARGS]
    graphs = StepGraphs("cuda")
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    R2, t2, n_inl2, n_valid = track_step_batched(CAM, CFG, *args, run=graphs.run)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()
    log(f"main path launches: {launches} (the warm-up before the capture and the first replay)")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path did not launch: {launches}")

    R2c, t2c, n_inl2c, n_validc = (x.cpu() for x in (R2, t2, n_inl2, n_valid))
    t_err, r_err = pose_errors(R2c.numpy(), t2c.numpy(), inp["R_gt"], inp["t_gt"])
    t_err0, _ = pose_errors(inp["R0"], inp["t0"], inp["R_gt"], inp["t_gt"])
    for b in range(B):
        log(f"stream {b}: n_inl2 {int(n_inl2c[b])}, t err {t_err0[b]:.4f} -> {t_err[b]:.4f}, "
            f"rot err {r_err[b]:.4f} deg")
    log(f"n_valid {int(n_validc)}")
    if not ((n_inl2c.numpy() >= 300).all() and (t_err < 0.01).all() and (r_err < 0.2).all()):
        raise AssertionError("a stream missed its ground-truth pose")
    if not np.isfinite(R2c.numpy()).all() or R2c.shape != (B, 3, 3) or t2c.shape != (B, 3):
        raise AssertionError("pose output malformed")

    t0 = time.perf_counter()
    Rp, tp, n_inlp, n_validp = track_step_batched(CAM, CFG, *[a.cpu() for a in args])
    log(f"CPU run of the same inputs: {time.perf_counter() - t0:.1f} s, n_inl2 {n_inlp.tolist()}, "
        f"max |dR| {float((Rp - R2c).abs().max()):.2e}, max |dt| {float((tp - t2c).abs().max()):.2e}")
    if int(n_validp) != int(n_validc):
        raise AssertionError(f"n_valid CUDA {int(n_validc)} vs CPU {int(n_validp)}")
    torch.testing.assert_close(R2c, Rp, rtol=0, atol=POSE_TOL)
    torch.testing.assert_close(t2c, tp, rtol=0, atol=POSE_TOL)

    def graphed():
        return track_step_batched(CAM, CFG, *args, run=graphs.run)

    def eager():
        return track_step_batched(CAM, CFG, *args)

    with launches_kept():
        equal = tree_equal(graphed(), eager())
        g_ms, e_ms = cuda_ms_turns([graphed, eager], reps=GRAPH_REPS, warmup=1)
        reads = {w: count_syncs(f)[1] for w, f in (("eager", eager), ("graphed", graphed))}
        calls = {w: api_calls(f) for w, f in (("eager", eager), ("graphed", graphed))}
    c = graphs.captured[0]
    log(f"track_step_batched B={B} on {smi}, graphed against eager: outputs "
        f"{'torch.equal' if equal else 'DIFFERENT'}; {g_ms:.3f} against {e_ms:.3f} ms per step "
        f"(CUDA-event medians of {GRAPH_REPS}, in turns), {e_ms / g_ms:.2f}x, "
        f"{B * 1000.0 / g_ms:.2f} against {B * 1000.0 / e_ms:.2f} frames/s; the first call (warm-up, "
        f"capture, instantiation, replay) {first_ms:.1f} ms: capture {c['capture_ms']:.1f} ms, "
        f"instantiation {c['instantiate_ms']:.1f} ms, {c['nodes']} nodes, {c['kernel_nodes']} kernel "
        f"nodes; {graphs.captures} capture, {graphs.replays} replays; host API calls per step eager {sum(calls['eager'].values())} {calls['eager']}, graphed "
        f"{sum(calls['graphed'].values())} {calls['graphed']}; device->host reads eager "
        f"{len(reads['eager'])}, graphed {len(reads['graphed'])}; graph pool "
        f"{graphs.pool_bytes() / 2**20:.1f} MiB, static buffers {graphs.buffer_bytes() / 2**20:.1f} MiB")
    if not equal:
        raise AssertionError("slice: the graphed batched step differs from the eager one")
    if len(reads["graphed"]) > len(reads["eager"]):
        raise AssertionError(f"slice: reads graphed {reads['graphed']} against eager {reads['eager']}")
    return args, launches, graphs


@contextlib.contextmanager
def launches_kept():
    """The kernels' launch counters as they were before the block: the
    comparison runs inside it do not count as the main path's."""
    before = launch_counts()
    try:
        yield
    finally:
        for name, n in before.items():
            KERNELS[name].launches = n


def zero_launches() -> None:
    for f in KERNELS.values():
        f.launches = 0


def launch_counts() -> dict:
    return {name: f.launches for name, f in KERNELS.items()}


def missing_kernels(kinds: list) -> list:
    """The frames of frame_kinds(...) that did not launch fast_nms and
    gather_patches, or, tracked, fewer than two pose kernels (the motion
    model or the reference keyframe, then the local map): (index, kind,
    launches)."""
    return [(i, x["kind"], x["launches"]) for i, x in enumerate(kinds)
            if x["launches"]["fast_nms"] < 1 or x["launches"]["gather_patches"] < 1
            or (x["kind"] != "initialization" and x["launches"]["pose_optimization"] < 2)]


def tree_equal(a, b) -> bool:
    """Trees of tensors and numpy arrays (tuples, lists, NamedTuples, None)
    equal bit for bit."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and np.array_equal(a, b)
    if isinstance(a, (tuple, list)):
        return (isinstance(b, (tuple, list)) and len(a) == len(b)
                and all(tree_equal(x, y) for x, y in zip(a, b)))
    return a == b


def tracker_state(tr):
    """What a frame may change on a tracker (its attributes, its
    generator's state, the lists and dicts it adds to), so that the same
    frame can run again from the same state (tracker_restore)."""
    return dict(tr.__dict__), tr.generator.get_state(), list(tr.trajectory), dict(tr.stats)


def tracker_restore(tr, state) -> None:
    d, gen, traj, stats = state
    tr.__dict__.clear()
    tr.__dict__.update(d)
    tr.generator.set_state(gen)
    tr.trajectory, tr.stats = list(traj), dict(stats)


def tracker_result(tr) -> tuple:
    """The state a frame leaves, compared graphed against eager."""
    return (tr.state, tr._last_R, tr._last_t, tr._last_obs, tr._velocity, tr._vo_mode, tr._vo_xyz,
            tr._vo_valid, tuple(tr.map), tr.trajectory[-1:])


def both_ways(restore, call, result, graphs, reps: int = 1, io: bool = False) -> dict:
    """call() from the same state (restore() before each run), eagerly
    (every segment of `graphs` through call_segment) and graphed, in
    turns, reps times each: {"equal": call's output and result() torch.equal
    in every run, "ms": {way: wall ms per run, card synchronized}, "out":
    the last graphed output}; with `io` also one more run each way for its
    device->host reads ("reads") and its host API calls ("calls"). The
    state left is that of the last run."""
    ms, got = {"eager": [], "graphed": []}, {"eager": [], "graphed": []}

    def once(way, measure=None):
        restore()
        with eager_segments(*graphs) if way == "eager" else contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = call() if measure is None else measure(call)
            torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    for r in range(reps):
        for way in (("eager", "graphed") if r % 2 == 0 else ("graphed", "eager")):
            out, t = once(way)
            ms[way].append(t)
            got[way].append((out, result()))
    res = dict(ms=ms, out=got["graphed"][-1][0],
               equal=all(tree_equal(a, b) for a, b in zip(got["eager"], got["graphed"])))
    if io:
        res["reads"] = {w: once(w, count_syncs)[0][1] for w in ("eager", "graphed")}
        res["calls"] = {w: once(w, api_calls)[0] for w in ("eager", "graphed")}
    return res


def io_report(res: dict) -> str:
    """both_ways' reads and host API calls, for a log line."""
    r, c = res["reads"], res["calls"]
    return (f"device->host reads eager {len(r['eager'])}, graphed {len(r['graphed'])} (at {r['graphed']}); "
            f"host API calls eager {sum(c['eager'].values())} {c['eager']}, graphed "
            f"{sum(c['graphed'].values())} {c['graphed']}")


def captures_report(graphs, since: int = 0) -> str:
    """The captures of a StepGraphs from record `since` on: segment, capture
    plus instantiation ms, kernel nodes."""
    return ", ".join(f"{c['segment']} {c['capture_ms'] + c['instantiate_ms']:.1f} ms / {c['kernel_nodes']} "
                     f"kernel nodes" for c in graphs.captured[since:]) or "none"


@contextlib.contextmanager
def eager_segments(*graphs):
    """Every segment of these StepGraphs runs eagerly (call_segment) in the
    block."""
    for g in graphs:
        g.run = steps.call_segment
    try:
        yield
    finally:
        for g in graphs:
            del g.run


def _fused(st, img, inv_sigma2, has_vel=None, **kwargs):
    """fused_track_frame_image on a session state, as the tracker calls it
    (`kwargs`: its `run`)."""
    has_vel = st.has_vel if has_vel is None else has_vel
    vel_R, vel_t = (st.vel_R, st.vel_t) if has_vel else (
        torch.eye(3, device=img.device), torch.zeros(3, device=img.device))
    return fused_track_frame_image(
        CAM, CFG, st.m, img, st.last_feats, st.last_obs, st.last_R, st.last_t,
        vel_R, vel_t, has_vel, st.ref_kf, inv_sigma2.to(img.device),
        MAP_STEP["accept_thr"], min_inliers_motion=MAP_STEP["min_inliers_motion"],
        max_local_pts=MAP_STEP["max_local_pts"], cand_cap=MAP_STEP["cand_cap"], **kwargs,
    )


def _state_to_cpu(st):
    """A session state through numpy onto the CPU (map_to_numpy/map_to_torch)."""
    return st._replace(
        m=map_to_torch(map_to_numpy(st.m), "cpu"),
        last_feats=FrameFeatures(*(x.cpu() for x in st.last_feats)),
        last_obs=st.last_obs.cpu(), last_R=st.last_R.cpu(), last_t=st.last_t.cpu(),
        vel_R=st.vel_R.cpu(), vel_t=st.vel_t.cpu(),
    )


def phase_map(scene: StepWallScene, device: str = "cuda"):
    """The map slice: a session at the tracker's default capacities, every
    frame checked, then one mid-session state on the CPU against the card.
    Returns (session, the frames of the first and the last snapshot with
    a velocity, launches, launches of each tracked frame; the first also
    holds keyframe 0's)."""
    poses = orbit_trajectory(MAP_FRAMES, **MAP_POSES)
    per_frame = []
    seen = dict.fromkeys(KERNELS, 0)

    def on_frame(i, rec):
        now = launch_counts()
        per_frame.append({k: now[k] - seen[k] for k in now})
        seen.update(now)

    graphs = StepGraphs(device)  # the step as the tracker runs it; phase graphs runs it eagerly too

    def step(*args, **kwargs):
        return fused_track_frame_image(*args, **kwargs, run=graphs.run)

    zero_launches()
    t0 = time.perf_counter()
    s = build_depth_session(scene, CAM, CFG, poses, MAP["K"], MAP["N_cap"], MAP["P"],
                            MAP_KF_EVERY, device=device, snapshot_at=MAP_SNAP,
                            on_frame=on_frame, step=step, **MAP_STEP)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()

    # The local subset of the last frame, from its tracked matches.
    m = s.state.m
    n_valid = int(m.pt_valid.sum())
    lk = local_keyframe_mask(m, s.state.last_obs, ref_kf=s.state.ref_kf)
    seen_by = (m.kf_obs_pt >= 0) & m.kf_kp_valid & m.kf_valid[:, None] & lk[:, None]
    local_ids = torch.unique(m.kf_obs_pt[seen_by].long())
    local_pts = int(m.pt_valid[local_ids].sum())
    log(f"map slice: {len(s.frames)} frames tracked in {wall:.1f} s (rendering and keyframe "
        f"insertion included); {s.n_kf} keyframes, {n_valid} valid points of "
        f"{MAP['P']}; K={MAP['K']}, N_cap={MAP['N_cap']}, {MAP_STEP}")
    log(f"  last frame: {int(lk.sum())} local keyframes observe {local_pts} valid points; "
        f"the subset gathers {min(local_pts, MAP_STEP['max_local_pts'])} of them")

    p = np.stack([f["packed"] for f in s.frames])
    t_err, r_err = pose_errors(np.stack([f["R"] for f in s.frames]),
                               np.stack([f["t"] for f in s.frames]),
                               np.stack([f["R_gt"] for f in s.frames]),
                               np.stack([f["t_gt"] for f in s.frames]))
    used_mm = p[:, steps.FUSED_USED_MM] > 0.5
    n_tracked = p[:, steps.FUSED_N_TRACKED]
    for k, f in enumerate(s.frames):
        if k % 10 == 0 or k == len(s.frames) - 1:
            log(f"  frame {f['frame']}: accept {p[k, 0]:.0f} mm {used_mm[k]:d} "
                f"n_tracked {n_tracked[k]:.0f} nm {p[k, steps.FUSED_NM]:.0f} "
                f"t err {t_err[k]:.4f} rot err {r_err[k]:.4f} deg launches {per_frame[k]}")
    log(f"  all frames: accepted {int((p[:, 0] > 0.5).sum())}/{len(p)}, n_tracked min "
        f"{n_tracked.min():.0f}, t err max {t_err.max():.4f}, rot err max {r_err.max():.4f} deg, "
        f"motion model {int(used_mm.sum())} frames, reference keyframe {int((~used_mm).sum())}")
    log(f"  map-slice launches: {launches}")
    bad = [f["frame"] for k, f in enumerate(s.frames)
           if not (p[k, 0] > 0.5 and n_tracked[k] >= 100
                   and t_err[k] < MAP_T_TOL and r_err[k] < MAP_R_TOL)]
    if bad:
        raise AssertionError(f"map slice: frames {bad} missed acceptance or ground truth")
    if not (used_mm.sum() > len(p) / 2 and (~used_mm).sum() >= 1):
        raise AssertionError("map slice: the motion-model and reference branches were not both taken")
    if any(d["fast_nms"] < 1 or d["gather_patches"] < 1 for d in per_frame):
        raise AssertionError(f"map slice: a frame did not launch both kernels: {per_frame}")
    if any(d["pose_optimization"] < 2 for d in per_frame):
        raise AssertionError(f"map slice: a frame ran fewer than two pose kernels: {per_frame}")
    if not np.isfinite(p).all() or p.shape[1] != steps.FUSED_LEN:
        raise AssertionError("map slice: packed result malformed")

    with_vel = [i for i, (st, _) in sorted(s.snapshots.items()) if st.has_vel]
    mid, late = with_vel[0], with_vel[-1]
    if device == "cuda":
        st, img = s.snapshots[mid]
        out = _fused(st, img, s.inv_sigma2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cpu = _fused(_state_to_cpu(st), img.cpu(), s.inv_sigma2)
        log(f"  CPU run of the frame-{mid} state: {time.perf_counter() - t0:.1f} s")
        pg, pc = out[-1].cpu().numpy(), cpu[-1].numpy()
        same_obs = float((out[3].cpu() == cpu[3]).float().mean())
        dR = float((out[1].cpu() - cpu[1]).abs().max())
        dt = float((out[2].cpu() - cpu[2]).abs().max())
        log(f"  CUDA vs CPU: packed integer fields {pg[INT_FIELDS].tolist()} vs "
            f"{pc[INT_FIELDS].tolist()}, obs equal {same_obs:.4f}, max |dR| {dR:.2e}, "
            f"max |dt| {dt:.2e}")
        if not (np.array_equal(pg[INT_FIELDS], pc[INT_FIELDS]) and same_obs >= 0.99
                and dR < POSE_TOL and dt < POSE_TOL):
            raise AssertionError("map slice: CUDA and CPU disagree")
    return s, (mid, late), launches, per_frame


def count_syncs(fn):
    """(fn(), sync_sites' list for the call)."""
    with sync_sites() as sites:
        out = fn()
    return out, sites


@contextlib.contextmanager
def sync_sites():
    """Yields the list, filled while the block runs, of one "file:line
    (function)" per synchronising CUDA call, from
    torch.cuda.set_sync_debug_mode's warnings. The site is the
    innermost frame of the port on the warning's stack, so a sync inside
    torch's own Python code is charged to the port's line that called it;
    a sync with no frame of the port gives the innermost three frames. The
    mode and the hook are process-wide: a sync made by another thread than
    the main one (a background mapping job's) is prefixed with the
    thread's name and a colon."""
    pkg = str(Path(__file__).resolve().parent / "tpuslam_torch")
    sites = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        stack = [f for f in traceback.extract_stack()[:-1]
                 if not f.filename.endswith("warnings.py")]
        ours = [f for f in stack if f.filename.startswith(pkg)]
        where = ours[-1:] or stack[::-1][:3]
        th = threading.current_thread()
        tag = "" if th is threading.main_thread() else f"{th.name}: "
        sites.append(tag + " < ".join(f"{Path(f.filename).name}:{f.lineno} ({f.name})" for f in where))

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        sites.clear()  # setting the mode reports a sync of its own
        try:
            yield sites
        finally:
            torch.cuda.set_sync_debug_mode("default")


def _dev_time(e):
    return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))


def profile_call(fn):
    """One call of fn under torch.profiler: (wall ms, kernel launches,
    device us summed over the device's own events (kernels, copies,
    fills: a host op's entry carries its kernels' time too, which would
    count them twice), its 8 largest such events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ev = prof.key_averages()
    launches = sum(e.count for e in ev if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    dev = [e for e in ev if e.device_type == DeviceType.CUDA]
    return wall_ms, launches, sum(_dev_time(e) for e in dev), sorted(dev, key=_dev_time, reverse=True)[:8]


def log_top(top):
    for e in top:
        log(f"    {_dev_time(e) / 1e3:8.3f} ms {e.count:6d} x {e.key[:90]}")


def map_times(s, snap: int, smi: str) -> dict:
    """ms per frame of fused_track_frame_image on a fixed late-session state,
    launches and device->host reads per frame, the device's busy share."""
    st, img = s.snapshots[snap]
    branches = (("motion model", True), ("reference keyframe", False))
    res = dict(zip((name for name, _ in branches), cuda_ms_turns(
        [lambda hv=hv: _fused(st, img, s.inv_sigma2, hv) for _, hv in branches])))
    for name, hv in branches:
        _, sites = count_syncs(lambda: _fused(st, img, s.inv_sigma2, hv)[-1].cpu())
        if not sites:
            raise AssertionError("count_syncs saw not even the packed fetch")
        res[name + " syncs"] = sites[:-1]  # less the packed fetch, which the caller makes
    wall_ms, launches, dev_us, top = profile_call(lambda: _fused(st, img, s.inv_sigma2))
    log(f"map slice times on {smi} (the frame-{snap} state, K={MAP['K']}, "
        f"P={MAP['P']}, {int(st.m.pt_valid.sum())} valid points):")
    for name in ("motion model", "reference keyframe"):
        log(f"  fused_track_frame_image, {name} branch: {res[name]:.3f} ms/frame, "
            f"{1000.0 / res[name]:.2f} frames/s (CUDA-event median of {REPS}, the branches in turns); "
            f"{len(res[name + ' syncs'])} device->host reads in the step, at "
            f"{res[name + ' syncs']}")
    log(f"  one profiled call (motion model): {launches} kernel launches, device time "
        f"{dev_us / 1e3:.3f} ms of {wall_ms:.3f} ms wall under the profiler "
        f"({dev_us / 1e3 / res['motion model']:.1%} of the unprofiled "
        f"{res['motion model']:.3f} ms); most device time:")
    log_top(top)
    res.update(launches=launches, device_ms=dev_us / 1e3, wall_ms=wall_ms)
    want = {"motion model": 1, "reference keyframe": 0}  # the verdict; none
    if any(len(res[k + " syncs"]) != n for k, n in want.items()):
        raise AssertionError(f"device->host reads in the step: "
                             f"{ {k: res[k + ' syncs'] for k in want} }, want {want}")
    return res


def peak_gib(fn):
    """(fn(), the peak memory allocated on the card while it ran, GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() / 2**30


def _ms(xs) -> str:
    return f"{statistics.median(xs):.3f} ms (n={len(xs)}, min {min(xs):.3f}, max {max(xs):.3f})" if xs else "none"


def session_recorder(tr, rec: list):
    """An on_frame callback that appends the tracker's counters, the
    kernels' launch counts and the state after each frame to `rec`."""
    def on_frame(i, out):
        rec.append(dict(counters=dict(tr.metrics.counters), state=tr.state.name,
                        launches=launch_counts()))
    return on_frame


def frame_kinds(rec: list, counters0=None) -> list:
    """Each frame's kind (keyframe, motion model, reference keyframe or
    initialization), kernel launches and state, from the steps of the
    per-frame records (session_recorder's, launches counted from 0, the
    counters from counters0)."""
    kinds, prev = [], {"launches": {}, "counters": counters0 or {}}
    for r in rec:
        d = {k: r["counters"].get(k, 0) - prev["counters"].get(k, 0) for k in r["counters"]}
        kind = ("keyframe" if d.get("frames.keyframe") else "motion model" if d.get("frames.motion_model")
                else "reference keyframe" if d.get("frames.reference_kf") else "initialization")
        kinds.append(dict(kind=kind, launches={k: r["launches"][k] - prev["launches"].get(k, 0)
                                               for k in r["launches"]}, state=r["state"]))
        prev = r
    return kinds


# The branch of a frame from the segments its step ran.
GRAPH_BRANCHES = {
    ("front", "ref", "local"): "reference keyframe (no velocity)",
    ("front", "mm", "local"): "motion model",
    ("front", "mm", "mm", "local"): "motion model after the th=14 retry",
    ("front", "mm", "mm", "ref", "local"): "reference keyframe after a failed motion model",
}
# Velocities turned by these yaws (deg) on the last snapshot force the
# motion model's other branches, the th=14 retry and past it the reference
# keyframe; which angle takes which depends on the state (on a CPU session
# of this path and camera 4 deg retried and 6 failed both; on the card's
# frame-158 state 4 and 6 both failed).
GRAPH_YAWS = (2.0, 3.0, 4.0, 6.0)
GRAPH_REPS = 7  # map times has already timed the eager step on these states 20 times
# Host API calls of a frame: kernel and graph launches, copies and syncs.
API_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch",
             "cudaMemcpyAsync", "cudaMemcpy", "cudaMemsetAsync", "cudaStreamSynchronize")


def api_calls(fn) -> dict:
    """{host API call: count} of one call of fn under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages() if e.key in API_CALLS}


def phase_graphs(scene: StepWallScene, smi: str, device: str = "cuda") -> dict:
    """The map slice's path with each frame's step both ways (see the
    module docstring). Returns the kernels' launches of both ways."""
    poses = orbit_trajectory(MAP_FRAMES, **MAP_POSES)
    graphs = StepGraphs(device)
    ran, rows = [], []

    def run(name, fn, static, **inputs):
        ran.append(name)
        return graphs.run(name, fn, static, **inputs)

    def step(*args, **kwargs):
        ways = {"eager": {}, "graphed": dict(run=run)}
        order = ("eager", "graphed") if len(rows) % 2 == 0 else ("graphed", "eager")
        outs, ms = {}, {}
        captures = graphs.captures
        for way in order:
            ran.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[way] = fused_track_frame_image(*args, **kwargs, **ways[way])
            outs[way][-1].cpu()  # the packed fetch, as the tracker makes it
            ms[way] = (time.perf_counter() - t0) * 1e3
            if way == "graphed":
                branch = GRAPH_BRANCHES[tuple(ran)]
        flat = {w: list(o[0]) + list(o[1:]) for w, o in outs.items()}
        rows.append(dict(branch=branch, ms=ms, captured=graphs.captures > captures,
                         equal=all(torch.equal(a, b) for a, b in zip(flat["eager"], flat["graphed"]))))
        return outs["graphed"]

    zero_launches()
    t0 = time.perf_counter()
    s = build_depth_session(scene, CAM, CFG, poses, MAP["K"], MAP["N_cap"], MAP["P"], MAP_KF_EVERY,
                            device=device, snapshot_at=MAP_SNAP[2:], step=step, **MAP_STEP)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    p = np.stack([f["packed"] for f in s.frames])
    log(f"graphs on {smi}: the map slice's {len(rows)} frames, each step eager and graphed in turns, in "
        f"{wall:.1f} s; launches of both ways {launches}; accepted {int((p[:, 0] > 0.5).sum())}/{len(p)}")
    bad = [f"frame {f['frame']}: the graphed step differs from the eager one"
           for f, r in zip(s.frames, rows) if not r["equal"]]
    log(f"  torch.equal on every output (features, R, t, obs, velocity, pt_visible, pt_found, packed): "
        f"{sum(r['equal'] for r in rows)}/{len(rows)} frames")
    for branch in GRAPH_BRANCHES.values():
        sel = [r for r in rows if r["branch"] == branch and not r["captured"]]
        n = sum(r["branch"] == branch for r in rows)
        log(f"  {branch}: {n} frames; eager {_ms([r['ms']['eager'] for r in sel])}, graphed "
            f"{_ms([r['ms']['graphed'] for r in sel])} per frame (host clock, card synchronized, the "
            f"packed fetch included; frames that captured left out)")
    taken = {r["branch"] for r in rows}
    if not {"motion model", "reference keyframe (no velocity)"} <= taken:
        bad.append(f"the path took only {taken}")

    # The late snapshots: the reference branch (frame 157), the motion model (158).
    res = {}
    for snap, name in zip(MAP_SNAP[2:], ("reference keyframe", "motion model")):
        st, img = s.snapshots[snap]
        eager = lambda st=st, img=img: _fused(st, img, s.inv_sigma2)  # noqa: E731
        graphed = lambda st=st, img=img: _fused(st, img, s.inv_sigma2, run=run)  # noqa: E731
        e_ms, g_ms = cuda_ms_turns([eager, graphed], reps=GRAPH_REPS, warmup=1)
        reads = {w: count_syncs(lambda f=f: f()[-1].cpu())[1][:-1] for w, f in (("eager", eager), ("graphed", graphed))}
        calls = {w: api_calls(f) for w, f in (("eager", eager), ("graphed", graphed))}
        res[name] = dict(eager_ms=e_ms, graphed_ms=g_ms, reads=reads, calls=calls)
        log(f"  the frame-{snap} state, {name} branch: eager {e_ms:.3f} ms, graphed {g_ms:.3f} ms per frame "
            f"(CUDA-event medians of {GRAPH_REPS}, in turns), {e_ms / g_ms:.2f}x; device->host reads in the step "
            f"eager {len(reads['eager'])}, graphed {len(reads['graphed'])} (at {reads['graphed']}); host API "
            f"calls per frame eager {sum(calls['eager'].values())} {calls['eager']}, graphed "
            f"{sum(calls['graphed'].values())} {calls['graphed']}")
        if len(reads["graphed"]) > len(reads["eager"]):
            bad.append(f"{name}: {len(reads['graphed'])} reads graphed against {len(reads['eager'])} eager")
        if sum(calls["graphed"].values()) >= 100:
            bad.append(f"{name}: {sum(calls['graphed'].values())} host API calls graphed")

    # The retry and the fallback, forced by a turned velocity on the last
    # snapshot's state: each graphed against eager.
    st, img = s.snapshots[MAP_SNAP[-1]]
    for deg in GRAPH_YAWS:
        w = torch.zeros(6, device=img.device)
        w[1] = float(np.deg2rad(deg))
        turned = st._replace(vel_R=se3_exp(w)[0] @ st.vel_R)
        ran.clear()
        g = _fused(turned, img, s.inv_sigma2, run=run)
        branch = GRAPH_BRANCHES[tuple(ran)]
        e = _fused(turned, img, s.inv_sigma2)
        equal = all(torch.equal(a, b) for a, b in zip(list(e[0]) + list(e[1:]), list(g[0]) + list(g[1:])))
        p = g[-1].cpu().numpy()
        log(f"  the frame-{MAP_SNAP[-1]} state, its velocity turned by {deg} deg: {branch}, accepted "
            f"{p[steps.FUSED_ACCEPT]:.0f}, {p[steps.FUSED_N_TRACKED]:.0f} tracked; graphed "
            f"{'equal to' if equal else 'DIFFERENT from'} eager")
        if not equal:
            bad.append(f"the turned velocity ({deg} deg): the graphed step differs from the eager one")

    for c in graphs.captured:
        log(f"  captured {c['segment']} {c['static']}: warm-up {c['warmup_ms']:.1f} ms, capture "
            f"{c['capture_ms']:.1f} ms, instantiation {c['instantiate_ms']:.1f} ms; {c['nodes']} nodes, "
            f"{c['kernel_nodes']} kernel nodes; kernel launches in it {c['launches']}")
    # The copy-in of a replaced map: every map field a segment reads, into
    # buffers of its shape, one _foreach_copy_ per dtype.
    st = s.snapshots[MAP_SNAP[-1]][0]
    fields = sorted(set(steps.MM_MAP_FIELDS + steps.REF_MAP_FIELDS + steps.LOCAL_MAP_FIELDS))
    groups = {}
    for f in fields:
        x = getattr(st.m, f)
        dst, src = groups.setdefault(x.dtype, ([], []))
        dst.append(torch.empty_like(x))
        src.append(x)
    nbytes = sum(x.numel() * x.element_size() for _, src in groups.values() for x in src)
    copy_ms, = cuda_ms_turns([lambda: [torch._foreach_copy_(d, c) for d, c in groups.values()]], ahead=True)
    copy_calls = api_calls(lambda: [torch._foreach_copy_(d, c) for d, c in groups.values()])
    log(f"  copy-in of a replaced map ({len(fields)} fields, {nbytes / 2**20:.1f} MiB, {len(groups)} "
        f"dtypes): {copy_ms:.4f} ms of device time ({nbytes / copy_ms / 1e6:.1f} GB/s), host API calls "
        f"{copy_calls}; graph pool {graphs.pool_bytes() / 2**20:.1f} MiB, static buffers "
        f"{graphs.buffer_bytes() / 2**20:.1f} MiB; kernel launches by replay {graphs.replayed_launches}")
    if bad:
        raise AssertionError(f"graphs: {bad}")
    return launches


def graph_report(name: str, tr) -> list:
    """Print a session's graph counts (steady-state frames replayed from
    the tracker's graphs, captures, their ms, the pool's bytes); the
    failure: a steady-state frame that did not replay."""
    g, st = tr.graphs, tr.stats
    cap_ms = [c["capture_ms"] + c["instantiate_ms"] for c in g.captured]
    log(f"  {name} graphs: graph_replays {st['graph_replays']} of {st['dispatches']} steady-state "
        f"frames, graph_captures {st['graph_captures']} ({', '.join(c['segment'] for c in g.captured)}), "
        f"capture and instantiation {_ms(cap_ms)} each, {g.replays} segment replays, kernel launches "
        f"by replay {g.replayed_launches}; graph pool "
        f"{g.pool_bytes() / 2**20:.1f} MiB, static buffers {g.buffer_bytes() / 2**20:.1f} MiB")
    init = tr.metrics.timer.samples.get("init.global_ba", [])
    log(f"  {name} global BA: gba_iters {st['gba_iters']}, gba_graph_replays {st['gba_graph_replays']}, "
        f"gba_graph_captures {st['gba_graph_captures']}; the initial global BA (its capture included) "
        f"{_ms([v * 1e3 for v in init])}")
    bad = []
    if st["graph_replays"] != st["dispatches"]:
        bad.append(f"{name}: {st['graph_replays']} graph replays for {st['dispatches']} steady-state frames")
    if st["gba_graph_replays"] != st["gba_iters"]:
        bad.append(f"{name}: {st['gba_graph_replays']} global-BA replays for {st['gba_iters']} LM iterations")
    return bad


def watch_map_jobs(tr) -> list:
    """Wrap the tracker's keyframe job so that each one appends to the
    returned list whether it captured a mapping graph and whether all its
    segments replayed (map_graph_replays rose; a captured graph replays at
    once, so a capturing job replays too)."""
    recs = []
    orig = tr._mapping_compute

    def wrapped(m, ki):
        c, r = tr.map_graphs.captures, tr.stats["map_graph_replays"]
        out = orig(m, ki)
        recs.append(dict(captured=tr.map_graphs.captures > c, replayed=tr.stats["map_graph_replays"] > r))
        return out

    tr._mapping_compute = wrapped
    return recs


def keep_jobs_on_host(tr, jobs) -> dict:
    """Wrap the tracker's keyframe job so that the inputs of the jobs with
    these indices (from 0) are kept as {index: (numpy map, slot)}: on the
    host, so the session's peak card memory does not count them."""
    kept, calls = {}, [0]
    orig = tr._mapping_compute

    def wrapped(m, ki):
        if calls[0] in jobs:
            kept[calls[0]] = (map_to_numpy(m), ki)
        calls[0] += 1
        return orig(m, ki)

    tr._mapping_compute = wrapped
    return kept


def keep_first_global_ba(tr) -> dict:
    """Wrap the tracker's global BA so that its first call's input map is
    kept on the host (numpy) with its iteration count: {"map", "iters"}."""
    kept = {}
    orig = tr._global_ba

    def wrapped(m, iters=20, graphs=None):
        if not kept:
            kept.update(map=map_to_numpy(m), iters=iters)
        return orig(m, iters=iters, graphs=graphs)

    tr._global_ba = wrapped
    return kept


def profiled(fn) -> dict:
    """One call of fn under torch.profiler: {"wall": ms, "calls": {host API
    call: count}, "device_ms": the device's own events summed}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ev = prof.key_averages()
    return dict(wall=wall, calls={e.key: e.count for e in ev if e.key in API_CALLS},
                device_ms=sum(_dev_time(e) for e in ev if e.device_type == DeviceType.CUDA) / 1e3)


def per_iteration(call) -> dict:
    """One iteration of call(iters), as call(2) under the profiler less
    call(1) (the set-up around the iterations cancels): {"calls": host API
    calls by name, "n": their sum, "device_ms"}."""
    two, one = profiled(lambda: call(2)), profiled(lambda: call(1))
    calls = {k: two["calls"].get(k, 0) - one["calls"].get(k, 0)
             for k in sorted(set(two["calls"]) | set(one["calls"]))}
    return dict(calls=calls, n=sum(calls.values()), device_ms=two["device_ms"] - one["device_ms"])


def global_ba_both_ways(name: str, tr, kept: dict, smi: str, full: bool = True) -> list:
    """The session's initial global BA again from its input (kept by
    keep_first_global_ba), through the tracking thread's graphs (replays:
    the session captured them) and eagerly, 2 runs each in turns: the
    poses and points torch.equal, wall ms, reads; with `full` also host API
    calls and device ms per LM iteration, the graphed call's device ms and
    each way's peak memory. Returns the failures."""
    m = map_to_torch(kept["map"], "cuda")
    iters = kept["iters"]
    captures = tr.graphs.captures
    eager_graphs = StepGraphs("cuda")
    eager_graphs.run = steps.call_segment
    ways = (("eager", eager_graphs), ("graphed", tr.graphs))
    res = both_ways(lambda: None, lambda: tr._global_ba(m, iters=iters, graphs=tr.graphs), lambda: (),
                    [tr.graphs], reps=2)
    reads = {w: count_syncs(lambda g=g: tr._global_ba(m, iters=iters, graphs=g))[1] for w, g in ways}
    log(f"  {name} initial global BA again from its input ({iters} LM iterations over "
        f"{m.capacity_kf * m.kf_obs_pt.shape[1]} edge slots, 2 runs each in turns): graphed against eager "
        f"{'torch.equal' if res['equal'] else 'DIFFERENT'} (poses, points); eager {_ms(res['ms']['eager'])}, "
        f"graphed {_ms(res['ms']['graphed'])} (wall, card synchronized); device->host reads eager "
        f"{len(reads['eager'])}, graphed {len(reads['graphed'])} (at {reads['graphed']}); new captures "
        f"{tr.graphs.captures - captures}")
    bad = []
    if not res["equal"]:
        bad.append(f"{name}: the graphed global BA differs from the eager one")
    if len(reads["graphed"]) > len(reads["eager"]):
        bad.append(f"{name}: the global BA reads more graphed")
    if full:
        it = {w: per_iteration(lambda k, g=g: tr._global_ba(m, iters=k, graphs=g)) for w, g in ways}
        whole = profiled(lambda: tr._global_ba(m, iters=iters, graphs=tr.graphs))
        peak = {w: peak_gib(lambda g=g: tr._global_ba(m, iters=iters, graphs=g))[1] for w, g in ways}
        log(f"  one LM iteration of it: host API calls eager {it['eager']['n']} {it['eager']['calls']}, graphed "
            f"{it['graphed']['n']} {it['graphed']['calls']}; device time eager {it['eager']['device_ms']:.3f} ms, "
            f"graphed {it['graphed']['device_ms']:.3f} ms; the graphed call under the profiler: device time "
            f"{whole['device_ms']:.3f} ms of {whole['wall']:.3f} ms wall, {sum(whole['calls'].values())} host "
            f"API calls; peak memory eager {peak['eager']:.3f} GiB, graphed {peak['graphed']:.3f} GiB; the "
            f"global BA's static buffers {sum(b.numel() * b.element_size() for k, b in tr.graphs._buffers.items() if k[0].startswith(('prob', 'plans'))) / 2**20:.1f} MiB")
        if not it["graphed"]["n"] < 50:
            bad.append(f"{name}: {it['graphed']['n']} host API calls per graphed LM iteration")
    if tr.graphs.captures != captures:
        bad.append(f"{name}: the global BA captured again")
    return bad


def map_graph_report(name: str, tr, recs: list) -> list:
    """Print a session's mapping-graph counts (keyframe jobs replayed from
    the tracker's map_graphs, its captures with their ms and kernel nodes,
    the pool's and the static buffers' bytes); the failures: a job that did
    not replay every segment, or more captures than the mapping has
    segments."""
    g, st = tr.map_graphs, tr.stats
    log(f"  {name} mapping graphs: map_graph_replays {st['map_graph_replays']} of {st['map_jobs']} keyframe "
        f"jobs ({sum(r['captured'] for r in recs)} of the session's {len(recs)} captured), "
        f"map_graph_captures {st['map_graph_captures']} ({captures_report(g)}); graph pool "
        f"{g.pool_bytes() / 2**20:.1f} MiB, static buffers {g.buffer_bytes() / 2**20:.1f} MiB, copied in "
        f"{g.copied_bytes / max(st['map_jobs'], 1) / 2**20:.1f} MiB a job")
    bad = []
    missed = [j for j, r in enumerate(recs) if not r["replayed"]]
    if not recs or missed:
        bad.append(f"{name}: keyframe jobs {missed} of {len(recs)} did not replay every segment")
    if st["map_graph_captures"] > MAP_GRAPH_KEYS:
        bad.append(f"{name}: {st['map_graph_captures']} mapping captures")
    return bad


def steady_keyframe_line(kf_ms: list, stages: dict, recs: list) -> str:
    """The keyframe frames whose job captured nothing (the steady state):
    the frame and each stage (lists aligned with the jobs), medians."""
    keep = [j for j, r in enumerate(recs) if not r["captured"]]
    parts = ", ".join(f"{k} {_ms([v[j] for j in keep if j < len(v)])}" for k, v in stages.items())
    return (f"  keyframe frame after the mapping captures ({len(keep)} of {len(recs)} jobs replayed every "
            f"segment): {_ms([kf_ms[j] for j in keep])}; of which {parts}")


def watch_loop_stage(tr) -> list:
    """Wrap the tracker's loop-closing hand-off so each keyframe's
    device->host reads in it (count_syncs) append to the returned list."""
    reads = []
    orig = tr._close_loops

    def wrapped(m, ki):
        out, sites = count_syncs(lambda: orig(m, ki))
        reads.append(sites)
        return out

    tr._close_loops = wrapped
    return reads


def loop_stage_report(name: str, tr, reads: list, smi: str) -> list:
    """Print the session's loop stage (ms and reads per keyframe); the
    failures: a keyframe job without it, or a loop closed on a path that
    revisits nothing."""
    st = tr.metrics.timer.samples
    loop_ms = [v * 1e3 for v in st.get("map.loop", [])]
    det_ms = [v * 1e3 for v in st.get("loop.detect", [])]
    n = [len(x) for x in reads]
    lc = tr.loop_closer
    log(f"  {name} loop stage on {smi} (default TrackerConfig, loop closing on, "
        f"{lc.voc.n_words if lc.voc is not None else 0} words): {_ms(loop_ms)} per keyframe, of which "
        f"detection {_ms(det_ms)}; device->host reads per keyframe median "
        f"{statistics.median(n) if n else 0}, max {max(n) if n else 0} (the last keyframe's at "
        f"{reads[-1] if reads else []}); loops closed {lc.n_loops_closed}")
    bad = []
    if len(loop_ms) != tr.metrics.counters["frames.keyframe"] or not loop_ms:
        bad.append(f"{name}: {len(loop_ms)} loop stages for {tr.metrics.counters['frames.keyframe']} keyframes")
    if lc.n_loops_closed:
        bad.append(f"{name}: {lc.n_loops_closed} loops closed on a path that revisits nothing")
    return bad


def phase_mono(scene: StepWallScene, smi: str, work: str) -> dict:
    """Mono SLAM through the port's System at the default capacities (see
    the module docstring). Returns the kernels' launches in the session,
    and for the facade phase the finished map saved with System.save_map
    into `work` (its path and the save's ms), the session's trajectory, the
    true poses and the Sim3 alignment: host data only, so that no later
    phase's peak memory counts this session."""
    poses = orbit_trajectory(MONO_FRAMES + 3, **MAP_POSES)
    frames = render_frames(scene, CAM, poses, device="cuda")
    system = System(CAM, orb=CFG, device="cuda")  # the default TrackerConfig: loop closing on
    tr = system.tracker
    tr.stage_sync = True  # the stage timers hold device time
    kept = keep_mapping_inputs(tr, jobs={MONO_SNAP_JOB})
    host_jobs = keep_jobs_on_host(tr, set(MAP_GRAPH_MONO_JOBS))
    map_recs = watch_map_jobs(tr)
    loop_reads = watch_loop_stage(tr)
    init_gba = keep_first_global_ba(tr)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    rec, peaks = [], {}
    record = session_recorder(tr, rec)

    def on_frame(i, out):
        if "init" not in peaks and tr.state == TrackingState.OK:
            peaks["init"] = torch.cuda.max_memory_allocated()  # up to the initial global BA
            torch.cuda.reset_peak_memory_stats()
        record(i, out)

    t0 = time.perf_counter()
    res = mono_session(system, frames[:MONO_FRAMES], on_frame=on_frame)
    wall = session_s = time.perf_counter() - t0
    launches = dict(rec[-1]["launches"])
    peak = torch.cuda.max_memory_allocated()  # after initialization

    kinds = frame_kinds(rec)
    ok_at = [i for i, r in enumerate(rec) if r["state"] == "OK"]
    init = ok_at[0] if ok_at else None
    ms = [m for _, m in res]
    for i in range(0, MONO_FRAMES, 10):
        log(f"  frame {i}: {kinds[i]['state']} {kinds[i]['kind']}, {ms[i]:.1f} ms, launches "
            f"{kinds[i]['launches']}")
    m = tr.map
    n_kf = int(m.kf_valid.sum())
    n_pt = int(m.pt_valid.sum())
    mapped = int(((m.pt_first_kf >= 2) & m.pt_valid).sum())
    traj = tr.export_trajectory()
    ate, n_tracked, (s, Ra, ta) = trajectory_ate(traj, poses)
    C = np.stack([-np.asarray(R).T @ np.asarray(t) for R, t in poses[:MONO_FRAMES]])
    span = float(np.linalg.norm(C[-1] - C[0]))
    after = MONO_FRAMES - 1 - init if init is not None else 0
    tracked_after = sum(1 for fid, _, _, lost in traj if not lost and init is not None and fid > init)
    log(f"mono SLAM on {smi}: {MONO_FRAMES} frames in {wall:.1f} s (stage syncs on), initialized at "
        f"frame {init}, end state {tr.state.name}; {n_kf} valid keyframes ({tr._n_kf_host} inserted), "
        f"{n_pt} valid points ({mapped} made by mapping_front) of {m.capacity_pt}; tracked "
        f"{tracked_after}/{after} frames after initialization; ATE {ate:.4f} m over a {span:.3f} m path "
        f"({ate / span:.2%}), Sim3 scale {s:.4f}; peak memory allocated up to and with "
        f"initialization {peaks.get('init', 0) / 2**30:.3f} GiB, after it {peak / 2**30:.3f} GiB")
    log(f"  launches in the session: {launches}; frames by kind: "
        f"{ {k: sum(1 for x in kinds if x['kind'] == k) for k in set(x['kind'] for x in kinds)} }")

    # Times by frame kind and stage (stage syncs on, so each is device time).
    st = tr.metrics.timer.samples
    kf_idx = [i for i, x in enumerate(kinds) if x["kind"] == "keyframe"]
    front, ba1, ba2, loop = ([v * 1e3 for v in st.get(k, [])]
                             for k in ("map.front", "map.local_ba1", "map.local_ba2", "map.loop"))
    rest = [ms[i] - f - b1 - b2 - lp for i, f, b1, b2, lp in zip(kf_idx, front, ba1, ba2, loop)]
    log(f"mono SLAM times on {smi} (medians over the session's frames):")
    for kind in ("motion model", "reference keyframe"):
        log(f"  tracking frame without a keyframe, {kind} branch: "
            f"{_ms([ms[i] for i, x in enumerate(kinds) if x['kind'] == kind])}")
    log(f"  keyframe frame: {_ms([ms[i] for i in kf_idx])}; of which mapping_front {_ms(front)}, "
        f"local BA chunk 1 {_ms(ba1)}, chunk 2 {_ms(ba2)}, loop closing {_ms(loop)}, the rest "
        f"(tracking step, insertion, normals) {_ms(rest)}")
    session_recs = map_recs[:len(kf_idx)]
    log(steady_keyframe_line([ms[i] for i in kf_idx], {
        "mapping_front": front, "local BA chunk 1": ba1, "chunk 2": ba2, "loop closing": loop,
        "the rest": rest, "normals": [v * 1e3 for v in st.get("map.normals", [])]}, session_recs))
    log(f"  captures: tracking {_ms([v * 1e3 for v in st.get('track.capture', [])])}, mapping "
        f"{_ms([v * 1e3 for v in st.get('map.capture', [])])} (inside the frames and stages above)")
    log(f"  initialization: two-view {_ms([v * 1e3 for v in st.get('init.two_view', [])])}, "
        f"global BA (20 LM iterations over {m.capacity_kf * m.kf_obs_pt.shape[1]} edge slots) "
        f"{_ms([v * 1e3 for v in st.get('init.global_ba', [])])}")

    bad = []
    if init is None or init >= MONO_INIT_BY:
        bad.append(f"initialized at frame {init}")
    if tr.state != TrackingState.OK:
        bad.append(f"ended in {tr.state.name}")
    if tracked_after < MONO_TRACKED * after:
        bad.append(f"tracked {tracked_after}/{after}")
    if n_kf < 10 or mapped == 0:
        bad.append(f"{n_kf} keyframes, {mapped} mapped points")
    if not ate < MONO_ATE_SHARE * span:
        bad.append(f"ATE {ate:.4f} >= {MONO_ATE_SHARE:.0%} of {span:.3f}")
    if missing_kernels(kinds):
        bad.append(f"frames short of a kernel: {missing_kernels(kinds)}")
    bad += loop_stage_report("mono", tr, loop_reads, smi)
    bad += graph_report("mono", tr)
    bad += map_graph_report("mono", tr, session_recs)
    if bad:
        raise AssertionError(f"mono SLAM: {bad}")
    del tr._close_loops, tr._global_ba  # the instance's own methods again
    tr.stage_sync = False
    bad = global_ba_both_ways("mono", tr, init_gba, smi)
    if bad:
        raise AssertionError(f"mono SLAM: {bad}")

    # Reads per frame on the finished map (no keyframes: localization mode).
    tr.stage_sync = False
    tr.localization_mode = True
    reads = {}
    for i, kind in zip(range(MONO_FRAMES, MONO_FRAMES + 3), (None, "reference keyframe", "motion model")):
        if kind == "reference keyframe":
            tr._velocity = None
        before = dict(tr.metrics.counters)
        (out, sites), gib = peak_gib(lambda: count_syncs(lambda: system.track_monocular(frames[i], i / 30.0)))
        got = ("motion model" if tr.metrics.counters["frames.motion_model"] > before.get("frames.motion_model", 0)
               else "reference keyframe")
        if kind is not None:
            if out is None or got != kind:
                raise AssertionError(f"mono SLAM: frame {i} was not tracked by the {kind} branch")
            reads[kind] = (sites, gib)
    tr.localization_mode = False
    for kind, n in (("motion model", 2), ("reference keyframe", 1)):
        log(f"  device->host reads of a {kind} frame through the Tracker: {len(reads[kind][0])} "
            f"(at most {n}), at {reads[kind][0]}; peak memory {reads[kind][1]:.3f} GiB")
    reads = {k: v[0] for k, v in reads.items()}
    if len(reads["motion model"]) > 2 or len(reads["reference keyframe"]) > 1:
        raise AssertionError(f"mono SLAM: too many reads per frame: {reads}")

    # One keyframe job on the card and on the CPU from the same snapshot,
    # each with a fresh loop closer (the same vocabulary): the session's
    # closer has seen later keyframes.
    m_snap, ki = kept[MONO_SNAP_JOB]
    session_lc = tr.loop_closer
    tr.loop_closer = tr._new_loop_closer(session_lc.voc)
    (out_gpu, sites), gib = peak_gib(lambda: count_syncs(lambda: tr._mapping_compute(m_snap, ki)))
    tr.loop_closer = session_lc
    log(f"  device->host reads of the keyframe job of slot {ki}: {len(sites)}, at {sites}; "
        f"peak memory {gib:.3f} GiB")
    cfg = tr.cfg
    m_front, g_front = peak_gib(lambda: steps.mapping_front(
        CAM, m_snap, ki, tr.inv_sigma2, 3.0, scale_factor=CFG.scale_factor, n_levels=CFG.n_levels,
        nn_tri=20, nn_fuse=20, fuse_hop=cfg.fuse_second_hop, window=cfg.local_ba_window))
    m_ba, g_ba = peak_gib(lambda: tr._local_ba(m_front, ki, iters=4))
    _, g_norm = peak_gib(lambda: update_point_normals(m_ba, tr.scale_factors))
    log(f"  its stages alone, peak memory: mapping_front {g_front:.3f} GiB, a local-BA chunk "
        f"{g_ba:.3f} GiB, update_point_normals {g_norm:.3f} GiB")
    tr_cpu = Tracker(tr.cfg, device="cpu")
    tr_cpu.loop_closer.voc = session_lc.voc.to("cpu")
    t0 = time.perf_counter()
    out_cpu = tr_cpu._mapping_compute(map_to_torch(map_to_numpy(m_snap), "cpu"), ki)
    g = map_to_torch(map_to_numpy(out_gpu), "cpu")
    live = (g.kf_obs_pt >= 0) | (out_cpu.kf_obs_pt >= 0)
    same_obs = float((g.kf_obs_pt == out_cpu.kf_obs_pt)[live].float().mean())
    v = out_cpu.kf_valid
    dR = float((g.kf_R[v] - out_cpu.kf_R[v]).abs().max())
    dt = float((g.kf_t[v] - out_cpu.kf_t[v]).abs().max())
    log(f"  the keyframe job on the CPU: {time.perf_counter() - t0:.1f} s; card vs CPU: kf_valid "
        f"{'equal' if torch.equal(g.kf_valid, v) else 'DIFFERENT'}, live kf_obs_pt equal {same_obs:.4f}, "
        f"valid points {int(g.pt_valid.sum())} vs {int(out_cpu.pt_valid.sum())}, max |dR| {dR:.2e}, "
        f"max |dt| {dt:.2e}")
    if not (torch.equal(g.kf_valid, v) and same_obs >= 0.995 and dR < POSE_TOL and dt < POSE_TOL):
        raise AssertionError("mono SLAM: the keyframe job differs on the card and the CPU")

    tr.loop_closer = tr._new_loop_closer(session_lc.voc)
    wall, n_launch, dev_us, top = profile_call(lambda: tr._mapping_compute(m_snap, ki))
    tr.loop_closer = session_lc
    log(f"  one profiled keyframe job: {n_launch} kernel launches, device time {dev_us / 1e3:.3f} ms "
        f"of {wall:.3f} ms wall under the profiler; most device time:")
    log_top(top)

    # Forced LOST, then an earlier frame: relocalization through the BoW
    # candidates, then the brute-force branch alone on the same frame.
    feats = tr._frame_features(frames[MONO_RELOC_FRAME])
    cands = tr._reloc_candidate_kfs(feats)
    if not cands:
        raise AssertionError("mono SLAM: no BoW relocalization candidates")
    tr.state = TrackingState.LOST
    tr._velocity = None
    lost = tracker_state(tr)
    n_cap = len(tr.graphs.captured)
    out, reloc_gib = peak_gib(lambda: system.track_monocular(frames[MONO_RELOC_FRAME], 99.0))
    reloc_ms = tr.metrics.timer.samples["track.relocalize"][-1] * 1e3
    if out is None or tr.state != TrackingState.OK:
        raise AssertionError("mono SLAM: no relocalization after a forced LOST")
    if tr.reloc_path != "bow":
        raise AssertionError(f"mono SLAM: the relocalization took the {tr.reloc_path} branch")
    log(f"  the first relocalization (its segments captured): {reloc_ms:.3f} ms; captures "
        f"{captures_report(tr.graphs, n_cap)}")
    # Graphed (replays) against eager on the same frame from the same state.
    replays = tr.graphs.replays
    cmp = both_ways(lambda: tracker_restore(tr, lost),
                    lambda: system.track_monocular(frames[MONO_RELOC_FRAME], 99.0),
                    lambda: tracker_result(tr), [tr.graphs], reps=3, io=True)
    log(f"  the relocalization graphed against eager, from the same state (3 runs each, in turns): "
        f"{'torch.equal' if cmp['equal'] else 'DIFFERENT'} (verdict, pose, assignment, trajectory "
        f"entry); eager {_ms(cmp['ms']['eager'])}, graphed {_ms(cmp['ms']['graphed'])} (wall, card "
        f"synchronized); {tr.graphs.replays - replays} segment replays; {io_report(cmp)}")
    if not cmp["equal"]:
        raise AssertionError("mono SLAM: the graphed relocalization differs from the eager one")
    if len(cmp["reads"]["graphed"]) > len(cmp["reads"]["eager"]):
        raise AssertionError(f"mono SLAM: relocalization reads graphed {cmp['reads']['graphed']} "
                             f"against eager {cmp['reads']['eager']}")
    tracker_restore(tr, lost)
    out = system.track_monocular(frames[MONO_RELOC_FRAME], 99.0)
    R, t = out
    Rg, tg = poses[MONO_RELOC_FRAME]
    err = float(np.linalg.norm(s * (-R.T @ t) @ Ra.T + ta - (-np.asarray(Rg).T @ np.asarray(tg))))
    log(f"  relocalization of frame {MONO_RELOC_FRAME} after a forced LOST: {reloc_ms:.3f} ms through "
        f"the BoW candidates {cands} (their points matched, EPnP RANSAC, pose optimization, "
        f"projective widening, TrackLocalMap); aligned centre error {err:.4f} m; peak memory "
        f"{reloc_gib:.3f} GiB")
    if not err < MONO_ATE_SHARE * span:
        raise AssertionError(f"mono SLAM: relocalized {err:.4f} m from the truth")
    tr.state = TrackingState.LOST
    wall, n_launch, dev_us, top = profile_call(lambda: system.track_monocular(frames[MONO_RELOC_FRAME], 99.0))
    log(f"  the same relocalization profiled: {n_launch} kernel launches, device time "
        f"{dev_us / 1e3:.3f} ms of {wall:.3f} ms wall under the profiler; most device time:")
    log_top(top)
    if tr.state != TrackingState.OK or tr.reloc_path != "bow":
        raise AssertionError("mono SLAM: the profiled relocalization failed")
    # The brute-force branch (every map point against the frame, the path
    # without a database) on the same frame, for comparison.
    tr._reloc_candidate_kfs = lambda f: None
    try:
        tr.state = TrackingState.LOST
        system.track_monocular(frames[MONO_RELOC_FRAME], 99.0)
        bf_ms = tr.metrics.timer.samples["track.relocalize"][-1] * 1e3
        bf_ok = tr.state == TrackingState.OK and tr.reloc_path == "brute_force"
        tr.state = TrackingState.LOST
        wall_bf, n_bf, dev_bf, _ = profile_call(lambda: system.track_monocular(frames[MONO_RELOC_FRAME], 99.0))
    finally:
        del tr._reloc_candidate_kfs
    log(f"  the brute-force branch alone on the same frame (match over {m.capacity_pt} point slots): "
        f"{bf_ms:.3f} ms ({'relocalized' if bf_ok else 'FAILED'}); profiled: {n_bf} kernel launches, "
        f"device time {dev_bf / 1e3:.3f} ms of {wall_bf:.3f} ms wall. BoW against brute force, both "
        f"graphed after their captures: {statistics.median(cmp['ms']['graphed']):.3f} against "
        f"{bf_ms:.3f} ms, {n_launch} against {n_bf} launches")
    path = f"{work}/mono_map.npz"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    system.save_map(path)
    save_ms = (time.perf_counter() - t0) * 1e3
    by_kind = {k: [ms[i] for i, x in enumerate(kinds) if x["kind"] == k]
               for k in ("motion model", "reference keyframe", "keyframe")}
    return launches, dict(path=path, save_ms=save_ms, traj=tr.export_trajectory(), poses=poses,
                          align=(s, Ra, ta), ms_by_kind=by_kind, wall=session_s, map_jobs=host_jobs)


def phase_stereo_kernels(scene: StepWallScene, smi: str) -> dict:
    """Both kernels at the stereo front end's shapes, each against its plain
    version (torch.equal), then timed as kernel_times does: FAST+NMS over
    the 8 levels of a KITTI-sized (2, 376, 1241) batch in one launch, and
    the gather on that batch's 1257-byte-wide atlas at the describe windows
    and at the SAD windows of the stereo match."""
    (L, R), = render_stereo_frames(scene, KITTI_CAM, orbit_trajectory(1, **STEREO_POSES), device="cuda")
    imgs = torch.stack([L, R])
    cfg, th = KITTI_ORB, KITTI_ORB.min_th_fast
    err = {"fast_nms": 0.0, "gather_patches": 0.0}
    levels = build_pyramid(imgs, cfg.n_levels, cfg.scale_factor)
    before = fast_nms.launches
    got = fast_nms_pyramid(levels, th)
    torch.cuda.synchronize()
    if fast_nms.launches != before + 1:
        raise AssertionError("stereo shapes: fast_nms_pyramid did not launch once")
    for x, g in zip(levels, got):
        ref = fast_nms_plain(x, th)
        if not torch.equal(g, ref):
            raise AssertionError(f"stereo shapes: fast_nms differs from its plain version at {tuple(x.shape)}")
        err["fast_nms"] = max(err["fast_nms"], float((g - ref).abs().max()))
    log(f"stereo shapes: fast_nms over {[tuple(x.shape) for x in levels]} in one launch: every level equal")

    *_, atlas, corner = detect_batched(imgs, cfg)
    fb, _ = extract_orb_batched_atlas(imgs, cfg)
    fL, fR = (ORBFeatures(*(x[b] for x in fb)) for b in (0, 1))
    tabs = level_tables(tuple(pyramid_shapes(KITTI_CAM.height, KITTI_CAM.width, cfg.n_levels,
                                             cfg.scale_factor)), cfg.scale_factor, atlas.device)
    i1, matched = row_band_match(fL, fR, tabs, KITTI_CAM.fx)
    sad_corner = sad_windows(tabs, 0, atlas.shape[0] // 2, fL.level, fL.xy[:, 0], fL.xy[:, 1],
                             fR.xy[i1, 0])[0]
    windows = {"describe": corner, "sad": sad_corner}
    for name, c in windows.items():
        g = gather_patches(atlas, c)
        torch.cuda.synchronize()
        ref = gather_patches_plain(atlas, c)
        if not torch.equal(g, ref):
            raise AssertionError(f"stereo shapes: gather_patches differs from its plain version ({name})")
        err["gather_patches"] = max(err["gather_patches"], float((g - ref).abs().max()))
        log(f"stereo shapes: gather_patches on the {tuple(atlas.shape)} uint8 atlas at {c.shape[0]} "
            f"{name} windows: equal")

    a32 = atlas.float()
    ar = torch.arange(PSIZE, device=atlas.device)
    fns = {"fast_nms": lambda: fast_nms_pyramid(levels, th),
           "fast_nms plain": lambda: [fast_nms_plain(x, th) for x in levels]}
    for name, c in windows.items():
        rows = (c[:, 0].long()[:, None] + ar)[:, :, None]
        cols = (c[:, 1].long()[:, None] + ar)[:, None, :]
        fns[f"gather {name}"] = lambda c=c: _gather_patches_cuda(atlas, c)
        fns[f"gather {name} plain"] = lambda c=c: gather_patches_plain(atlas, c)
        fns[f"gather {name} library"] = lambda r=rows, k=cols: a32[r, k]
    per_call = dict(zip(fns, cuda_ms_turns(list(fns.values()))))
    dev = dict(zip(fns, cuda_ms_turns(list(fns.values()), ahead=True)))
    bounds = {"fast_nms": fast_bound_ms(levels, th),
              "gather describe": gather_bound_ms(atlas, corner),
              "gather sad": gather_bound_ms(atlas, sad_corner)}
    log(f"kernel times at the stereo shapes on {smi} (CUDA-event medians of {REPS}, in turns; per "
        f"call with the host's gaps, then the device's time alone):")
    for name, (bound, by) in bounds.items():
        lib = (f", library a32[rows, cols] {per_call[name + ' library']:.4f} / "
               f"{dev[name + ' library']:.4f} ms" if name + " library" in per_call else "")
        log(f"  {name}: kernel {per_call[name]:.4f} / {dev[name]:.4f} ms, plain "
            f"{per_call[name + ' plain']:.4f} / {dev[name + ' plain']:.4f} ms{lib}, bound {bound:.4f} ms "
            f"({by}), {bound / dev[name]:.1%} of the bound (device time)")

    # The stereo match around the gather: the SAD refinement (plain PyTorch
    # but its gather) and the whole stereo_match_atlas, for ROADMAP B.
    Ha = atlas.shape[0] // 2
    shapes = tuple(pyramid_shapes(KITTI_CAM.height, KITTI_CAM.width, cfg.n_levels, cfg.scale_factor))
    uL, vL = fL.xy[:, 0], fL.xy[:, 1]
    match = {
        "SAD refinement": lambda: _sad_refine_atlas(atlas, 0, Ha, tabs, fL.level, uL, vL, fR.xy[i1, 0], matched),
        "stereo_match_atlas": lambda: stereo_match_atlas(fL, fR, atlas, 0, Ha, shapes, cfg, KITTI_CAM.fx,
                                                         KITTI_CAM.bf),
    }
    m_call = dict(zip(match, cuda_ms_turns(list(match.values()))))
    m_dev = dict(zip(match, cuda_ms_turns(list(match.values()), ahead=True)))
    for name, fn in match.items():
        _, n_launch, dev_us, _ = profile_call(fn)
        log(f"  {name} at 2000 keypoints: {m_call[name]:.4f} ms per call, {m_dev[name]:.4f} ms of "
            f"device time, {n_launch} kernel launches")
    return dict(err=err, per_call=per_call, dev=dev, bounds=bounds, match_ms=m_call, match_dev=m_dev)


def _centres(traj) -> dict:
    return {fid: -np.asarray(R).T @ np.asarray(t) for fid, R, t, lost in traj if not lost}


def _span(c: dict) -> float:
    k = sorted(c)
    return float(np.linalg.norm(c[k[-1]] - c[k[0]]))


def depth_gates(name: str, traj, poses, n_frames: int) -> tuple:
    """(failures, summary) of a depth sensor's trajectory against the
    truth: >= DEPTH_TRACKED of the frames tracked, the span within
    DEPTH_SPAN_TOL (depth gives true scale), the rigid ATE below
    DEPTH_ATE_SHARE of the span."""
    est = _centres(traj)
    gt = _centres([(i, R, t, False) for i, (R, t) in enumerate(poses[:n_frames])])
    ate, n, _ = trajectory_ate(traj, poses, fix_scale=True)
    span_e, span_g = _span(est), _span(gt)
    bad = []
    if n < DEPTH_TRACKED * n_frames:
        bad.append(f"tracked {n}/{n_frames}")
    if not abs(span_e - span_g) < DEPTH_SPAN_TOL * span_g:
        bad.append(f"span {span_e:.4f} against {span_g:.4f} m")
    if not ate < DEPTH_ATE_SHARE * span_g:
        bad.append(f"rigid ATE {ate:.4f} >= {DEPTH_ATE_SHARE:.0%} of {span_g:.3f} m")
    summary = (f"{n}/{n_frames} frames tracked, span {span_e:.4f} m against {span_g:.4f} m "
               f"({(span_e - span_g) / span_g:+.2%}), rigid ATE {ate:.4f} m ({ate / span_g:.2%} of the span)")
    return [f"{name}: {b}" for b in bad], summary


def phase_depth(name: str, system: System, frames: list, poses, smi: str, front_fn,
                keep_job: int | None = None) -> dict:
    """A stereo or RGB-D session through the port's System on the card (see
    the module docstring): its gates, ms per frame by kind, the front end
    alone, device->host reads by frame kind, peak memory. `frames` holds
    DEPTH_FRAMES session frames and 3 more for the read counts; front_fn(f)
    runs the front end alone on frame f. Returns (launches in the session,
    their medians per frame, and keyframe job `keep_job`'s input (numpy
    map, slot) when asked)."""
    tr = system.tracker
    tr.stage_sync = True  # the stage timers hold device time
    feat_stage = f"track.{name}_features"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    rec = []
    host_jobs = keep_jobs_on_host(tr, {keep_job})
    map_recs = watch_map_jobs(tr)
    loop_reads = watch_loop_stage(tr) if tr.loop_closer is not None else None
    t0 = time.perf_counter()
    res = depth_session(system, frames[:DEPTH_FRAMES], on_frame=session_recorder(tr, rec))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = dict(rec[-1]["launches"])
    kinds = frame_kinds(rec)
    ms = [m for _, m in res]
    m = tr.map
    traj = tr.export_trajectory()
    bad, summary = depth_gates(name, traj, poses, DEPTH_FRAMES)
    for i in range(0, DEPTH_FRAMES, 10):
        log(f"  frame {i}: {kinds[i]['state']} {kinds[i]['kind']}, {ms[i]:.1f} ms, launches {kinds[i]['launches']}")
    log(f"{name} SLAM on {smi}: {DEPTH_FRAMES} frames in {wall:.1f} s (stage syncs on), first frame "
        f"{kinds[0]['state']}, end state {tr.state.name}; {int(m.kf_valid.sum())} valid keyframes "
        f"({tr._n_kf_host} inserted), {int(m.pt_valid.sum())} valid points of {m.capacity_pt}; {summary}; "
        f"peak memory allocated {peak:.3f} GiB")
    log(f"  launches in the session: {launches}; frames by kind: "
        f"{ {k: sum(1 for x in kinds if x['kind'] == k) for k in set(x['kind'] for x in kinds)} }")
    st = tr.metrics.timer.samples
    feat = [v * 1e3 for v in st[feat_stage]]
    kf_idx = [i for i, x in enumerate(kinds) if x["kind"] == "keyframe"]
    front, ba1, ba2 = ([v * 1e3 for v in st.get(k, [])] for k in ("map.front", "map.local_ba1", "map.local_ba2"))
    loop = [v * 1e3 for v in st.get("map.loop", [])] or [0.0] * len(kf_idx)
    rest = [ms[i] - feat[i] - f - b1 - b2 - lp for i, f, b1, b2, lp in zip(kf_idx, front, ba1, ba2, loop)]
    log(f"{name} SLAM times on {smi} (medians over the session's frames):")
    for kind in ("initialization", "motion model", "reference keyframe"):
        idx = [i for i, x in enumerate(kinds) if x["kind"] == kind]
        log(f"  {kind} frame: {_ms([ms[i] for i in idx])}; of which the {name} front end "
            f"{_ms([feat[i] for i in idx])}")
    log(f"  keyframe frame: {_ms([ms[i] for i in kf_idx])}; of which the {name} front end "
        f"{_ms([feat[i] for i in kf_idx])}, mapping_front {_ms(front)}, local BA chunk 1 {_ms(ba1)}, "
        f"chunk 2 {_ms(ba2)}, loop closing {_ms(loop)}, the rest (tracking step, insertion, "
        f"densification, normals) {_ms(rest)}")
    session_recs = map_recs[:len(kf_idx)]
    log(steady_keyframe_line([ms[i] for i in kf_idx], {
        f"the {name} front end": [feat[i] for i in kf_idx], "mapping_front": front, "local BA chunk 1": ba1,
        "chunk 2": ba2, "loop closing": loop, "the rest": rest,
        "normals": [v * 1e3 for v in st.get("map.normals", [])]}, session_recs))
    log(f"  captures: tracking {_ms([v * 1e3 for v in st.get('track.capture', [])])}, mapping "
        f"{_ms([v * 1e3 for v in st.get('map.capture', [])])} (inside the frames and stages above)")
    if loop_reads is not None:
        bad += loop_stage_report(name, tr, loop_reads, smi)
        del tr._close_loops
    if kinds[0]["state"] != "OK":
        bad.append(f"{name}: not initialized on the first frame")
    if tr.state != TrackingState.OK:
        bad.append(f"{name}: ended in {tr.state.name}")
    if missing_kernels(kinds):
        bad.append(f"{name}: frames short of a kernel: {missing_kernels(kinds)}")
    bad += graph_report(name, tr)
    bad += map_graph_report(name, tr, session_recs)
    if bad:
        raise AssertionError(f"{name} SLAM: {bad}")

    # The front end alone: device time and reads.
    tr.stage_sync = False
    f0 = frames[DEPTH_FRAMES - 1]
    front_ms = cuda_ms(lambda: front_fn(f0))
    _, front_sites = count_syncs(lambda: front_fn(f0))
    log(f"  the {name} front end alone: {front_ms:.3f} ms (CUDA-event median of {REPS}), "
        f"{len(front_sites)} device->host reads{f' at {front_sites}' if front_sites else ''}")
    if name == "stereo" and front_sites:
        raise AssertionError(f"stereo SLAM: the stereo front end read the device: {front_sites}")
    # Reads through the Tracker by frame kind, on 3 frames past the session,
    # the keyframe decision forced each way.
    reads = {}
    for i, (kind, insert) in zip(range(DEPTH_FRAMES, DEPTH_FRAMES + 3),
                                 (("reference keyframe", False), ("motion model", False), ("keyframe", True))):
        if kind == "reference keyframe":
            tr._velocity = None
        tr._need_new_keyframe = lambda *a, insert=insert: insert
        before = dict(tr.metrics.counters)
        try:
            (res1, sites), gib = peak_gib(lambda: count_syncs(lambda: depth_session(system, [frames[i]])))
        finally:
            del tr._need_new_keyframe
        got = frame_kinds([dict(counters=dict(tr.metrics.counters), state="", launches={})],
                          before)[0]["kind"]
        if res1[0][0] is None or got != kind:
            raise AssertionError(f"{name} SLAM: frame {i} was not tracked as a {kind} frame ({got})")
        reads[kind] = sites
        log(f"  device->host reads of a {kind} frame through the Tracker: {len(sites)}, at {sites}; "
            f"peak memory {gib:.3f} GiB")
    per_frame = {k: statistics.median(x["launches"][k] for x in kinds) for k in launches}
    return dict(launches=launches, per_frame=per_frame, map_job=host_jobs.get(keep_job))


def phase_localization(name: str, system: System, frames: list, poses, smi: str) -> dict:
    """Localization mode after the stereo session: LOC_FRAMES frames past
    the mapped region against the frozen map, with visual-odometry points,
    each frame run eagerly and graphed from the same state (torch.equal),
    then the last frame again from the state before it, forced into mbVO
    (the motion model and the relocalization both), both ways. Fails if the map changes, fewer than
    LOC_TRACKED of the frames are tracked, or a graphed frame differs from
    its eager run or reads more. Returns the launches of the graphed
    frames."""
    tr = system.tracker
    m0 = tr.map
    frozen = {k: getattr(m0, k).clone() for k in ("pt_valid", "pt_xyz", "kf_valid", "kf_R", "kf_t",
                                                  "kf_obs_pt", "n_kf", "n_pt")}
    system.activate_localization_mode()
    zero_launches()
    first = DEPTH_FRAMES + 3
    tracked, vo, ms, eager_ms, bad, io = 0, 0, [], [], [], None
    replays, n_cap = tr.graphs.replays, len(tr.graphs.captured)

    def frame(i):
        return depth_session(system, [frames[i]])

    for i in range(first, first + LOC_FRAMES):
        state = tracker_state(tr)
        with launches_kept():
            cmp = both_ways(lambda: tracker_restore(tr, state), lambda i=i: frame(i)[0][0],
                            lambda: tracker_result(tr), [tr.graphs], io=i == first + LOC_FRAMES - 1)
        if not cmp["equal"]:
            bad.append(f"frame {i}: graphed differs from eager")
        if cmp.get("reads") is not None:
            io = cmp
        eager_ms.append(cmp["ms"]["eager"][0])
        tracker_restore(tr, state)
        seen = launch_counts()
        (out, t_ms), = frame(i)
        tracked += out is not None
        if out is not None and pose_optimization.launches == seen["pose_optimization"]:
            bad.append(f"frame {i}: tracked without a pose kernel")
        vo += bool(tr._vo_mode)
        ms.append(t_ms)
    # The last frame again from the state before it, forced into mbVO: the
    # motion model and the relocalization.
    end = tracker_state(tr)
    tracker_restore(tr, state)
    tr._vo_mode = True
    forced = tracker_state(tr)
    with launches_kept():
        mbvo = both_ways(lambda: tracker_restore(tr, forced), lambda: frame(i)[0][0],
                         lambda: tracker_result(tr), [tr.graphs], reps=2, io=True)
    mbvo_path = tr.reloc_path
    tracker_restore(tr, end)
    system.deactivate_localization_mode()
    launches = launch_counts()
    changed = [k for k, v in frozen.items() if not torch.equal(getattr(tr.map, k), v)]
    traj = tr.export_trajectory()
    _, _, (_, Ra, ta) = trajectory_ate([x for x in traj if x[0] < first], poses, fix_scale=True)
    est = _centres(traj)
    gt = _centres([(i, R, t, False) for i, (R, t) in enumerate(poses)])
    errs = [float(np.linalg.norm(est[i] @ Ra.T + ta - gt[i]))
            for i in range(first, first + LOC_FRAMES) if i in est]
    log(f"{name} localization mode on {smi}: {tracked}/{LOC_FRAMES} frames past the mapped region "
        f"tracked, VO mode engaged on {vo} of them; map changed: {changed or 'no'}; centre error "
        f"against the truth (the session's rigid alignment) median {statistics.median(errs) if errs else float('nan'):.4f} m, "
        f"max {max(errs) if errs else float('nan'):.4f} m; graphed {_ms(ms)} per frame against eager "
        f"{_ms(eager_ms)} (each frame both ways from the same state, "
        f"{LOC_FRAMES - len(bad)}/{LOC_FRAMES} torch.equal); launches {launches}")
    log(f"  {name} localization graphs: {tr.graphs.replays - replays} segment replays, captures "
        f"{captures_report(tr.graphs, n_cap)}; the last frame {io_report(io)}")
    log(f"  frame {i} forced into mbVO (the motion model and the relocalization), twice each way in "
        f"turns: graphed {'torch.equal' if mbvo['equal'] else 'DIFFERENT from'} eager; eager "
        f"{_ms(mbvo['ms']['eager'])}, graphed {_ms(mbvo['ms']['graphed'])} (the first graphed run "
        f"captures the relocalization's segments); tracked {mbvo['out'] is not None}, relocalization "
        f"branch {mbvo_path}; {io_report(mbvo)}")
    bad += graph_report(f"{name} localization", tr)
    for res, what in ((io, "the last frame"), (mbvo, "the mbVO frame")):
        if len(res["reads"]["graphed"]) > len(res["reads"]["eager"]):
            bad.append(f"{what}: reads graphed {res['reads']['graphed']} against eager {res['reads']['eager']}")
    if not mbvo["equal"]:
        bad.append("the mbVO frame: graphed differs from eager")
    if changed or tracked < LOC_TRACKED * LOC_FRAMES or bad:
        raise AssertionError(f"{name} localization mode: map changed {changed}, tracked "
                             f"{tracked}/{LOC_FRAMES}; {bad}")
    return launches


def phase_multi(scene: StepWallScene, smi: str) -> dict:
    """MultiTracker.track_stereo over MULTI_B KITTI-sized streams: one
    batched extraction of the 2B images per frame (exactly one fast_nms
    launch), every frame of every stream tracked, each stream within the
    stereo session's span and rigid-ATE gates. Each frame runs first
    eagerly and graphed from the same state (every stream's pose, state
    and map torch.equal; the batched front end one graph of its own), then
    graphed for the session. Returns the session's launches."""
    paths = [orbit_trajectory(MULTI_FRAMES, **p) for p in MULTI_POSES]
    frames = [render_stereo_frames(scene, KITTI_CAM, p, device="cuda") for p in paths]
    mt = MultiTracker.uniform(TrackerConfig(cam=KITTI_CAM, orb=KITTI_ORB, **MULTI_TRACKER), MULTI_B,
                              device="cuda")
    graphs = [mt.graphs] + [t.graphs for t in mt.trackers]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    per_frame, ms, eager_ms, missed, differ, io = [], [], [], [], [], None
    for i in range(MULTI_FRAMES):
        def call(i=i):
            return mt.track_stereo(torch.stack([f[i][0] for f in frames]),
                                   torch.stack([f[i][1] for f in frames]), i)

        states = [tracker_state(t) for t in mt.trackers]

        def restore(states=states):
            for t, st in zip(mt.trackers, states):
                tracker_restore(t, st)

        with launches_kept():
            cmp = both_ways(restore, call, lambda: [tracker_result(t) for t in mt.trackers], graphs,
                            io=i == MULTI_FRAMES - 1)
        if not cmp["equal"]:
            differ.append(i)
        if "reads" in cmp:
            io = cmp
        eager_ms.append(cmp["ms"]["eager"][0])
        restore()
        seen = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = call()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        per_frame.append(tuple(n - seen[k] for k, n in launch_counts().items()))
        missed += [(i, b) for b, o in enumerate(outs) if o is None]
    launches = launch_counts()
    bad = []
    for b, tr in enumerate(mt.trackers):
        fails, summary = depth_gates(f"stream {b}", tr.export_trajectory(), paths[b], MULTI_FRAMES)
        bad += fails + graph_report(f"stream {b}", tr)
        log(f"  stream {b}: {summary}; {tr._n_kf_host} keyframes")
    log(f"MultiTracker.track_stereo on {smi}: B={MULTI_B} streams at {KITTI_CAM.width}x{KITTI_CAM.height}, "
        f"{KITTI_ORB.n_features} features, {MULTI_FRAMES} frames: graphed {_ms(ms)} per batched frame, "
        f"eager {_ms(eager_ms)} (each frame both ways from the same state: "
        f"{MULTI_FRAMES - len(differ)}/{MULTI_FRAMES} torch.equal); (fast_nms, gather_patches, pose_optimization) launches "
        f"per graphed frame {per_frame}; peak memory allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log(f"  the batched front end: {mt.graphs.replays} replays, capture {captures_report(mt.graphs)}, graph "
        f"pool {mt.graphs.pool_bytes() / 2**20:.1f} MiB, static buffers "
        f"{mt.graphs.buffer_bytes() / 2**20:.1f} MiB; the last frame {io_report(io)}")
    if missed:
        bad.append(f"untracked (frame, stream): {missed}")
    if differ:
        bad.append(f"graphed differs from eager at frames {differ}")
    if len(io["reads"]["graphed"]) > len(io["reads"]["eager"]):
        bad.append(f"reads graphed {io['reads']['graphed']} against eager {io['reads']['eager']}")
    if any(f != 1 or g != 1 + MULTI_B or (i and p < 2 * MULTI_B) for i, (f, g, p) in enumerate(per_frame)):
        bad.append(f"launches per frame {per_frame}, want (1, {1 + MULTI_B}, at least {2 * MULTI_B} "
                   f"past the first)")
    if bad:
        raise AssertionError(f"MultiTracker: {bad}")
    return launches


def phase_stereo(scene: StepWallScene, smi: str) -> dict:
    """Stereo SLAM at KITTI00-02.yaml's operating point (phase_depth), one
    of its frames on the CPU against the card, then localization mode past
    the mapped region."""
    cam, cfg = KITTI_CAM, KITTI_ORB
    poses = orbit_trajectory(DEPTH_FRAMES + 3 + LOC_FRAMES, **STEREO_POSES)
    frames = render_stereo_frames(scene, cam, poses, device="cuda")
    system = System(cam, SensorType.STEREO, orb=cfg, device="cuda", **STEREO_TRACKER)

    def front(f):
        return steps.stereo_frame_features(f[0], f[1], cfg, cam.fx, cam.bf)

    out = phase_depth("stereo", system, frames, poses, smi, front, keep_job=MAP_GRAPH_DEPTH_JOB)
    L, R = frames[DEPTH_FRAMES // 2]
    g = front((L, R))
    t0 = time.perf_counter()
    c = steps.stereo_frame_features(L.cpu(), R.cpu(), cfg, cam.fx, cam.bf)
    cpu_s = time.perf_counter() - t0
    same_kp = torch.equal(g.xy.cpu(), c.xy) and torch.equal(g.valid.cpu(), c.valid)
    gv, cv = g.u_right.cpu() >= 0, c.u_right >= 0
    agree = float((gv == cv)[c.valid].float().mean())
    both = gv & cv
    du = float((g.u_right.cpu() - c.u_right)[both].abs().max()) if bool(both.any()) else float("inf")
    log(f"  stereo_frame_features of frame {DEPTH_FRAMES // 2} on the CPU ({cpu_s:.1f} s) against the "
        f"card: keypoints {'equal' if same_kp else 'DIFFERENT'}, stereo verdict equal on {agree:.4f} of "
        f"{int(c.valid.sum())} keypoints, {int(both.sum())} matched on both, max |u_right| diff {du:.2e} px")
    if not (same_kp and agree >= 0.995 and du < 1e-3):
        raise AssertionError("stereo SLAM: stereo_frame_features differs on the card and the CPU")
    out["loc_launches"] = phase_localization("stereo", system, frames, poses, smi)
    return out


def phase_rgbd(smi: str) -> dict:
    """RGB-D SLAM at TUM1.yaml's operating point (phase_depth) over a
    StepWallScene at half the default wall depths, so part of every frame's
    keypoints lie below th_depth (40 x 40 / 517.3 = 3.09 m) and the
    close-point branches run; depth as uint16 at 5000 per metre."""
    cam, cfg = TUM_CAM, TUM_ORB
    scene = StepWallScene(np.random.default_rng(6), depths=RGBD_DEPTHS)
    poses = orbit_trajectory(DEPTH_FRAMES + 3, **RGBD_POSES)
    frames = render_rgbd_frames(scene, cam, poses, device="cuda")
    system = System(cam, SensorType.RGBD, orb=cfg, device="cuda", **RGBD_TRACKER)
    tr = system.tracker
    depth_dev = {}

    def front(f):
        key = id(f[1])
        if key not in depth_dev:  # the uint16 image crosses to the card once, outside the timing
            depth_dev[key] = system._input(f[1])
        return steps.rgbd_frame_features(f[0], depth_dev[key], cam, cfg, tr.cfg.depth_map_factor)

    f = front(frames[0])
    has = f.depth > 0
    close = has & (f.depth < tr._th_depth)
    log(f"RGB-D frame 0: {int(f.valid.sum())} keypoints, {int(has.sum())} with depth, {int(close.sum())} "
        f"closer than th_depth {tr._th_depth:.3f} m, {int((has & ~close).sum())} farther")
    if not (int(close.sum()) > 50 and int((has & ~close).sum()) > 50):
        raise AssertionError("RGB-D SLAM: the scene does not put keypoints on both sides of th_depth")
    return phase_depth("rgbd", system, frames, poses, smi, front, keep_job=MAP_GRAPH_DEPTH_JOB)


def _stage_device_ms(tr, m, ki) -> dict:
    """Each stage of one keyframe job (compaction when the map is at its
    trigger, mapping_front, both local-BA chunks, the normals) alone under
    the profiler, as the tracker runs it: {stage: (device ms, wall ms,
    kernel launches, its 8 largest device events)}."""
    out, res = {}, [m]
    stages = []
    if int(m.n_pt) >= int(0.95 * m.capacity_pt):
        stages.append(("map.compact", tr._compact))
    stages += [("map.front", lambda mm: tr._mapping_front(mm, ki)),
               ("map.local_ba1", lambda mm: tr._local_ba(mm, ki, iters=4)),
               ("map.local_ba2", lambda mm: tr._local_ba(mm, ki, iters=4)),
               ("map.normals", tr._normals)]
    for name, fn in stages:
        wall, n, dev_us, top = profile_call(lambda fn=fn: res.append(fn(res[-1])))
        out[name] = (dev_us / 1e3, wall, n, top)
    return out


def phase_mapping_graphs(smi: str, mono: dict, stereo: dict, rgbd: dict, device: str = "cuda") -> None:
    """Keyframe jobs (Tracker._mapping_compute) both ways from the same
    state (see the module docstring): the mono session's early, middle and
    late jobs, the late one again at the compaction trigger, a stereo and
    an RGB-D job, each on a tracker of its session's config with loop
    closing off (the loop stage is eager both ways)."""
    trackers = {
        "mono": System(CAM, orb=CFG, device=device, enable_loop_closing=False).tracker,
        "stereo": System(KITTI_CAM, SensorType.STEREO, orb=KITTI_ORB, device=device, **MULTI_TRACKER).tracker,
        "rgbd": System(TUM_CAM, SensorType.RGBD, orb=TUM_ORB, device=device, **RGBD_TRACKER).tracker,
    }
    trackers["stereo"]._depth_mode = trackers["rgbd"]._depth_mode = True
    late = MAP_GRAPH_MONO_JOBS[-1]
    # (name, sensor, numpy map, slot, profiled: host API calls, peak
    # memory and each stage alone under the profiler)
    cases = [(f"mono job {j}", "mono", *mono["map_jobs"][j], j == late) for j in MAP_GRAPH_MONO_JOBS]
    m_np, ki = mono["map_jobs"][late]
    cases.append((f"mono job {late} at the compaction trigger (its watermark at capacity)", "mono",
                  m_np._replace(n_pt=np.asarray(MAP["P"], dtype=np.int32)), ki, False))
    cases += [(f"{name} job {MAP_GRAPH_DEPTH_JOB}", name, *d["map_job"], name == "stereo")
              for name, d in (("stereo", stereo), ("rgbd", rgbd))]
    log(f"mapping graphs on {smi}: keyframe jobs graphed (tracker.map_graphs) against eager "
        f"(map_graphs.run = steps.call_segment), {MAP_GRAPH_REPS} runs each in turns from the same state; "
        f"wall ms with the stage syncs on (each stage's time its device's), loop closing off")
    bad = []
    for name, sensor, m_np, ki, profiled in cases:
        tr = trackers[sensor]
        g = tr.map_graphs
        m = map_to_torch(m_np, device)
        state = tracker_state(tr)

        def once(way, fn, stage_sync=False):
            tracker_restore(tr, state)
            tr.stage_sync = stage_sync  # each stage's time its device's
            with eager_segments(g) if way == "eager" else contextlib.nullcontext():
                return fn()

        def job():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = tr._mapping_compute(m, ki)
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t0) * 1e3

        n_cap = len(g.captured)
        (_, first_ms) = once("graphed", job, True)
        runs = {"eager": [], "graphed": []}
        for r in range(MAP_GRAPH_REPS):
            for way in (("eager", "graphed") if r % 2 == 0 else ("graphed", "eager")):
                smp = tr.metrics.timer.samples
                c0, n0 = g.copied_bytes, {k: len(smp.get(k, [])) for k in MAP_STAGES}
                out, ms = once(way, job, True)
                runs[way].append(dict(ms=ms, stages={k: smp[k][-1] * 1e3 for k in MAP_STAGES
                                                     if len(smp.get(k, [])) > n0[k]},
                                      copied=g.copied_bytes - c0, out=(tuple(out), tr._pending_pt_remap)))
        ref = runs["eager"][0]["out"]
        equal = all(tree_equal(x["out"], ref) for w in runs for x in runs[w])
        reads = {w: once(w, lambda: count_syncs(lambda: tr._mapping_compute(m, ki)))[1] for w in runs}
        stage_ms = {w: {k: statistics.median(x["stages"][k] for x in runs[w]) for k in runs[w][0]["stages"]}
                    for w in runs}
        log(f"  {name} (slot {ki}): graphed {'torch.equal to' if equal else 'DIFFERENT from'} eager on every "
            f"MapState field and the point remap; the first graphed run {first_ms:.1f} ms, its captures "
            f"{captures_report(g, n_cap)}")
        log(f"    wall ms eager {_ms([x['ms'] for x in runs['eager']])}, graphed "
            f"{_ms([x['ms'] for x in runs['graphed']])}; by stage (medians, eager / graphed): "
            + ", ".join(f"{k} {stage_ms['eager'][k]:.3f} / {stage_ms['graphed'].get(k, float('nan')):.3f}"
                        for k in stage_ms["eager"]))
        log(f"    device->host reads eager {len(reads['eager'])}, graphed {len(reads['graphed'])} (at "
            f"{reads['graphed']}); copied into the static buffers {runs['graphed'][-1]['copied'] / 2**20:.1f} "
            f"MiB a job")
        if not equal:
            bad.append(f"{name}: the graphed keyframe job differs from the eager one")
        if len(reads["graphed"]) > len(reads["eager"]):
            bad.append(f"{name}: {len(reads['graphed'])} reads graphed against {len(reads['eager'])} eager")
        if profiled:
            calls = {w: once(w, lambda: api_calls(lambda: tr._mapping_compute(m, ki))) for w in runs}
            peak = {w: once(w, lambda: peak_gib(lambda: tr._mapping_compute(m, ki)))[1] for w in runs}
            log(f"    host API calls eager {sum(calls['eager'].values())} {calls['eager']}, graphed "
                f"{sum(calls['graphed'].values())} {calls['graphed']}; peak memory allocated eager "
                f"{peak['eager']:.3f} GiB, graphed {peak['graphed']:.3f} GiB")
            dev = {w: once(w, lambda: _stage_device_ms(tr, m, ki)) for w in runs}
            log("    each stage alone under the profiler, device ms / wall ms / kernel launches, eager | "
                "graphed: " + ", ".join(f"{k} {dev['eager'][k][0]:.3f} / {dev['eager'][k][1]:.3f} / "
                                        f"{dev['eager'][k][2]} | {dev['graphed'][k][0]:.3f} / "
                                        f"{dev['graphed'][k][1]:.3f} / {dev['graphed'][k][2]}"
                                        for k in dev["eager"]))
            log("    graphed mapping_front's largest device events:")
            log_top(dev["graphed"]["map.front"][3])
        tracker_restore(tr, state)
    for sensor, tr in trackers.items():
        g = tr.map_graphs
        m = map_to_torch(next(c[2] for c in cases if c[1] == sensor), device)
        nbytes = sum(x.numel() * x.element_size() for x in m)
        groups = {}
        for x in m:
            d = torch.empty_like(x)
            a, b = groups.setdefault(x.dtype, ([], []))
            a.append(d)
            b.append(x)
        copy_ms, = cuda_ms_turns([lambda: [torch._foreach_copy_(a, b) for a, b in groups.values()]], ahead=True)
        log(f"  {sensor} tracker: {g.captures} mapping captures, {g.replays} replays; graph pool "
            f"{g.pool_bytes() / 2**20:.1f} MiB, static buffers {g.buffer_bytes() / 2**20:.1f} MiB; the whole "
            f"map ({nbytes / 2**20:.1f} MiB) copied once, one _foreach_copy_ per dtype: {copy_ms:.4f} ms of "
            f"device time ({nbytes / copy_ms / 1e6:.1f} GB/s), the rate at which a job's copy-in moves")
        if g.captures > MAP_GRAPH_KEYS:
            bad.append(f"{sensor}: {g.captures} mapping captures")
    if bad:
        raise AssertionError(f"mapping graphs: {bad}")


def phase_place(smi: str, device: str = "cuda") -> dict:
    """Place recognition with both shipped vocabularies on the card (see
    the module docstring). Returns each tree's results and times."""
    z = np.load(PLACE_EVAL_PATH)
    pool = np.ascontiguousarray(z["view_a"][z["count_a"] >= 300].reshape(-1, 8)).view(np.int32)
    descs = {n: torch.from_numpy(pool[:n].copy()).to(device) for n in (1000, 2000)}
    ones = {n: torch.ones(n, dtype=torch.bool, device=device) for n in descs}
    out = {}
    for name, path in (("100k", DEFAULT_VOCAB_PATH), ("1M", DEFAULT_VOCAB_1M_PATH)):
        t0 = time.perf_counter()
        voc = Vocabulary.load(path, device=device)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = evaluate(voc, PLACE_EVAL_PATH)
        eval_s = time.perf_counter() - t0
        bow_ms = dict(zip(descs, cuda_ms_turns([lambda n=n: sparse_bow_vector(voc, descs[n], ones[n])
                                                for n in descs])))
        # A query against 1,536 enrolled slots of 2,000 words (64 distinct
        # keyframes' vectors, tiled), no covisibility, as relocalization asks.
        K, L = MAP["K"], MAP["N_cap"]
        db = SparseKeyFrameDatabase(voc.n_words, K, L, device=device)
        rows = []
        for k in range(64):
            d = torch.from_numpy(pool[(k * 997) % (len(pool) - L):][:L].copy()).to(device)
            rows.append(sparse_bow_vector(voc, d, ones[L]))
        for k in range(K):
            db.add(k, rows[k % 64])
        q = sparse_bow_vector(voc, torch.from_numpy(pool[-L:].copy()).to(device), ones[L])
        excl = torch.zeros(K, dtype=torch.bool, device=device)
        covis = torch.zeros((K, K), device=device)
        q_ms = cuda_ms(lambda: db.query(q, excl, covis, min_score=0.0, max_candidates=6))
        log(f"place recognition, {name} tree (k={voc.k}, L={voc.levels}, {voc.n_words} words) on {smi}: "
            f"{res['n_places']} places, recall@1 {res['recall_at_1']:.4f}, recall@5 {res['recall_at_5']:.4f}, "
            f"mean margin {res['mean_margin']:.4f} (load {load_s:.1f} s, evaluation {eval_s:.1f} s); "
            f"sparse_bow_vector {bow_ms[1000]:.3f} ms at 1,000 descriptors, {bow_ms[2000]:.3f} ms at "
            f"2,000; a query at {K} enrolled slots of {L} words {q_ms:.3f} ms (CUDA-event medians of {REPS})")
        out[name] = dict(res, bow_ms=bow_ms, query_ms=q_ms)
    r = out["100k"]
    if not (r["recall_at_1"] >= PLACE_R1 and r["recall_at_5"] >= PLACE_R5 and r["mean_margin"] > 0.0):
        raise AssertionError(f"place recognition: the 100k tree misses its gates: {r}")
    return out


def rotation_deg(Ra: np.ndarray, Rb: np.ndarray) -> np.ndarray:
    """The angle between rotations (..., 3, 3) in degrees, from the chord
    |Ra - Rb|_F = 2 sqrt(2) sin(theta / 2): exact for small angles, where
    arccos of the trace loses them to the rotations' float32 rounding."""
    chord = np.linalg.norm(Ra - Rb, axis=(-2, -1)) / (2.0 * np.sqrt(2.0))
    return np.rad2deg(2.0 * np.arcsin(np.clip(chord, 0.0, 1.0)))


def _kf_centres(m, n: int) -> np.ndarray:
    R = m.kf_R[:n].cpu().numpy().astype(np.float64)
    t = m.kf_t[:n].cpu().numpy().astype(np.float64)
    return -np.einsum("kji,kj->ki", R, t)


def phase_loop(smi: str, device: str = "cuda") -> dict:
    """Loop closing on the drifted loop map at the default capacities (see
    the module docstring)."""
    K, N, P = MAP["K"], MAP["N_cap"], MAP["P"]
    t0 = time.perf_counter()
    m, gt, drifted = build_loop_map(np.random.default_rng(0), n_kf=LOOP_KF, drift=LOOP_DRIFT, max_kf=K,
                                    n_kp=N, max_pt=P, device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg = TrackerConfig(cam=LOOP_CAM, max_keyframes=K, max_points=P, enable_loop_closing=False)
    ba = Tracker(cfg, device=device)  # its global BA serves the closure
    gba_inputs = []
    gba = ba._schedule_gba

    def keep_gba(mm, iters=10):
        if not gba_inputs:
            gba_inputs.append(mm)
        return gba(mm, iters=iters)

    ba._schedule_gba = keep_gba
    voc = Vocabulary.load(DEFAULT_VOCAB_PATH, device=device)
    lc = LoopCloser(K, fix_scale=False, voc=voc)
    lc.stage_sync = True
    graphs = []
    solve = loop_closing.optimize_pose_graph

    def keep_graph(*a, **kw):
        graphs.append((a, kw))
        return solve(*a, **kw)

    loop_closing.optimize_pose_graph = keep_graph
    ms, reads, closed, had_cand, snaps, after = [], [], [], [], {}, {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        for k in range(LOOP_KF):
            if k >= LOOP_KF - 3:
                snaps[k] = (m, lc.to("cpu"))  # the state just before it
            n_sim3 = len(lc.metrics.timer.samples["loop.sim3"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (m, c), sites = count_syncs(lambda: lc.on_keyframe(m, LOOP_CAM, k, ba_fn=ba._schedule_gba))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            reads.append(len(sites))
            had_cand.append(len(lc.metrics.timer.samples["loop.sim3"]) > n_sim3)
            if c:
                closed.append(k)
                after[k] = m
    finally:
        loop_closing.optimize_pose_graph = solve
    peak = torch.cuda.max_memory_allocated() / 2**30
    C = _kf_centres(m, LOOP_KF)
    C_gt = np.stack([-R.T @ t for R, t in gt]).astype(np.float64)
    C_dr = np.stack([-R.T @ t for R, t in drifted]).astype(np.float64)
    err_before = float(np.linalg.norm(C_dr[-1] - C_gt[-1]))
    err_after = float(np.linalg.norm(C[-1] - C_gt[-1]))
    plain = [ms[k] for k in range(10, LOOP_KF) if not had_cand[k]]
    plain_reads = [reads[k] for k in range(10, LOOP_KF) if not had_cand[k]]
    st = lc.metrics.timer.samples
    pg = lc.pose_graph_stats
    log(f"loop closing on {smi}: build_loop_map at K={K}, {N} slots, P={P}, {LOOP_KF} keyframes "
        f"({build_s:.1f} s), drift {LOOP_DRIFT:.5f} rad and m per keyframe; loops closed at keyframes "
        f"{closed}; loop-end camera-centre error {err_before:.4f} m before, {err_after:.4f} m after; "
        f"peak memory allocated {peak:.3f} GiB")
    log(f"  ms per keyframe without a candidate (keyframes 10 on): {_ms(plain)}; device->host reads "
        f"per such keyframe median {statistics.median(plain_reads)}, max {max(plain_reads)}; "
        f"keyframes with a candidate {[k for k in range(LOOP_KF) if had_cand[k]]}")
    bad = []
    if not closed:
        bad.append("no loop closed")
    elif not err_after < 0.5 * err_before:
        bad.append(f"loop-end error {err_after:.4f} not below half of {err_before:.4f}")
    if closed:
        kc = closed[0]
        cg = [int(x) for x in pg.get("cg_iters", [])]
        log(f"  the closing keyframe {kc}: {ms[kc]:.3f} ms, {reads[kc]} device->host reads; detection "
            f"{st['loop.detect'][-1] * 1e3:.3f} ms, _compute_sim3 {st['loop.sim3'][-1] * 1e3:.3f} ms, "
            f"fusion {st['loop.fuse'][-1] * 1e3:.3f} ms, essential graph {st['loop.essential_graph'][-1] * 1e3:.3f} ms "
            f"({pg['n_live']} live keyframes, {pg['n_edges']} edges, 15 GN iterations, CG iterations per GN "
            f"{cg}, {pg.get('reads', 0)} CG reads), global BA {st['loop.global_ba'][-1] * 1e3:.3f} ms")
        pgg = pg.get("graph", {})
        log(f"  its GN steps and CG blocks through the closer's StepGraphs (blocks of "
            f"{pose_graph.CG_CHECK_EVERY} CG iterations): {pgg.get('captures', 0)} captures "
            f"({captures_report(lc.graphs)}), {pgg.get('replays', 0)} replays, graph pool "
            f"{pgg.get('pool_bytes', 0) / 2**20:.1f} MiB, static buffers {lc.graphs.buffer_bytes() / 2**20:.1f} "
            f"MiB; its global BA through the tracker's map_graphs: {captures_report(ba.map_graphs)}, "
            f"gba_iters {ba.stats['gba_iters']}, gba_graph_replays {ba.stats['gba_graph_replays']}, pool "
            f"{ba.map_graphs.pool_bytes() / 2**20:.1f} MiB, static buffers "
            f"{ba.map_graphs.buffer_bytes() / 2**20:.1f} MiB")
        if ba.stats["gba_graph_replays"] != ba.stats["gba_iters"]:
            bad.append(f"the closure's global BA replayed {ba.stats['gba_graph_replays']} of "
                       f"{ba.stats['gba_iters']} LM iterations")
        # One GN step replayed (the closure captured it) under the
        # profiler; host API calls and device time of one GN step and one
        # LM iteration both ways: a solve at 2 GN steps less one at 1, the
        # global BA at 2 LM iterations less 1 (the set-up cancels).
        a, kw = graphs[-1]
        wall, n_launch, dev_us, top = profile_call(lambda: solve(*a, **dict(kw, iters=1, run=lc.graphs.run)))
        log(f"  one GN step of the essential graph replayed under the profiler (the closure ran "
            f"{kw['iters']}): {n_launch} kernel launches, device time {dev_us / 1e3:.3f} ms of "
            f"{wall:.3f} ms wall; most device time:")
        log_top(top)
        eager_graphs = StepGraphs(device)
        eager_graphs.run = steps.call_segment
        gn = {w: per_iteration(lambda k, r=r: solve(*a, **dict(kw, iters=k, run=r)))
              for w, r in (("eager", steps.call_segment), ("graphed", lc.graphs.run))}
        m_gba = gba_inputs[0]
        lm = {w: per_iteration(lambda k, g=g: ba._global_ba(m_gba, iters=k, graphs=g))
              for w, g in (("eager", eager_graphs), ("graphed", ba.map_graphs))}
        peak = {w: peak_gib(lambda g=g: ba._global_ba(m_gba, iters=10, graphs=g))[1]
                for w, g in (("eager", eager_graphs), ("graphed", ba.map_graphs))}
        n_gn, n_lm = ({w: d[w]["n"] for w in d} for d in (gn, lm))
        log(f"  one GN step: host API calls eager {n_gn['eager']} {gn['eager']['calls']}, graphed "
            f"{n_gn['graphed']} {gn['graphed']['calls']}; device time eager {gn['eager']['device_ms']:.3f} ms, "
            f"graphed {gn['graphed']['device_ms']:.3f} ms")
        log(f"  one LM iteration of the closure's global BA: host API calls eager {n_lm['eager']} "
            f"{lm['eager']['calls']}, graphed {n_lm['graphed']} {lm['graphed']['calls']}; device time eager "
            f"{lm['eager']['device_ms']:.3f} ms, graphed {lm['graphed']['device_ms']:.3f} ms; the closure's "
            f"global BA (10 iterations) peak memory eager {peak['eager']:.3f} GiB, graphed {peak['graphed']:.3f} GiB")
        if not (n_gn["graphed"] < 300 and n_lm["graphed"] < 50):
            bad.append(f"host API calls per graphed GN step {n_gn['graphed']}, per LM iteration {n_lm['graphed']}")
        if kc not in snaps:
            bad.append(f"closed at keyframe {kc}, before the revisit")
        else:
            m_snap, lc_cpu = snaps[kc]
            # The same keyframe again on the card from the same state, warm
            # (the first closure paid the solvers' first calls), graphed
            # and eager in turns: the essential graph through one
            # StepGraphs (the first graphed run's copy of the closer
            # captures into a fresh one; the second's copy is handed it and
            # must only replay), the global BA through ba.map_graphs.
            warm, lc_graphs = {}, None
            for way in ("graphed", "eager", "eager", "graphed"):
                lc_warm = lc_cpu.to(device)
                lc_warm.stage_sync = True
                if way == "eager":
                    lc_warm.cg_run = steps.call_segment
                elif lc_graphs is not None:
                    lc_warm.graphs = lc_graphs
                caps = (lc_graphs.captures if lc_graphs is not None else 0, ba.map_graphs.captures)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with eager_segments(ba.map_graphs) if way == "eager" else contextlib.nullcontext():
                    (m_w, c_w), sites = count_syncs(lambda: lc_warm.on_keyframe(m_snap, LOOP_CAM, kc,
                                                                                ba_fn=ba._schedule_gba))
                torch.cuda.synchronize()
                if way == "graphed":
                    lc_graphs = lc_warm.graphs
                warm.setdefault(way, []).append(dict(
                    ms=(time.perf_counter() - t0) * 1e3, closed=c_w, map=m_w, remap=lc_warm.last_point_remap,
                    reads=len(sites), samples=lc_warm.metrics.timer.samples, stats=lc_warm.pose_graph_stats,
                    captures=(lc_graphs.captures - caps[0] if way == "graphed" else 0,
                              ba.map_graphs.captures - caps[1])))
            for way, runs in warm.items():
                w, sw = runs[-1], runs[-1]["samples"]
                log(f"  the closing keyframe {kc} again on the card from the same state (warm), {way}: "
                    f"{_ms([r['ms'] for r in runs])}, {w['reads']} device->host reads "
                    f"({w['stats'].get('reads', 0)} of them the CG's), closed {w['closed']}, new captures "
                    f"{[r['captures'] for r in runs]} (essential graph, global BA); detection "
                    f"{sw['loop.detect'][-1] * 1e3:.3f} ms, _compute_sim3 {sw['loop.sim3'][-1] * 1e3:.3f} ms, "
                    f"fusion {sw['loop.fuse'][-1] * 1e3:.3f} ms, essential graph "
                    f"{_ms([r['samples']['loop.essential_graph'][-1] * 1e3 for r in runs])}, global BA "
                    f"{_ms([r['samples']['loop.global_ba'][-1] * 1e3 for r in runs])}")
            runs = warm["graphed"] + warm["eager"]
            equal = all(tree_equal(tuple(r["map"]), tuple(runs[0]["map"])) and tree_equal(r["remap"], runs[0]["remap"])
                        for r in runs)
            log(f"  every MapState field and the point remap, graphed against eager: "
                f"{'torch.equal' if equal else 'DIFFERENT'}; the second graphed closure on the first's "
                f"graphs: new captures {warm['graphed'][1]['captures']}; the closer's graph pool "
                f"{lc_graphs.pool_bytes() / 2**20:.1f} MiB, static buffers {lc_graphs.buffer_bytes() / 2**20:.1f} MiB")
            if not equal or not all(r["closed"] for r in runs):
                bad.append("the closing keyframe: the graphed closure differs from the eager one")
            if len({r["reads"] for r in warm["graphed"][1:] + warm["eager"]}) != 1:
                bad.append(f"the closing keyframe's reads differ: {[r['reads'] for r in runs]}")
            if warm["graphed"][1]["captures"] != (0, 0):
                bad.append(f"the second closure captured again: {warm['graphed'][1]['captures']}")
            cpu = Tracker(cfg, device="cpu")
            t0 = time.perf_counter()
            m_cpu, c_cpu = lc_cpu.on_keyframe(map_to_torch(map_to_numpy(m_snap), "cpu"), LOOP_CAM, kc,
                                              ba_fn=cpu._schedule_gba)
            cpu_s = time.perf_counter() - t0
            valid = after[kc].kf_valid[:LOOP_KF].cpu().numpy()
            dC = np.linalg.norm(_kf_centres(after[kc], LOOP_KF) - _kf_centres(m_cpu, LOOP_KF), axis=1)[valid]
            Rg = after[kc].kf_R[:LOOP_KF].cpu().numpy().astype(np.float64)
            Rc = m_cpu.kf_R[:LOOP_KF].numpy().astype(np.float64)
            dA = rotation_deg(Rg, Rc)[valid]
            same = c_cpu and lc_cpu._loop_edges[-1:] == lc._loop_edges[:1]
            log(f"  keyframe {kc} rerun on the CPU from the card's state ({cpu_s:.1f} s): closed "
                f"{c_cpu}, loop edge {lc_cpu._loop_edges[-1:]} against the card's {lc._loop_edges[:1]}; "
                f"corrected poses: max centre difference {dC.max():.2e} m, max rotation difference "
                f"{dA.max():.2e} deg")
            if not (same and dC.max() < LOOP_T_TOL and dA.max() < LOOP_R_TOL):
                bad.append("the closing keyframe differs on the card and the CPU")

    # Without revisit or drift: no loop.
    m0, gt0, _ = build_loop_map(np.random.default_rng(1), n_kf=LOOP_NO_REVISIT_KF, drift=0.0, revisit=False,
                                max_kf=K, n_kp=N, max_pt=P, device=device)
    lc0 = LoopCloser(K, fix_scale=False, voc=voc)
    t0 = time.perf_counter()
    closed0 = []
    for k in range(LOOP_NO_REVISIT_KF):
        m0, c = lc0.on_keyframe(m0, LOOP_CAM, k, ba_fn=ba._schedule_gba)
        if c:
            closed0.append(k)
    log(f"  without revisit or drift ({LOOP_NO_REVISIT_KF} keyframes, {time.perf_counter() - t0:.1f} s): "
        f"loops closed at {closed0}")
    if closed0:
        bad.append(f"a loop closed without revisit at keyframes {closed0}")
    if bad:
        raise AssertionError(f"loop closing: {bad}")
    return dict(closed=closed, ms=ms)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _wall_ms(fn, dev: torch.device, reps: int = 5):
    """(fn()'s last result, the median wall ms of `reps` calls, the device
    synchronized around each)."""
    ms = []
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, statistics.median(ms)


def phase_facade(smi: str, scene: StepWallScene, mono: dict, work: str, device: str = "cuda") -> dict:
    """The facade and glue on the card (see the module docstring): map
    once (phase_mono saved the map), localize later over frames of the mono
    path rendered from `scene` again; the RGB-D TUM driver from PNGs on
    disk with a live viewer; the map's renderers, plane detection and
    rectification against the CPU; one frame under torch_trace. Its files
    go to `work`. Returns the kernels' launches of the localized frames and
    the driver's frames."""
    from tpuslam_torch.examples import rgbd_tum
    from tpuslam_torch.io.checkpoint import load_map
    from tpuslam_torch.io.datasets import load_grayscale
    from tpuslam_torch.io.rectify import init_rectify_map, remap_bilinear
    from tpuslam_torch.io.settings import Settings
    from tpuslam_torch.sfm.initializer import draw_picks
    from tpuslam_torch.testing import write_tum_rgbd
    from tpuslam_torch.utils.metrics import torch_trace
    from tpuslam_torch.viz.ar import detect_plane
    from tpuslam_torch.viz.render import topdown_layout
    from tpuslam_torch.viz.server import LiveViewer

    path, poses, (s, Ra, ta) = mono["path"], mono["poses"], mono["align"]
    dev = torch.device(device)
    frames = dict(zip(range(FACADE_LOC[0], FACADE_LOC[-1] + 2),
                      render_frames(scene, CAM, poses[FACADE_LOC[0]:FACADE_LOC[-1] + 2], device=dev)))
    bad = []

    def centre_err(R, t, i) -> float:
        Rg, tg = poses[i]
        return float(np.linalg.norm(s * (-R.T @ t) @ Ra.T + ta - (-np.asarray(Rg).T @ np.asarray(tg))))

    # Map once (phase_mono saved the session's map): load it into a fresh System.
    loc = System(CAM, orb=CFG, device=dev)  # the default TrackerConfig: loop closing on
    t0 = time.perf_counter()
    loc.load_map(path)
    _sync(dev)
    load_ms = (time.perf_counter() - t0) * 1e3
    tr = loc.tracker
    m0 = tr.map
    n_kf0, pt_valid0 = int(m0.n_kf), m0.pt_valid.clone()
    t0 = time.perf_counter()
    m_cpu = load_map(path, device="cpu")
    cpu_load_ms = (time.perf_counter() - t0) * 1e3
    same_file = all(a.tobytes() == b.tobytes() for a, b in zip(map_to_numpy(m0), map_to_numpy(m_cpu)))
    log(f"facade on {smi}: save_map of the mono map (K={m0.capacity_kf}, {m0.kf_obs_pt.shape[1]} keypoint "
        f"slots, P={m0.capacity_pt}; {n_kf0} keyframes inserted, {int(pt_valid0.sum())} valid points) "
        f"{mono['save_ms']:.1f} ms, {os.path.getsize(path) / 2**20:.2f} MB; load_map into a fresh System on the "
        f"card {load_ms:.1f} ms, on the CPU {cpu_load_ms:.1f} ms, card and CPU maps "
        f"{'bit-equal' if same_file else 'DIFFERENT'}")
    if not same_file:
        bad.append("the map loaded on the CPU differs from the card's")

    # Localize later: frames of the mono path against the loaded map.
    zero_launches()
    outs, ms = [], []
    for i in FACADE_LOC:
        _sync(dev)
        t0 = time.perf_counter()
        outs.append(loc.track_monocular(frames[i], i / 30.0))
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        if i == FACADE_LOC[0]:
            reloc = (tr.reloc_path, tr.metrics.timer.samples["track.relocalize"][-1] * 1e3)
    loc_launches = launch_counts()
    first = FACADE_LOC[0]
    err0 = centre_err(*outs[0], first) if outs[0] is not None else float("inf")
    own = dict((fid, (R, t)) for fid, R, t, lost in mono["traj"] if not lost)
    vs_own = (s * float(np.linalg.norm(-outs[0][0].T @ outs[0][1] + own[first][0].T @ own[first][1]))
              if outs[0] is not None and first in own else float("nan"))
    n_ok = sum(o is not None for o in outs)
    errs = [centre_err(*o, i) for o, i in zip(outs, FACADE_LOC) if o is not None]
    log(f"  localized {n_ok}/{len(outs)} frames ({n_ok / len(outs):.0%}) of the mono path "
        f"{first}-{FACADE_LOC[-1]}: the first relocalized in {reloc[1]:.3f} ms by the {reloc[0]} branch "
        f"(a fresh System's loop closer has no database), {err0:.4f} m from the truth (the session's "
        f"Sim3 alignment), {vs_own:.4f} m from the session's own estimate of that frame; then "
        f"{_ms(ms[1:])} per localized frame; centre error median "
        f"{statistics.median(errs) if errs else float('nan'):.4f} m; launches {loc_launches}")
    if not err0 < FACADE_RELOC_TOL:
        bad.append(f"relocalized {err0:.4f} m from the truth")
    if n_ok < FACADE_LOC_TRACKED * len(outs):
        bad.append(f"localized {n_ok}/{len(outs)}")
    if int(tr.map.n_kf) != n_kf0 or not torch.equal(tr.map.pt_valid, pt_valid0):
        bad.append("localization changed the loaded map")
    if min(loc_launches.values()) < len(outs):
        bad.append(f"kernel launches {loc_launches} over {len(outs)} localized frames")
    bad += graph_report("localized against the loaded map", tr)

    # One more localized frame under torch_trace.
    with torch_trace(f"{work}/trace") as prof:
        loc.track_monocular(frames[FACADE_LOC[-1] + 1], 99.0)
        _sync(dev)
    n_trace = sum(e.count for e in prof.key_averages()
                  if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    log(f"  one localized frame under torch_trace: {n_trace} kernel launches, trace "
        f"{os.path.basename(prof.trace_path)} {os.path.getsize(prof.trace_path) / 2**20:.2f} MB")
    if not os.path.getsize(prof.trace_path) or (dev.type == "cuda" and n_trace == 0):
        bad.append("torch_trace wrote no trace or saw no launch")

    # Plane detection and the top-down layout on the loaded map, card and CPU.
    R_c, t_c = outs[-1] if outs[-1] is not None else own[first]
    centre = -R_c.T @ t_c
    picks = draw_picks(50, 3, m_cpu.pt_valid, torch.Generator().manual_seed(0))
    fits = {}
    for name, m in (("card", tr.map), ("CPU", m_cpu)):
        fits[name], fit_ms = _wall_ms(lambda m=m: detect_plane(m.pt_xyz, m.pt_valid, centre, picks=picks),
                                      m.pt_xyz.device, reps=5 if m is tr.map else 1)
        log(f"  detect_plane on the {name} ({m.capacity_pt} point slots, 50 hypotheses): {fit_ms:.3f} ms")
    g, c = ([x.cpu() for x in fits[k]] for k in ("card", "CPU"))
    ang = float(np.degrees(np.arccos(np.clip(float(g[1] @ c[1]), -1.0, 1.0))))
    log(f"  plane: success {bool(c[0])}, {int(c[3].sum())} inliers on the CPU, {int(g[3].sum())} on the card; "
        f"normals {ang:.4f} deg apart")
    if not (ang < PLANE_TOL_DEG and torch.equal(g[3], c[3]) and bool(g[0]) == bool(c[0])):
        bad.append(f"detect_plane differs on the card and the CPU ({ang:.4f} deg)")
    traj = [(fid, R, t) for fid, R, t, lost in tr.export_trajectory() if not lost]
    lays = {}
    for name, m in (("card", tr.map), ("CPU", m_cpu)):
        lays[name], lay_ms = _wall_ms(lambda m=m: topdown_layout(m, traj), m.pt_xyz.device,
                                      reps=5 if m is tr.map else 1)
        log(f"  topdown_layout on the {name}: {lay_ms:.3f} ms ({len(lays[name].edges)} covisibility edges)")
    g, c = ([x.cpu() for x in lays[k]] for k in ("card", "CPU"))
    d_px = max((float((a - b).abs().max()) for a, b in zip(g[:3], c[:3]) if len(a)), default=0.0)
    log(f"  layout card vs CPU: edges {'equal' if torch.equal(g[3], c[3]) else 'DIFFERENT'}, "
        f"max pixel difference {d_px:.2e}")
    if not (torch.equal(g[3], c[3]) and d_px < LAYOUT_TOL):
        bad.append(f"topdown_layout differs on the card and the CPU ({d_px:.2e} px)")

    # EuRoC rectification of a 752x480 pair, card against CPU.
    gen = np.random.default_rng(8)
    pair = [torch.from_numpy(gen.uniform(0, 255, (480, 752)).astype(np.float32)) for _ in range(2)]
    maps = [[torch.from_numpy(a) for a in init_rectify_map(b["K"], b["D"], b["R"], b["P"], 752, 480)]
            for b in EUROC_RECT]
    rect = [remap_bilinear(img, *mp) for img, mp in zip(pair, maps)]
    dev_maps = [[a.to(dev) for a in mp] for mp in maps]
    dev_pair = [img.to(dev) for img in pair]
    rect_dev, remap_ms = _wall_ms(lambda: [remap_bilinear(img, *mp) for img, mp in zip(dev_pair, dev_maps)],
                                  dev, reps=REPS)
    d_rect = max(float((a.cpu() - b).abs().max()) for a, b in zip(rect_dev, rect))
    log(f"  remap_bilinear of a 752x480 EuRoC pair on the card: {remap_ms:.3f} ms a pair; card vs CPU "
        f"max difference {d_rect:.2e}")
    if not d_rect < REMAP_TOL:
        bad.append(f"remap_bilinear differs on the card and the CPU ({d_rect:.2e})")

    # The RGB-D TUM driver from PNGs on disk, a live viewer attached.
    scene = StepWallScene(np.random.default_rng(6), depths=RGBD_DEPTHS)
    tum_poses = orbit_trajectory(FACADE_TUM_FRAMES, **RGBD_POSES)
    tum = render_rgbd_frames(scene, TUM_CAM, tum_poses, device=dev)
    t0 = time.perf_counter()
    root = f"{work}/tum"
    assoc = write_tum_rgbd(root, tum)
    write_s = time.perf_counter() - t0
    first_rgb = open(assoc).readline().split()[1]
    g0 = load_grayscale(f"{root}/{first_rgb}")
    written = np.clip(np.round(tum[0][0].cpu().numpy()), 0, 255)
    settings = Settings(cam=TUM_CAM, orb=TUM_ORB, fps=30.0, th_depth_factor=40.0, depth_map_factor=1.0 / 5000.0)
    viewer = LiveViewer(port=0)
    update_ms = []
    update = viewer.update

    def timed_update(*a, **k):
        _sync(dev)
        t1 = time.perf_counter()
        update(*a, **k)
        update_ms.append((time.perf_counter() - t1) * 1e3)

    viewer.update = timed_update
    zero_launches()
    try:
        res = rgbd_tum.run(settings, root, assoc, f"{work}/CameraTrajectory.txt", device=dev, viewer=viewer,
                           viewer_every=FACADE_VIEWER_EVERY)
        drv_launches = launch_counts()
        state = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{viewer.port}/state", timeout=10).read())
        n_updates = len(update_ms)
        _, push_sites = count_syncs(res.system._push_viewer)  # 40 frames: a push is due
    finally:
        viewer.close()
    fails, summary = depth_gates("facade driver", res.system.tracker.export_trajectory(), tum_poses,
                                 FACADE_TUM_FRAMES)
    bad += fails + graph_report("the rgbd_tum driver", res.system.tracker)
    log(f"  TUM RGB-D folder of {FACADE_TUM_FRAMES} frames (8-bit RGB and 16-bit depth PNGs, no PIL) written "
        f"in {write_s:.1f} s; rgbd_tum.run on it: decode {_ms(res.decode_ms)} per frame (host), track "
        f"{_ms(res.track_ms)} per frame; {summary}; the first frame decoded "
        f"{'equal to' if np.array_equal(g0, written) else 'DIFFERENT from'} the array written")
    log(f"  live viewer every {FACADE_VIEWER_EVERY} frames: {n_updates} updates, {_ms(update_ms[:n_updates])} each; "
        f"one push {len(push_sites)} device->host reads, at {push_sites}; /state over loopback: "
        f"{len(state['points'])} points, {len(state['kfs'])} keyframes, status '{state['status']}'; "
        f"launches {drv_launches}")
    if not np.array_equal(g0, written):
        bad.append("the decoded first frame differs from the array written")
    if not (state["points"] and state["kfs"]):
        bad.append("/state holds no points or keyframes")
    if min(drv_launches.values()) < FACADE_TUM_FRAMES:
        bad.append(f"kernel launches {drv_launches} over {FACADE_TUM_FRAMES} driver frames")
    if bad:
        raise AssertionError(f"facade: {bad}")
    return {k: loc_launches[k] + drv_launches[k] for k in loc_launches}


def _per_kind(rec: list, res: list) -> tuple:
    kinds = frame_kinds(rec)
    ms = [m for _, m in res]
    return kinds, {k: [ms[i] for i, x in enumerate(kinds) if x["kind"] == k]
                   for k in ("motion model", "reference keyframe", "keyframe")}


def phase_async_mono(scene: StepWallScene, smi: str, sync: dict) -> dict:
    """Phase 6's mono session with async_mapping, fed at ASYNC_FPS: the mono
    gates, the frames begun while a mapping job ran and the keyframes it
    made NeedNewKeyFrame decline, then ms
    per frame by kind and the session's wall beside the synchronous
    session's (`sync`, phase 6 of this run), the mapping job's ms on its
    thread, the keyframe insertions that waited on a join, InterruptBA,
    reads per thread, peak memory. Returns the kernels' launches."""
    poses = orbit_trajectory(MONO_FRAMES, **MAP_POSES)
    frames = render_frames(scene, CAM, poses, device="cuda")
    system = System(CAM, orb=CFG, device="cuda", async_mapping=True)
    tr = system.tracker
    tr.stage_sync = True  # the job's stage timers hold its stream's device time
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec, marks = [], []
    record = session_recorder(tr, rec)
    map_recs = watch_map_jobs(tr)
    init_gba = keep_first_global_ba(tr)
    zero_launches()
    busy = [False]  # whether a mapping job was in flight when each frame began
    declined = []  # whether NeedNewKeyFrame wanted a keyframe there but the job in flight stopped it
    with sync_sites() as sites:
        def on_frame(i, out):
            record(i, out)
            marks.append(len(sites))
            d = {k: rec[-1]["counters"].get(k, 0) - (rec[-2]["counters"].get(k, 0) if i else 0)
                 for k in ("map.interrupts", "frames.keyframe")}
            declined.append(bool(d["map.interrupts"]) and not d["frames.keyframe"])
            # The camera's rate, as ORB-SLAM2's examples feed a dataset: sleep
            # out the rest of the frame interval.
            spent = time.perf_counter() - begun[0]
            if spent < 1 / ASYNC_FPS:
                time.sleep(1 / ASYNC_FPS - spent)
            busy.append(tr._mapping_future is not None and not tr._mapping_future.done())
            begun[0] = time.perf_counter()

        begun = [time.perf_counter()]

        t0 = time.perf_counter()
        res = mono_session(system, frames, on_frame=on_frame)
        wall = time.perf_counter() - t0
        traj = tr.export_trajectory()  # adopts the job in flight
    launches = dict(rec[-1]["launches"])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    kinds, by_kind = _per_kind(rec, res)
    # Reads of the tracking thread per frame, less the harness's two stream
    # syncs; the mapping thread's per job.
    per_frame = [sum(1 for x in sites[a:b] if ": " not in x.split(" < ")[0] and "testing.py" not in x)
                 for a, b in zip([0] + marks[:-1], marks)]
    mapping = [x for x in sites if x.startswith("local-mapping")]
    st, c = tr.metrics.timer.samples, tr.metrics.counters
    jobs = [v * 1e3 for v in st.get("map.job", [])]
    ok_at = [i for i, x in enumerate(kinds) if x["state"] == "OK"]
    init = ok_at[0] if ok_at else None
    m = tr.map
    n_kf = int(m.kf_valid.sum())
    mapped = int(((m.pt_first_kf >= 2) & m.pt_valid).sum())
    ate, n_tracked, _ = trajectory_ate(traj, poses)
    C = np.stack([-np.asarray(R).T @ np.asarray(t) for R, t in poses])
    span = float(np.linalg.norm(C[-1] - C[0]))
    after = MONO_FRAMES - 1 - init if init is not None else 0
    tracked_after = sum(1 for fid, _, _, lost in traj if not lost and init is not None and fid > init)
    log(f"async mono SLAM on {smi}: {MONO_FRAMES} frames in {wall:.1f} s (the synchronous session of "
        f"phase 6: {sync['wall']:.1f} s), initialized at frame {init}, end state {tr.state.name}; {n_kf} valid "
        f"keyframes ({tr._n_kf_host} inserted, {len(jobs)} mapping jobs), {int(m.pt_valid.sum())} valid points "
        f"({mapped} made by mapping_front); tracked {tracked_after}/{after} after initialization; ATE "
        f"{ate:.4f} m over a {span:.3f} m path ({ate / span:.2%}); peak memory allocated {peak:.3f} GiB")
    log(f"  launches in the session: {launches}; frames by kind: "
        f"{ {k: len(v) for k, v in by_kind.items()} }")
    for k, v in by_kind.items():
        log(f"  {k} frame: async {_ms(v)}; synchronous {_ms(sync['ms_by_kind'][k])}")
    mm_ms = [m for (m, x, b) in zip((m for _, m in res), kinds, busy) if x["kind"] == "motion model" and b]
    log(f"  tracking frames (motion model) begun while a mapping job ran: {_ms(mm_ms)}; the "
        f"synchronous session's motion-model frame {_ms(sync['ms_by_kind']['motion model'])}")
    log(f"  fed at {ASYNC_FPS:g} fps: frames begun while a mapping job ran {sum(busy[1:-1])}/{len(busy) - 2} "
        f"({sum(busy[1:-1]) / (len(busy) - 2):.1%}); keyframes NeedNewKeyFrame wanted but declined because "
        f"the job ran (InterruptBA with no keyframe) {sum(declined)}")
    log(f"  the mapping job on its thread: {_ms(jobs)}; of which mapping_front "
        f"{_ms([v * 1e3 for v in st.get('map.front', [])])}, local BA chunk 1 "
        f"{_ms([v * 1e3 for v in st.get('map.local_ba1', [])])}, chunk 2 "
        f"{_ms([v * 1e3 for v in st.get('map.local_ba2', [])])}, loop closing "
        f"{_ms([v * 1e3 for v in st.get('map.loop', [])])} (the mapping stream synchronized at each stage's end)")
    steady = [j for j, r in enumerate(map_recs) if not r["captured"]]
    log(f"  the mapping job on its thread after the mapping captures ({len(steady)} of {len(map_recs)} jobs): "
        f"{_ms([jobs[j] for j in steady if j < len(jobs)])}; of which mapping_front "
        f"{_ms([st['map.front'][j] * 1e3 for j in steady if j < len(st.get('map.front', []))])}")
    log(f"  keyframe insertions that waited on the job in flight: {c['map.insert_waits']}, waiting "
        f"{_ms([v * 1e3 for v in st.get('map.insert_wait', [])])}; InterruptBA signalled {c['map.interrupts']} "
        f"times, second local-BA chunks skipped {c['map.local_ba2_skipped']} of {len(jobs)} jobs")
    log(f"  synchronising calls of the tracking thread per frame (less the harness's): median "
        f"{statistics.median(per_frame)}, max {max(per_frame)}; of the mapping thread: {len(mapping)} in "
        f"{len(jobs)} jobs (stage syncs included), e.g. {mapping[-8:]}")
    bad = []
    if init is None or init >= MONO_INIT_BY:
        bad.append(f"initialized at frame {init}")
    if tr.state != TrackingState.OK:
        bad.append(f"ended in {tr.state.name}")
    if tracked_after < MONO_TRACKED * after:
        bad.append(f"tracked {tracked_after}/{after}")
    if n_kf < 10 or mapped == 0:
        bad.append(f"{n_kf} keyframes, {mapped} mapped points")
    if not ate < MONO_ATE_SHARE * span:
        bad.append(f"ATE {ate:.4f} >= {MONO_ATE_SHARE:.0%} of {span:.3f}")
    if missing_kernels(kinds):
        bad.append(f"frames short of a kernel: {missing_kernels(kinds)}")
    if tr._mapping_future is not None:
        bad.append("the mapping future was not drained by export_trajectory")
    if tr.loop_closer.n_loops_closed:
        bad.append(f"{tr.loop_closer.n_loops_closed} loops closed on a path that revisits nothing")
    if len(st.get("map.loop", [])) != len(jobs):
        bad.append(f"{len(st.get('map.loop', []))} loop stages in {len(jobs)} jobs")
    bad += graph_report("async mono", tr)
    bad += map_graph_report("async mono", tr, map_recs)
    del tr._global_ba
    tr.stage_sync = False
    bad += global_ba_both_ways("async mono", tr, init_gba, smi, full=False)
    system.shutdown()
    if bad:
        raise AssertionError(f"async mono SLAM: {bad}")
    return launches


def _mean_reprojection(m) -> float:
    """Mean pixel error of every live observation of a LOOP_CAM map."""
    has = (m.kf_obs_pt >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
    X = m.pt_xyz[m.kf_obs_pt.clamp(min=0).long()]
    Xc = (m.kf_R[:, None] @ X[..., None])[..., 0] + m.kf_t[:, None]
    err = torch.linalg.norm(project(LOOP_CAM, Xc) - m.kf_kp_xy, dim=-1)
    return float(err[has].mean())


def phase_async_gba(smi: str):
    """The abortable global BA on the loop map at the default capacities:
    _schedule_gba returns at once, the merge halves the mean reprojection
    error, and a superseded generation leaves the map unchanged. Returns
    the perturbed map."""
    K, N, P = MAP["K"], MAP["N_cap"], MAP["P"]
    rng = np.random.default_rng(3)
    m, _, _ = build_loop_map(rng, n_kf=LOOP_KF, drift=0.0, max_kf=K, n_kp=N, max_pt=P, device="cuda")
    # Move the points that lie 1 m or more in front of every camera seeing them.
    has = (m.kf_obs_pt >= 0) & m.kf_valid[:, None]
    pt = m.kf_obs_pt.clamp(min=0).long()
    z = ((m.kf_R[:, None] @ m.pt_xyz[pt][..., None])[..., 0] + m.kf_t[:, None])[..., 2]
    min_z = torch.full((P,), float("inf"), device="cuda").scatter_reduce(
        0, pt[has], z[has], "amin")
    noise = torch.from_numpy(rng.normal(0, 0.02, (P, 3)).astype(np.float32)).cuda()
    m = m._replace(pt_xyz=torch.where((m.pt_valid & (min_z > 1.0))[:, None], m.pt_xyz + noise, m.pt_xyz))
    tr = Tracker(TrackerConfig(cam=LOOP_CAM, max_keyframes=K, max_points=P, async_mapping=True,
                               enable_loop_closing=False), device="cuda")
    e0 = _mean_reprojection(m)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = tr._schedule_gba(m, iters=10)
    ret_ms = (time.perf_counter() - t0) * 1e3
    tr._gba_future.result()
    job_ms = (time.perf_counter() - t0) * 1e3
    st = dict(tr.stats)
    t0 = time.perf_counter()
    m2 = tr._poll_gba(m)
    torch.cuda.synchronize()
    merge_ms = (time.perf_counter() - t0) * 1e3
    e1 = _mean_reprojection(m2)
    tr._schedule_gba(m, iters=10)
    f = tr._gba_future
    tr._gba_generation += 1  # a newer closure supersedes the run
    aborted = f.result() is None
    m3 = tr._poll_gba(m)
    tr.shutdown()
    g = tr.gba_graphs
    log(f"async global BA on {smi} ({LOOP_KF} keyframes, {int(m.pt_valid.sum())} points, capacities {K}/{N}/{P}): "
        f"_schedule_gba returned in {ret_ms:.3f} ms, the job (2 chunks of 5 LM iterations on its own "
        f"stream, through tracker.gba_graphs) took {job_ms:.1f} ms, the merge {merge_ms:.3f} ms; mean "
        f"reprojection error {e0:.4f} -> {e1:.4f} px; gba_iters {st['gba_iters']}, gba_graph_replays "
        f"{st['gba_graph_replays']}, gba_graph_captures {st['gba_graph_captures']} ({captures_report(g)}), "
        f"graph pool {g.pool_bytes() / 2**20:.1f} MiB, static buffers {g.buffer_bytes() / 2**20:.1f} MiB; a "
        f"superseded run {'aborted at a chunk boundary' if aborted else 'finished'} and the map was "
        f"{'unchanged' if m3 is m else 'CHANGED'}")
    if out is not m or not e1 < 0.5 * e0 or m3 is not m or not aborted:
        raise AssertionError(f"async global BA: returned the map {out is m}, error {e0:.4f} -> {e1:.4f}, "
                             f"superseded run aborted {aborted}, left the map {m3 is m}")
    if not st["gba_graph_replays"] == st["gba_iters"] == 10:
        raise AssertionError(f"async global BA: {st['gba_graph_replays']} replays of {st['gba_iters']} "
                             f"LM iterations")
    return m


def phase_mapping_process(scene: StepWallScene, smi: str) -> dict:
    """Stereo SLAM at the stereo phase's point with mapping in a worker
    process on the same card: the stereo gates, the worker's BoW rows in
    the tracker's loop closer, bytes and ms per job, the worker's start-up,
    and shutdown closing the process. Returns the kernels' launches."""
    cam, cfg = KITTI_CAM, KITTI_ORB
    poses = orbit_trajectory(PAR_STEREO_FRAMES, **STEREO_POSES)
    frames = render_stereo_frames(scene, cam, poses, device="cuda")
    system = System(cam, SensorType.STEREO, orb=cfg, device="cuda", mapping_process=True,
                    mapping_process_platform="cuda", **STEREO_TRACKER)
    tr = system.tracker
    rm = tr._remote_mapper
    proc = rm._proc
    rec = []
    zero_launches()
    t0 = time.perf_counter()
    res = depth_session(system, frames, on_frame=session_recorder(tr, rec))
    wall = time.perf_counter() - t0
    launches = dict(rec[-1]["launches"])
    traj = tr.export_trajectory()
    kinds, by_kind = _per_kind(rec, res)
    bad, summary = depth_gates("mapping process", traj, poses, PAR_STEREO_FRAMES)
    lc = tr.loop_closer
    mirrored = bool(lc._bow) and lc.voc is not None and all(
        bool(lc.db.has[k]) and torch.equal(lc.db.words[k], b.words) for k, b in lc._bow.items())
    n_session_jobs = len(rm.jobs)
    # The transport of a warm worker: the final map's snapshot shipped
    # PAR_TRANSPORT_JOBS more times (the results dropped).
    for _ in range(PAR_TRANSPORT_JOBS):
        rm.process(tr.map, tr._last_kf_idx, True)
    jobs = rm.jobs[n_session_jobs:]

    def med(key, worker=False):
        return statistics.median((j["worker"] if worker else j)[key] for j in jobs) if jobs else float("nan")

    log(f"stereo SLAM with a mapping process on {smi} (the worker on {rm.info['name']}, {rm.info['device']}; "
        f"started in {rm.info['startup_s']:.2f} s, jax or tpuslam modules in it: {rm.info['foreign_modules']}): "
        f"{PAR_STEREO_FRAMES} frames in {wall:.1f} s, {summary}; {tr._n_kf_host} keyframes, {n_session_jobs} jobs "
        f"(the first: the job {rm.jobs[0]['worker']['compute_ms']:.1f} ms in the worker, "
        f"{rm.jobs[0]['wait_ms']:.1f} ms waited for); "
        f"BoW rows mirrored into the tracker's closer: {sorted(lc._bow)} ({'equal' if mirrored else 'MISSING'})")
    for k, v in by_kind.items():
        log(f"  {k} frame: {_ms(v)}")
    if jobs:
        log(f"  per job, {len(jobs)} more jobs of the final snapshot (medians): {med('bytes_out') / 2**20:.1f} MiB out, {med('bytes_in') / 2**20:.1f} MiB "
            f"back; tracker side: device->host {med('d2h_ms'):.1f} ms, pickle {med('pickle_ms'):.1f} ms, pipe "
            f"send {med('send_ms'):.1f} ms, the reply's pipe {med('recv_ms'):.1f} ms, unpickle "
            f"{med('unpickle_ms'):.1f} ms, host->device {med('h2d_ms'):.1f} ms, waiting for the reply "
            f"{med('wait_ms'):.1f} ms; worker side: pipe {med('recv_ms', True):.1f} ms, unpickle "
            f"{med('unpickle_ms', True):.1f} ms, host->device {med('h2d_ms', True):.1f} ms, the job "
            f"{med('compute_ms', True):.1f} ms, device->host with the BoW rows {med('d2h_ms', True):.1f} ms")
    system.shutdown()
    closed = proc.poll() is not None and tr._remote_mapper is None
    log(f"  shutdown: the worker process {'closed' if closed else 'STILL RUNNING'} "
        f"(exit code {proc.returncode})")
    if kinds[0]["state"] != "OK" or tr.state != TrackingState.OK:
        bad.append(f"first frame {kinds[0]['state']}, end {tr.state.name}")
    if missing_kernels(kinds):
        bad.append(f"frames short of a kernel: {missing_kernels(kinds)}")
    if not n_session_jobs or n_session_jobs != tr.metrics.counters["frames.keyframe"]:
        bad.append(f"{n_session_jobs} jobs for {tr.metrics.counters['frames.keyframe']} keyframes")
    if not mirrored:
        bad.append("the worker's BoW rows are not in the tracker's loop closer")
    if rm.info["foreign_modules"] or not rm.info["device"].startswith("cuda"):
        bad.append(f"the worker: {rm.info}")
    if not closed:
        bad.append("shutdown left the worker process running")
    bad += graph_report("mapping process", tr)
    w = rm.jobs[-1]["worker"] if rm.jobs else {}
    log(f"  the worker's mapping graphs: map_graph_replays {w.get('map_graph_replays')} of {w.get('map_jobs')} "
        f"keyframe jobs (the session's and the {PAR_TRANSPORT_JOBS} more), map_graph_captures "
        f"{w.get('map_graph_captures')}; the tracker's own map_graphs ran {tr.map_graphs.runs} segments")
    if not (w and w["map_graph_replays"] == w["map_jobs"] >= 1 and w["map_graph_captures"] <= MAP_GRAPH_KEYS):
        bad.append(f"the worker's mapping graphs: {w}")
    if tr.map_graphs.runs:
        bad.append(f"the tracker's own map_graphs ran {tr.map_graphs.runs} segments with a mapping process")
    if bad:
        raise AssertionError(f"mapping process: {bad}")
    return launches


def _sharded_ba(name: str, prob, cam, mesh, iters: dict) -> list:
    """Both sharded solvers on `mesh` against the single-device solver on
    one problem: times, the largest differences (held to PAR_BA_TOL), the
    robust cost before and after (an unchanged cost means no LM step was
    taken, so the equality says nothing), the bytes reduced per LM
    iteration. Returns the failures."""
    from tpuslam_torch.optim.ba import _edge_chi2

    runs = {}
    for kind, fn in (("single", lambda st: bundle_adjustment(cam, prob, **iters)),
                     ("point-sharded", lambda st: point_sharded_bundle_adjustment(cam, prob, mesh, stats=st, **iters)),
                     ("observation-parallel", lambda st: distributed_bundle_adjustment(cam, prob, mesh, stats=st,
                                                                                       **iters))):
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(stats)
        torch.cuda.synchronize()
        runs[kind] = (out, (time.perf_counter() - t0) * 1e3, stats)
    ref, single_ms, _ = runs["single"]
    v = prob.valid
    c0 = float(_edge_chi2(cam, prob, prob.R, prob.t, prob.X)[v].mean())
    log(f"  {name}: {int(v.sum())} edges over {prob.R.shape[0]} keyframes and {prob.X.shape[0]} points, "
        f"{iters}; the single solver {single_ms:.1f} ms, mean edge chi2 {c0:.6g} -> {float(ref[3][v].mean()):.6g}")
    bad = []
    for kind in ("point-sharded", "observation-parallel"):
        out, ms, stats = runs[kind]
        errs = [float((a - b).abs().max()) for a, b in zip(out[:3], ref[:3])]
        log(f"    {kind}, {len(mesh)} shards on {len(set(mesh))} card: {ms:.1f} ms; max |dR| {errs[0]:.2e}, "
            f"|dt| {errs[1]:.2e}, |dX| {errs[2]:.2e}; {stats['reductions']} reductions, "
            f"{stats['bytes_per_iteration'] / 1024:.2f} KiB reduced per LM iteration")
        if not all(e < tol for e, tol in zip(errs, PAR_BA_TOL)):
            bad.append(f"{name}: {kind} BA differs from the single-device solver: {errs}")
    return bad


def phase_sharded(smi: str, map_path: str, loop_map) -> None:
    """Two BA shards and two map shards on the one card: both sharded
    solvers against the single-device solver on the synthetic problem
    (PAR_BA) and on the global BA of the loop map (the tracker's own
    problem, through its point-sharded path); the sharded covisibility
    and search on phase 6's saved map against the dense ones, equal
    exactly."""
    from tpuslam_torch.io.checkpoint import load_map

    mesh = [torch.device("cuda", 0)] * PAR_SHARDS  # the one card, shared
    cam, prob = synthetic_ba_problem(np.random.default_rng(0), device="cuda", **PAR_BA)
    bad = _sharded_ba(f"synthetic_ba_problem({PAR_BA})", prob, cam, mesh, PAR_BA_ITERS)
    # The loop map's global BA: the tracker's problem, solved on one device
    # and through its point-sharded path (_ba_mesh set as dist_ba_devices
    # would set it on a machine with two cards).
    K, P = loop_map.capacity_kf, loop_map.capacity_pt
    single = Tracker(TrackerConfig(cam=LOOP_CAM, max_keyframes=K, max_points=P, enable_loop_closing=False),
                     device="cuda")
    sharded = Tracker(single.cfg, device="cuda")
    sharded._ba_mesh = mesh
    probs = []  # the problem of the mesh path: the live edges, unpadded
    run_ba = sharded._run_ba
    sharded._run_ba = lambda p, iters: probs.append(p) or run_ba(p, iters)
    g2 = sharded._global_ba(loop_map, iters=4)
    g1 = single._global_ba(loop_map, iters=4)  # padded, through its graphs
    # Its points fill the first slots, so contiguous blocks of the 200,000
    # slots put every edge in shard 0; the solvers are held on the problem
    # with the point capacity cut to the live slots too, where both shards
    # work.
    prob = probs[0]
    n_live = int(prob.pt.max()) + 1
    per_shard = torch.bincount(prob.pt.long() // (P // PAR_SHARDS), minlength=PAR_SHARDS).tolist()
    bad += _sharded_ba(f"the {LOOP_KF}-keyframe loop map's global BA (edges per point block {per_shard})",
                       prob, LOOP_CAM, mesh, dict(iters=4))
    live = prob._replace(X=prob.X[:n_live], fixed_pt=prob.fixed_pt[:n_live])
    per_shard = torch.bincount(live.pt.long() // -(-n_live // PAR_SHARDS), minlength=PAR_SHARDS).tolist()
    bad += _sharded_ba(f"the same, the points cut to the {n_live} live slots (edges per point block {per_shard})",
                       live, LOOP_CAM, mesh, dict(iters=4))
    errs = [float((getattr(g2, f) - getattr(g1, f)).abs().max()) for f in ("kf_R", "kf_t", "pt_xyz")]
    log(f"    Tracker._global_ba through its point-sharded path (200,000 slots) against its single-device "
        f"one: max |dR| {errs[0]:.2e}, |dt| {errs[1]:.2e}, |dX| {errs[2]:.2e}")
    if not all(e < tol for e, tol in zip(errs, PAR_BA_TOL)):
        bad.append(f"the tracker's sharded global BA differs: {errs}")

    m = load_map(map_path, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dense = covisibility_weights(m)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sharded_w = sharded_covisibility_weights(m, mesh)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    k = int(torch.argmax(torch.where(m.kf_valid, m.kf_frame_id, -1)))
    R, t = m.kf_R[k], m.kf_t[k]
    kp = (m.kf_kp_xy[k, :PAR_SEARCH_KP], m.kf_kp_desc[k, :PAR_SEARCH_KP], m.kf_kp_level[k, :PAR_SEARCH_KP],
          m.kf_kp_angle[k, :PAR_SEARCH_KP], m.kf_kp_valid[k, :PAR_SEARCH_KP])
    got = sharded_search_local_points(CAM, m, mesh, R, t, *kp)
    P = m.capacity_pt
    pc = se3_apply(R, t, m.pt_xyz)
    want = search_by_projection_points(
        project(CAM, pc), m.pt_desc, m.pt_valid & (pc[:, 2] > 0.1), torch.full((P,), 15.0, device="cuda"),
        torch.zeros(P, dtype=torch.int32, device="cuda"), torch.full((P,), 7, dtype=torch.int32, device="cuda"), *kp)
    ok = want[2]
    same_search = (torch.equal(got[2], ok) and torch.equal(got[0][ok], want[0][ok])
                   and torch.equal(got[1][ok], want[1][ok]))
    same_covis = torch.equal(sharded_w, dense)
    log(f"  phase 6's map ({int(m.kf_valid.sum())} keyframes, {int(m.pt_valid.sum())} points in {P} slots) on "
        f"{PAR_SHARDS} shards: covisibility {'equal' if same_covis else 'DIFFERENT'} to the dense "
        f"({(t2 - t1) * 1e3:.1f} ms against {(t1 - t0) * 1e3:.1f} ms, {int((dense > 0).sum())} nonzero weights); "
        f"the search of keyframe {k}'s {PAR_SEARCH_KP} keypoints over every point "
        f"{'equal' if same_search else 'DIFFERENT'} to the dense ({int(ok.sum())} matches)")
    if not same_covis:
        bad.append("sharded covisibility differs from the dense")
    if not same_search or int(ok.sum()) == 0:
        bad.append(f"sharded search differs from the dense or matched nothing ({int(ok.sum())})")
    if bad:
        raise AssertionError(f"sharded: {bad}")


def phase_parallel(smi: str, scene: StepWallScene, stereo_scene: StepWallScene, mono: dict) -> dict:
    """The parallel paths (see the module docstring). Returns the kernels'
    launches of the async mono session and the mapping-process session."""
    t0 = time.perf_counter()
    a = phase_async_mono(scene, smi, mono)
    log(f"  (async mono: {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    loop_map = phase_async_gba(smi)
    log(f"  (async global BA: {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    b = phase_mapping_process(stereo_scene, smi)
    log(f"  (mapping process: {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    log(f"sharded BA and map on {smi}:")
    phase_sharded(smi, mono["path"], loop_map)
    log(f"  (sharded: {time.perf_counter() - t0:.1f} s)")
    return {k: a[k] + b[k] for k in a}


PHASE_S = {}  # phase name -> wall seconds


def timed(name: str, fn, *args):
    """fn(*args), with the phase's wall time printed (and kept in PHASE_S)."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_S[name] = time.perf_counter() - t0
    log(f"phase {name}: {PHASE_S[name]:.1f} s")
    return out


def kernel_times(imgs, smi: str) -> dict:
    """Each kernel against its plain version (and gather_patches against
    one aten::index call, and its wrapper) in turns, at B=4 and B=1: the
    time per call with the host's launch gaps, as the kernels line reports
    it in `ms`, then the device's time alone (`ahead`, `device_ms`), of
    which the bound is a share."""
    res = {}
    th = CFG.min_th_fast
    for b in (B, 1):
        levels = build_pyramid(imgs[:b], CFG.n_levels, CFG.scale_factor)
        *_, atlas, corner = detect_batched(imgs[:b], CFG)
        a32 = atlas.float()
        ar = torch.arange(PSIZE, device=atlas.device)
        rows = (corner[:, 0].long()[:, None] + ar)[:, :, None]
        cols = (corner[:, 1].long()[:, None] + ar)[:, None, :]
        fns = {
            "fast_nms": lambda: fast_nms_pyramid(levels, th),
            "fast_nms plain": lambda: [fast_nms_plain(x, th) for x in levels],
            "gather_patches": lambda: _gather_patches_cuda(atlas, corner),
            "gather_patches wrapper": lambda: gather_patches(atlas, corner),
            "gather_patches plain": lambda: gather_patches_plain(atlas, corner),
            "gather_patches library": lambda: a32[rows, cols],
        }
        per_call = dict(zip(fns, cuda_ms_turns(list(fns.values()))))
        dev = dict(zip(fns, cuda_ms_turns(list(fns.values()), ahead=True)))
        bounds = {"fast_nms": fast_bound_ms(levels, th), "gather_patches": gather_bound_ms(atlas, corner)}
        log(f"kernel times at B={b} on {smi} (CUDA-event medians of {REPS}, in turns; "
            f"per call with the host's gaps, then the device's time alone):")
        for name, (bound, by) in bounds.items():
            log(f"  {name}: kernel {per_call[name]:.4f} / {dev[name]:.4f} ms, plain "
                f"{per_call[name + ' plain']:.4f} / {dev[name + ' plain']:.4f} ms, bound {bound:.4f} ms "
                f"({by}), {bound / dev[name]:.1%} of the bound (device time)")
        log(f"  gather_patches wrapper (no device->host read): {per_call['gather_patches wrapper']:.4f} / "
            f"{dev['gather_patches wrapper']:.4f} ms")
        log(f"  gather_patches library yardstick a32[rows, cols] (one aten::index on a float32 "
            f"atlas, prebuilt index grids): {per_call['gather_patches library']:.4f} / "
            f"{dev['gather_patches library']:.4f} ms; fast_nms has no single PyTorch call "
            f"that computes its function")
        res[b] = dict(dev=dev, per_call=per_call, bounds=bounds)
    return res


def main() -> int:
    smi = timed("device", phase_device)
    timed("build", phase_build)

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    scene = StepWallScene(np.random.default_rng(5))
    poses = orbit_trajectory(B + 1, step=0.04)
    inp = coherent_track_inputs(
        scene, CAM, CFG, [(poses[i], poses[i + 1]) for i in range(B)], N_LOCAL,
        np.random.default_rng(1), device="cuda",
    )
    log(f"scene and inputs: {time.perf_counter() - t0:.1f} s")
    imgs = torch.from_numpy(inp["imgs"]).cuda()

    err = timed("kernels", phase_kernels, imgs, rng)
    pose_times = timed("pose kernel", phase_pose_kernel, smi)
    timed("device assert", phase_device_assert)
    args, launches, slice_graphs = timed("slice", phase_slice, inp, smi)
    session, (_, late), map_launches, per_frame = timed("map slice", phase_map, scene)

    kt = timed("kernel times", kernel_times, imgs, smi)
    with launches_kept():
        step_ms, eager_ms = cuda_ms_turns([lambda: track_step_batched(CAM, CFG, *args, run=slice_graphs.run),
                                           lambda: track_step_batched(CAM, CFG, *args)])
    log(f"times on {smi}:")
    log(f"  track_step_batched B={B}, graphed: {step_ms:.3f} ms/step, {B * 1000.0 / step_ms:.2f} frames/s "
        f"(eager {eager_ms:.3f} ms/step, {B * 1000.0 / eager_ms:.2f} frames/s; CUDA-event medians of "
        f"{REPS}, in turns)")
    timed("map times", map_times, session, late, smi)
    graph_launches = timed("graphs", phase_graphs, scene, smi)
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_")  # the mono map, the facade's files
    mono_launches, mono = timed("mono SLAM", phase_mono, scene, smi, work.name)
    stereo_scene = StepWallScene(np.random.default_rng(5), **STEREO_SCENE)
    sk = timed("stereo kernels", phase_stereo_kernels, stereo_scene, smi)
    stereo = timed("stereo SLAM", phase_stereo, stereo_scene, smi)
    rgbd = timed("RGB-D SLAM", phase_rgbd, smi)
    timed("mapping graphs", phase_mapping_graphs, smi, mono, stereo, rgbd)
    del mono["map_jobs"], stereo["map_job"], rgbd["map_job"]
    multi_launches = timed("MultiTracker", phase_multi, stereo_scene, smi)
    timed("place", phase_place, smi)
    timed("loop", phase_loop, smi)
    facade_launches = timed("facade", phase_facade, smi, scene, mono, work.name)
    parallel_launches = timed("parallel", phase_parallel, smi, scene, stereo_scene, mono)
    work.cleanup()
    log(f"phases: {sum(PHASE_S.values()):.1f} s in all")
    for name in err:
        err[name] = max(err[name], sk["err"][name])

    def stereo_shape(key: str) -> dict:
        return {"ms": sk["per_call"][key], "device_ms": sk["dev"][key],
                "plain_ms": sk["per_call"][key + " plain"], "bound_ms": sk["bounds"][key][0],
                "bound_by": sk["bounds"][key][1], "library_ms": sk["per_call"].get(key + " library")}

    sources = {
        "fast_nms": ("tpuslam_torch/csrc/fast_nms.cu", "tpuslam/ops/fast_pallas.py:100",
                     {"stereo": stereo_shape("fast_nms")}),
        "gather_patches": ("tpuslam_torch/csrc/gather_patches.cu", "tpuslam/ops/patches.py:164",
                           {"stereo_describe": stereo_shape("gather describe"),
                            "stereo_sad": stereo_shape("gather sad")}),
    }
    main_b = kt[B]
    total = {name: (launches[name] + map_launches[name] + graph_launches[name] + mono_launches[name]
                    + stereo["launches"][name] + stereo["loc_launches"][name] + rgbd["launches"][name]
                    + multi_launches[name] + facade_launches[name] + parallel_launches[name])
             for name in KERNELS}

    def counts(name: str) -> dict:
        return {"launches": total[name],
                "launches_per_frame": statistics.median(d[name] for d in per_frame),
                "launches_per_stereo_frame": stereo["per_frame"][name],
                "launches_per_rgbd_frame": rgbd["per_frame"][name]}

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, **counts(name),
         "max_abs_err": err[name],
         "ms": main_b["per_call"][name], "plain_ms": main_b["per_call"][name + " plain"],
         "device_ms": main_b["dev"][name],
         "bound_ms": main_b["bounds"][name][0], "bound_by": main_b["bounds"][name][1],
         "library_ms": main_b["per_call"].get(name + " library"),
         "stereo_shapes": shapes}
        for name, (src, rep, shapes) in sources.items()
    ] + [
        {"name": "pose_optimization", "route": "cuda", "source": "tpuslam_torch/csrc/pose_lm.cu",
         "replaces": None, **counts("pose_optimization"),
         **pose_times[POSE_SHAPES[0][0]], "shapes": pose_times}
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
