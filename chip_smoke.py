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
  4. slice: track_step_batched at 640x480, 1000 ORB features, B=4 streams,
     L=4096 local-map points on a coherent synthetic scene; every kernel must
     have launched, each stream must land on its ground-truth pose, and the
     same inputs through the port on the CPU must agree;
  map slice: the per-frame step the tracker runs, fused_track_frame_image,
     over a MapState at the tracker's default capacities (1536 keyframes,
     2000 keypoint slots, 200,000 points; local subset 16384, candidate cap
     8192), along a session built by testing.build_depth_session: every
     frame accepted within 1 cm / 0.2 deg of ground truth, both branches
     taken, both kernels launched on every frame, and one mid-session state
     through the port on the CPU agreeing with the card;
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
     ATE below 3% of the path's span, and launch both kernels on every
     frame, and close no loop (the path revisits nothing); the loop stage's
     ms and device->host reads per keyframe are printed. Then, on the
     finished map: device->host reads of a motion-model
     and a reference-keyframe frame (<= 2 and <= 1, or the run fails) and of
     one keyframe job, that job (Tracker._mapping_compute on a mid-session
     snapshot) on the CPU against the card, and a forced LOST relocalized
     from an earlier frame at its true place through the BoW database's
     keyframe candidates (the brute-force branch must not run; it is then
     timed alone on the same frame for comparison). Prints ms per frame by branch,
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
     the rigid ATE below 3% of it, both kernels on every frame, no loop
     closed (the loop stage's ms and reads per keyframe printed). Prints ms per
     frame by kind (the keyframe frames split into the stereo front end,
     mapping_front, the local-BA chunks and the rest), the front end alone
     (it must make no device->host read), reads by frame kind, peak memory,
     one frame's front end on the CPU against the card, then localization
     mode over 20 frames past the mapped region (the map must not change,
     >= 75% tracked; whether VO mode engaged);
  RGB-D SLAM: System.track_rgbd at TUM1.yaml's operating point (640x480,
     1000 features, ThDepth 40, depth as uint16 at 5000 per metre; zero
     distortion: the renderer is a pinhole) over 60 frames of a StepWallScene
     at half depth, so keypoints lie on both sides of th_depth (3.09 m):
     the same gates and prints;
  MultiTracker: track_stereo over 2 KITTI-sized streams for 12 frames, one
     FAST+NMS launch per batched extraction of the 4 images, every frame of
     every stream tracked within the stereo gates (RGB-D and MultiTracker
     keep loop closing off, so the phases stay inside the time limit);
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
     land within 1 cm and 0.1 deg of the card's corrected poses. Prints ms
     per keyframe without a candidate, the closing keyframe by stage (Sim3,
     fusion, essential graph with its GN and CG iterations and launches,
     global BA), reads per keyframe and peak memory.
Each phase prints its wall time. The line before the last is
{"kernels": [...]} (the launches of every phase's main-path run, and the
stereo shapes' times); the last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path

import numpy as np
import torch

import tpuslam_torch._build as build
from tpuslam_torch.convert import array_to_tensor, map_to_numpy, map_to_torch
from tpuslam_torch.geometry.camera import PinholeCamera
from tpuslam_torch.mapstate.core import FrameFeatures, update_point_normals
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
    pose_errors,
    render_frames,
    render_rgbd_frames,
    render_stereo_frames,
    trajectory_ate,
)

B, N_FEATURES, N_LOCAL = 4, 1000, 4096
CAM = PinholeCamera(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480)
CFG = ORBConfig(n_features=N_FEATURES)
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
# ATE gate, a share of the path's span. tests/test_integration_mono.py holds
# its 36-frame path (4.5 cm a frame) to 2%, as tests/test_torch_tracker_mono.py
# does the port; on this path (2 cm a frame, 100 frames) the ATE moved from
# 0.65% to 2.23% over four runs of code that differed only in summation order
# (the card's float sums also come in another order each run), so the gate
# is 3%.
MONO_ATE_SHARE = 0.03
MONO_SNAP_JOB, MONO_RELOC_FRAME = 10, 50
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


def phase_slice(inp: dict):
    args = [array_to_tensor(inp[k], "cuda") for k in TRACK_STEP_ARGS]
    fast_nms.launches = 0
    gather_patches.launches = 0
    torch.cuda.synchronize()
    R2, t2, n_inl2, n_valid = track_step_batched(CAM, CFG, *args)
    torch.cuda.synchronize()
    launches = {"fast_nms": fast_nms.launches, "gather_patches": gather_patches.launches}
    log(f"main path launches: {launches}")
    if launches["fast_nms"] < 1 or launches["gather_patches"] < 1:
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
    return args, launches


def _fused(st, img, inv_sigma2, has_vel=None):
    """fused_track_frame_image on a session state, as the tracker calls it."""
    has_vel = st.has_vel if has_vel is None else has_vel
    vel_R, vel_t = (st.vel_R, st.vel_t) if has_vel else (
        torch.eye(3, device=img.device), torch.zeros(3, device=img.device))
    return fused_track_frame_image(
        CAM, CFG, st.m, img, st.last_feats, st.last_obs, st.last_R, st.last_t,
        vel_R, vel_t, has_vel, st.ref_kf, inv_sigma2.to(img.device),
        MAP_STEP["accept_thr"], min_inliers_motion=MAP_STEP["min_inliers_motion"],
        max_local_pts=MAP_STEP["max_local_pts"], cand_cap=MAP_STEP["cand_cap"],
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
    seen = {"fast_nms": 0, "gather_patches": 0}

    def on_frame(i, rec):
        now = {"fast_nms": fast_nms.launches, "gather_patches": gather_patches.launches}
        per_frame.append({k: now[k] - seen[k] for k in now})
        seen.update(now)

    fast_nms.launches = 0
    gather_patches.launches = 0
    t0 = time.perf_counter()
    s = build_depth_session(scene, CAM, CFG, poses, MAP["K"], MAP["N_cap"], MAP["P"],
                            MAP_KF_EVERY, device=device, snapshot_at=MAP_SNAP,
                            on_frame=on_frame, **MAP_STEP)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fast_nms": fast_nms.launches, "gather_patches": gather_patches.launches}

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
    """(fn(), one "file:line (function)" per synchronising CUDA call it
    made), from torch.cuda.set_sync_debug_mode's warnings. The site is the
    innermost frame of the port on the warning's stack, so a sync inside
    torch's own Python code is charged to the port's line that called it;
    a sync with no frame of the port gives the innermost three frames."""
    pkg = str(Path(__file__).resolve().parent / "tpuslam_torch")
    sites = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        stack = [f for f in traceback.extract_stack()[:-1]
                 if not f.filename.endswith("warnings.py")]
        ours = [f for f in stack if f.filename.startswith(pkg)]
        where = ours[-1:] or stack[::-1][:3]
        sites.append(" < ".join(f"{Path(f.filename).name}:{f.lineno} ({f.name})" for f in where))

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        sites.clear()  # setting the mode reports a sync of its own
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sites


def _dev_time(e):
    return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))


def profile_call(fn):
    """One call of fn under torch.profiler: (wall ms, kernel launches,
    device us summed over the profiler's events, its 8 largest events)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ev = prof.key_averages()
    launches = sum(e.count for e in ev if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    return wall_ms, launches, sum(_dev_time(e) for e in ev), sorted(ev, key=_dev_time, reverse=True)[:8]


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
                        launches={"fast_nms": fast_nms.launches,
                                  "gather_patches": gather_patches.launches}))
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


def phase_mono(scene: StepWallScene, smi: str) -> dict:
    """Mono SLAM through the port's System at the default capacities (see
    the module docstring). Returns the kernels' launches in the session."""
    poses = orbit_trajectory(MONO_FRAMES + 3, **MAP_POSES)
    frames = render_frames(scene, CAM, poses, device="cuda")
    system = System(CAM, orb=CFG, device="cuda")  # the default TrackerConfig: loop closing on
    tr = system.tracker
    tr.stage_sync = True  # the stage timers hold device time
    kept = keep_mapping_inputs(tr, jobs={MONO_SNAP_JOB})
    loop_reads = watch_loop_stage(tr)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fast_nms.launches = 0
    gather_patches.launches = 0
    rec, peaks = [], {}
    record = session_recorder(tr, rec)

    def on_frame(i, out):
        if "init" not in peaks and tr.state == TrackingState.OK:
            peaks["init"] = torch.cuda.max_memory_allocated()  # up to the initial global BA
            torch.cuda.reset_peak_memory_stats()
        record(i, out)

    t0 = time.perf_counter()
    res = mono_session(system, frames[:MONO_FRAMES], on_frame=on_frame)
    wall = time.perf_counter() - t0
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
    if any(x["launches"][k] < 1 for x in kinds for k in launches):
        bad.append(f"a frame without both kernels: {[x['launches'] for x in kinds]}")
    bad += loop_stage_report("mono", tr, loop_reads, smi)
    if bad:
        raise AssertionError(f"mono SLAM: {bad}")
    del tr._close_loops  # the instance's own method again

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
    out, reloc_gib = peak_gib(lambda: system.track_monocular(frames[MONO_RELOC_FRAME], 99.0))
    reloc_ms = tr.metrics.timer.samples["track.relocalize"][-1] * 1e3
    if out is None or tr.state != TrackingState.OK:
        raise AssertionError("mono SLAM: no relocalization after a forced LOST")
    if tr.reloc_path != "bow":
        raise AssertionError(f"mono SLAM: the relocalization took the {tr.reloc_path} branch")
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
        f"device time {dev_bf / 1e3:.3f} ms of {wall_bf:.3f} ms wall. BoW against brute force: "
        f"{reloc_ms:.3f} against {bf_ms:.3f} ms, {n_launch} against {n_bf} launches")
    return launches


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


def phase_depth(name: str, system: System, frames: list, poses, smi: str, front_fn) -> dict:
    """A stereo or RGB-D session through the port's System on the card (see
    the module docstring): its gates, ms per frame by kind, the front end
    alone, device->host reads by frame kind, peak memory. `frames` holds
    DEPTH_FRAMES session frames and 3 more for the read counts; front_fn(f)
    runs the front end alone on frame f. Returns (launches in the session,
    their medians per frame)."""
    tr = system.tracker
    tr.stage_sync = True  # the stage timers hold device time
    feat_stage = f"track.{name}_features"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fast_nms.launches = 0
    gather_patches.launches = 0
    rec = []
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
    if loop_reads is not None:
        bad += loop_stage_report(name, tr, loop_reads, smi)
        del tr._close_loops
    if kinds[0]["state"] != "OK":
        bad.append(f"{name}: not initialized on the first frame")
    if tr.state != TrackingState.OK:
        bad.append(f"{name}: ended in {tr.state.name}")
    if any(x["launches"][k] < 1 for x in kinds for k in launches):
        bad.append(f"{name}: a frame without both kernels: {[x['launches'] for x in kinds]}")
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
    return dict(launches=launches, per_frame=per_frame)


def phase_localization(name: str, system: System, frames: list, poses, smi: str) -> dict:
    """Localization mode after the stereo session: LOC_FRAMES frames past
    the mapped region against the frozen map, with visual-odometry points.
    Fails if the map changes or fewer than LOC_TRACKED of them are tracked.
    Returns the launches of those frames."""
    tr = system.tracker
    m0 = tr.map
    frozen = {k: getattr(m0, k).clone() for k in ("pt_valid", "pt_xyz", "kf_valid", "kf_R", "kf_t",
                                                  "kf_obs_pt", "n_kf", "n_pt")}
    system.activate_localization_mode()
    fast_nms.launches = 0
    gather_patches.launches = 0
    first = DEPTH_FRAMES + 3
    tracked, vo, ms = 0, 0, []
    for i in range(first, first + LOC_FRAMES):
        (out, t_ms), = depth_session(system, [frames[i]])
        tracked += out is not None
        vo += bool(tr._vo_mode)
        ms.append(t_ms)
    system.deactivate_localization_mode()
    launches = {"fast_nms": fast_nms.launches, "gather_patches": gather_patches.launches}
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
        f"max {max(errs) if errs else float('nan'):.4f} m; {_ms(ms)} per frame; launches {launches}")
    if changed or tracked < LOC_TRACKED * LOC_FRAMES:
        raise AssertionError(f"{name} localization mode: map changed {changed}, tracked {tracked}/{LOC_FRAMES}")
    return launches


def phase_multi(scene: StepWallScene, smi: str) -> dict:
    """MultiTracker.track_stereo over MULTI_B KITTI-sized streams: one
    batched extraction of the 2B images per frame (exactly one fast_nms
    launch), every frame of every stream tracked, each stream within the
    stereo session's span and rigid-ATE gates. Returns its launches."""
    paths = [orbit_trajectory(MULTI_FRAMES, **p) for p in MULTI_POSES]
    frames = [render_stereo_frames(scene, KITTI_CAM, p, device="cuda") for p in paths]
    mt = MultiTracker.uniform(TrackerConfig(cam=KITTI_CAM, orb=KITTI_ORB, **MULTI_TRACKER), MULTI_B,
                              device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fast_nms.launches = 0
    gather_patches.launches = 0
    per_frame, ms, missed = [], [], []
    for i in range(MULTI_FRAMES):
        seen = (fast_nms.launches, gather_patches.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = mt.track_stereo(torch.stack([f[i][0] for f in frames]),
                               torch.stack([f[i][1] for f in frames]), i)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        per_frame.append((fast_nms.launches - seen[0], gather_patches.launches - seen[1]))
        missed += [(i, b) for b, o in enumerate(outs) if o is None]
    launches = {"fast_nms": fast_nms.launches, "gather_patches": gather_patches.launches}
    bad = []
    for b, tr in enumerate(mt.trackers):
        fails, summary = depth_gates(f"stream {b}", tr.export_trajectory(), paths[b], MULTI_FRAMES)
        bad += fails
        log(f"  stream {b}: {summary}; {tr._n_kf_host} keyframes")
    log(f"MultiTracker.track_stereo on {smi}: B={MULTI_B} streams at {KITTI_CAM.width}x{KITTI_CAM.height}, "
        f"{KITTI_ORB.n_features} features, {MULTI_FRAMES} frames: {_ms(ms)} per batched frame; (fast_nms, "
        f"gather_patches) launches per frame {per_frame}; peak memory allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if missed:
        bad.append(f"untracked (frame, stream): {missed}")
    if any(f != 1 or g != 1 + MULTI_B for f, g in per_frame):
        bad.append(f"launches per frame {per_frame}, want (1, {1 + MULTI_B})")
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

    out = phase_depth("stereo", system, frames, poses, smi, front)
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
        return tr._frame_features_rgbd(f[0], depth_dev[key])

    f = front(frames[0])
    has = f.depth > 0
    close = has & (f.depth < tr._th_depth)
    log(f"RGB-D frame 0: {int(f.valid.sum())} keypoints, {int(has.sum())} with depth, {int(close.sum())} "
        f"closer than th_depth {tr._th_depth:.3f} m, {int((has & ~close).sum())} farther")
    if not (int(close.sum()) > 50 and int((has & ~close).sum()) > 50):
        raise AssertionError("RGB-D SLAM: the scene does not put keypoints on both sides of th_depth")
    return phase_depth("rgbd", system, frames, poses, smi, front)


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
        # One GN iteration replayed under the profiler (each of the 15 runs
        # the same CG length here; the profiler's own cost grows with events).
        a, kw = graphs[-1]
        wall, n_launch, dev_us, top = profile_call(lambda: solve(*a, **dict(kw, iters=1)))
        log(f"  one GN iteration of the essential graph replayed under the profiler (the closure ran "
            f"{kw['iters']}): {n_launch} kernel launches, device time {dev_us / 1e3:.3f} ms of "
            f"{wall:.3f} ms wall; most device time:")
        log_top(top)
        if kc not in snaps:
            bad.append(f"closed at keyframe {kc}, before the revisit")
        else:
            m_snap, lc_cpu = snaps[kc]
            # The same keyframe again on the card from the same state, warm
            # (the first closure pays the solvers' first calls).
            lc_warm = lc_cpu.to(device)
            lc_warm.stage_sync = True
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (_, c_warm), sites = count_syncs(lambda: lc_warm.on_keyframe(m_snap, LOOP_CAM, kc,
                                                                         ba_fn=ba._schedule_gba))
            torch.cuda.synchronize()
            warm_ms = (time.perf_counter() - t0) * 1e3
            sw = lc_warm.metrics.timer.samples
            log(f"  the closing keyframe {kc} again on the card from the same state (warm): {warm_ms:.3f} ms, "
                f"{len(sites)} device->host reads, closed {c_warm}; detection "
                f"{sw['loop.detect'][-1] * 1e3:.3f} ms, _compute_sim3 {sw['loop.sim3'][-1] * 1e3:.3f} ms, "
                f"fusion {sw['loop.fuse'][-1] * 1e3:.3f} ms, essential graph "
                f"{sw['loop.essential_graph'][-1] * 1e3:.3f} ms, global BA {sw['loop.global_ba'][-1] * 1e3:.3f} ms")
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


def timed(name: str, fn, *args):
    """fn(*args), with the phase's wall time printed."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
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
    timed("device assert", phase_device_assert)
    args, launches = timed("slice", phase_slice, inp)
    session, (_, late), map_launches, per_frame = timed("map slice", phase_map, scene)

    kt = timed("kernel times", kernel_times, imgs, smi)
    step_ms = cuda_ms(lambda: track_step_batched(CAM, CFG, *args))
    log(f"times on {smi}:")
    log(f"  track_step_batched B={B}: {step_ms:.3f} ms/step, {B * 1000.0 / step_ms:.2f} frames/s")
    timed("map times", map_times, session, late, smi)
    mono_launches = timed("mono SLAM", phase_mono, scene, smi)
    stereo_scene = StepWallScene(np.random.default_rng(5), **STEREO_SCENE)
    sk = timed("stereo kernels", phase_stereo_kernels, stereo_scene, smi)
    stereo = timed("stereo SLAM", phase_stereo, stereo_scene, smi)
    rgbd = timed("RGB-D SLAM", phase_rgbd, smi)
    multi_launches = timed("MultiTracker", phase_multi, stereo_scene, smi)
    timed("place", phase_place, smi)
    timed("loop", phase_loop, smi)
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
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": (launches[name] + map_launches[name] + mono_launches[name]
                      + stereo["launches"][name] + stereo["loc_launches"][name]
                      + rgbd["launches"][name] + multi_launches[name]),
         "launches_per_frame": statistics.median(d[name] for d in per_frame),
         "launches_per_stereo_frame": stereo["per_frame"][name],
         "launches_per_rgbd_frame": rgbd["per_frame"][name],
         "max_abs_err": err[name],
         "ms": main_b["per_call"][name], "plain_ms": main_b["per_call"][name + " plain"],
         "device_ms": main_b["dev"][name],
         "bound_ms": main_b["bounds"][name][0], "bound_by": main_b["bounds"][name][1],
         "library_ms": main_b["per_call"].get(name + " library"),
         "stereo_shapes": shapes}
        for name, (src, rep, shapes) in sources.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
