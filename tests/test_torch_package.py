"""Package-level properties of the PyTorch port: no jax at import, CPU
tensors take the kernels' plain versions, state crosses both ways, and (on
a card) each CUDA kernel equals its plain version.

This module imports no jax at its top (one test imports it inside), so its
card test runs on a machine without it:
    python -m pytest --noconftest tests/test_torch_package.py -m cuda
"""

import ctypes
import inspect
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuslam_torch.convert import (
    array_to_tensor,
    desc_to_numpy,
    features_to_numpy,
    features_to_torch,
    frame_features_to_numpy,
    frame_features_to_torch,
    map_to_numpy,
    map_to_torch,
)
from tpuslam_torch import _build, convert
from tpuslam_torch.examples import (
    ar_demo, mono_euroc, mono_kitti, mono_tum, rgbd_tum, run_synthetic, stereo_euroc, stereo_kitti)
from tpuslam_torch.io import checkpoint, rectify
from tpuslam_torch.mapstate import core as mapcore
from tpuslam_torch.ops import orb as torb
from tpuslam_torch.ops.fast import TILE_H, TILE_W, fast_nms, fast_nms_plain, fast_nms_pyramid, level_table
from tpuslam_torch.ops.orb import ORBConfig, extract_orb_batched
from tpuslam_torch.ops.patches import PSIZE, gather_patches, gather_patches_plain
from tpuslam_torch.parallel import dist_ba, mapping_worker
from tpuslam_torch.pipeline.multi import MultiTracker
from tpuslam_torch.pipeline.system import System
from tpuslam_torch.pipeline.tracker import Tracker

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def test_import_pulls_in_no_jax():
    code = (
        "import sys, pkgutil, importlib, tpuslam_torch\n"
        "for m in pkgutil.walk_packages(tpuslam_torch.__path__, 'tpuslam_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'tpuslam', 'yaml', 'PIL'))\n"
        "assert not bad, bad\n"
        "assert {'tpuslam_torch.mapstate.core', 'tpuslam_torch.pipeline.steps',\n"
        "        'tpuslam_torch.pipeline.tracker', 'tpuslam_torch.pipeline.system',\n"
        "        'tpuslam_torch.sfm.initializer', 'tpuslam_torch.sfm.pnp', 'tpuslam_torch.sfm.sim3solver',\n"
        "        'tpuslam_torch.optim.ba', 'tpuslam_torch.geometry.triangulation',\n"
        "        'tpuslam_torch.utils.metrics', 'tpuslam_torch.ops.stereo',\n"
        "        'tpuslam_torch.pipeline.multi', 'tpuslam_torch.io.settings',\n"
        "        'tpuslam_torch.geometry.sim3', 'tpuslam_torch.place.vocabulary',\n"
        "        'tpuslam_torch.place.database', 'tpuslam_torch.place.evaluate',\n"
        "        'tpuslam_torch.optim.pose_graph', 'tpuslam_torch.pipeline.loop_closing',\n"
        "        'tpuslam_torch.io.checkpoint', 'tpuslam_torch.io.datasets', 'tpuslam_torch.io.rectify',\n"
        "        'tpuslam_torch.io.live', 'tpuslam_torch.io.native', 'tpuslam_torch.viz.render',\n"
        "        'tpuslam_torch.viz.ar', 'tpuslam_torch.viz.server', 'tpuslam_torch.examples._driver',\n"
        "        'tpuslam_torch.examples.run_synthetic', 'tpuslam_torch.examples.mono_tum',\n"
        "        'tpuslam_torch.examples.mono_kitti', 'tpuslam_torch.examples.mono_euroc',\n"
        "        'tpuslam_torch.examples.stereo_kitti', 'tpuslam_torch.examples.stereo_euroc',\n"
        "        'tpuslam_torch.examples.rgbd_tum', 'tpuslam_torch.examples.ar_demo',\n"
        "        'tpuslam_torch.parallel', 'tpuslam_torch.parallel.dist_ba', 'tpuslam_torch.parallel.sharded_map',\n"
        "        'tpuslam_torch.parallel.mapping_worker'} <= set(sys.modules)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_cpu_tensors_take_the_plain_versions(rng):
    fast_nms.launches = 0
    gather_patches.launches = 0
    img = torch.from_numpy(rng.uniform(0, 255, (2, 64, 80)).astype(np.float32))
    assert torch.equal(fast_nms(img, 7.0), fast_nms_plain(img, 7.0))
    atlas = torch.from_numpy(rng.integers(0, 256, (100, 120)).astype(np.uint8))
    corner = torch.tensor([[0, 0], [100 - PSIZE, 120 - PSIZE], [5, 9]], dtype=torch.int32)
    assert torch.equal(gather_patches(atlas, corner), gather_patches_plain(atlas, corner))
    extract_orb_batched(torch.from_numpy(rng.uniform(0, 255, (1, 120, 160)).astype(np.float32)),
                        ORBConfig(n_features=100))
    assert fast_nms.launches == 0 and gather_patches.launches == 0


@pytest.mark.parametrize("fn", [
    convert.array_to_tensor, convert.features_to_torch, convert.pose_obs_to_torch,
    convert.frame_features_to_torch, convert.map_to_torch, convert.ba_problem_to_torch,
    mapcore.make_empty_map, Tracker, System, MultiTracker, checkpoint.load_map,
    rectify.StereoRectifier, run_synthetic.run, mono_tum.run, mono_kitti.run, mono_euroc.run,
    stereo_kitti.run, stereo_euroc.run, rgbd_tum.run, ar_demo.run, dist_ba.make_mesh,
    mapping_worker.RemoteMappingWorker,
])
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


LEVEL_SETS = [
    [(4, 480, 640), (4, 400, 533), (4, 333, 444), (4, 278, 370),
     (4, 231, 309), (4, 193, 257), (4, 161, 214), (4, 134, 179)],
    [(2, 97, 200), (1, 33, 31)],
    [(1, 30, 30), (3, 31, 29), (0, 50, 50), (2, 1, 1)],
]


@pytest.mark.parametrize("shapes", LEVEL_SETS)
def test_level_table_covers_every_tile_once(shapes):
    """Block b of the one launch takes the last level whose first tile is
    <= b (the kernel's search), then a stream and a tile of it: every
    (level, stream, tile) is covered exactly once, and every pixel of every
    level lies in one tile."""
    table, n_tiles = level_table(shapes)
    seen = []
    for b in range(n_tiles):
        l = max(k for k, row in enumerate(table) if b >= row["tile0"])
        row = table[l]
        t = b - row["tile0"]
        s, t = divmod(t, row["tiles_x"] * row["tiles_y"])
        ty, tx = divmod(t, row["tiles_x"])
        assert s < row["B"]
        seen.append((l, s, ty, tx))
    want = [(l, s, ty, tx) for l, row in enumerate(table) for s in range(row["B"])
            for ty in range(row["tiles_y"]) for tx in range(row["tiles_x"])]
    assert sorted(seen) == sorted(want) and len(set(seen)) == len(seen)
    for (B, H, W), row in zip(shapes, table):
        assert (row["tiles_y"] - 1) * TILE_H < H <= row["tiles_y"] * TILE_H
        assert (row["tiles_x"] - 1) * TILE_W < W <= row["tiles_x"] * TILE_W
        assert row["bias_step"] == np.float32(-1e-6 / (H * W))


def test_level_table_rejects_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="at most 8"):
        level_table([(1, 40, 40)] * 9)
    with pytest.raises(ValueError, match="float32-exact"):
        level_table([(1, 4096, 4096)])
    with pytest.raises(ValueError, match="< 0"):
        fast_nms_pyramid([torch.zeros((1, 8, 8))], -1.0)


def test_level_table_struct_matches_the_kernel_abi():
    """csrc/fast_nms.cu's FastLevel is two pointers and eight 4-byte fields
    (48 bytes); FastLevels is 8 of them and two ints (392 bytes)."""
    assert ctypes.sizeof(_build.FastLevel) == 48
    assert _build.FastLevel.B.offset == 16 and _build.FastLevel.bias_step.offset == 40
    assert ctypes.sizeof(_build.FastLevels) == 8 * 48 + 8
    assert _build.FastLevels.n_levels.offset == 384 and _build.FastLevels.n_tiles.offset == 388


def test_pyramid_on_the_cpu_is_the_plain_version_per_level(rng):
    fast_nms.launches = 0
    levels = [torch.from_numpy(rng.uniform(0, 255, s).astype(np.float32))
              for s in [(2, 97, 200), (1, 33, 31), (3, 40, 45)]]
    got = fast_nms_pyramid(levels, 7.0)
    assert len(got) == 3
    for x, g in zip(levels, got):
        assert torch.equal(g, fast_nms_plain(x, 7.0))
    assert fast_nms_pyramid([], 7.0) == [] and fast_nms.launches == 0


def test_detect_scores_every_budgeted_level_in_one_call(rng, monkeypatch):
    """detect_batched hands every level with a budget to one
    fast_nms_pyramid call (one kernel launch per frame on the card)."""
    calls = []

    def spy(levels, min_th):
        calls.append([tuple(x.shape) for x in levels])
        return fast_nms_pyramid(levels, min_th)

    monkeypatch.setattr(torb, "fast_nms_pyramid", spy)
    cfg = ORBConfig(n_features=100)
    torb.detect_batched(torch.from_numpy(rng.uniform(0, 255, (2, 120, 160)).astype(np.float32)), cfg)
    assert len(calls) == 1
    assert len(calls[0]) == sum(n > 0 for n in cfg.level_budgets())
    assert calls[0][0] == (2, 120, 160)


@pytest.mark.parametrize("corner", [[-1, 0], [0, -1], [100 - PSIZE + 1, 0], [0, 120 - PSIZE + 1]])
def test_gather_rejects_windows_outside_the_atlas(corner):
    atlas = torch.zeros((100, 120), dtype=torch.uint8)
    with pytest.raises(ValueError, match="outside"):
        gather_patches(atlas, torch.tensor([corner], dtype=torch.int32))


def test_wrappers_reject_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        fast_nms(torch.zeros((1, 8, 8), device="meta"), 7.0)


def test_descriptor_words_cross_both_ways(rng):
    words = rng.integers(0, 2**32, (5, 8), dtype=np.uint32)
    words[0] = [0, 1, 2**31 - 1, 2**31, 2**32 - 1, 0xDEADBEEF, 0x80000001, 7]
    t = array_to_tensor(words, "cpu")
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(desc_to_numpy(t), words)


def test_features_cross_both_ways(rng):
    f = extract_orb_batched(
        torch.from_numpy(rng.uniform(0, 255, (1, 120, 160)).astype(np.float32)),
        ORBConfig(n_features=100),
    )
    npf = features_to_numpy(f)
    assert npf.desc.dtype == np.uint32
    back = features_to_torch(npf, "cpu")
    for a, b in zip(f, back):
        assert torch.equal(a, b)


def test_map_crosses_both_ways_bit_for_bit():
    """Every field of the JAX package's empty map, through the port and
    back: the uint32 descriptor words, the inf distance bounds and the 0-d
    int32 watermarks included."""
    from tpuslam.mapstate.core import make_empty_map

    ref = make_empty_map(4, 8, 16)
    rng = np.random.default_rng(3)
    ref = ref._replace(kf_kp_desc=rng.integers(0, 2**32, (4, 8, 8), dtype=np.uint32),
                       pt_desc=rng.integers(0, 2**32, (16, 8), dtype=np.uint32))
    t = map_to_torch(ref, "cpu")
    assert t.kf_kp_desc.dtype == torch.int32 and t.n_kf.shape == () and t.n_kf.dtype == torch.int32
    back = map_to_numpy(t)
    for name, a, b in zip(ref._fields, back, ref):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


def test_frame_features_cross_both_ways(rng):
    from tpuslam_torch.mapstate.core import FrameFeatures

    f = FrameFeatures(
        xy=torch.from_numpy(rng.uniform(0, 100, (7, 2)).astype(np.float32)),
        level=torch.arange(7, dtype=torch.int32),
        angle=torch.zeros(7),
        desc=array_to_tensor(rng.integers(0, 2**32, (7, 8), dtype=np.uint32), "cpu"),
        valid=torch.ones(7, dtype=torch.bool),
        u_right=torch.full((7,), -1.0),
        depth=torch.linspace(0, 3, 7),
    )
    npf = frame_features_to_numpy(f)
    assert npf.desc.dtype == np.uint32
    for a, b in zip(f, frame_features_to_torch(npf, "cpu")):
        assert torch.equal(a, b)


def _scatter_inputs(device):
    """Float values with heavily repeated target indices: 200,000 values
    into 5,000 targets, magnitudes over 6 decades."""
    gen = np.random.default_rng(4)
    idx = torch.from_numpy(gen.integers(0, 5000, 200_000)).to(device)
    src = torch.from_numpy((gen.normal(size=(200_000, 6)) * 10.0 ** gen.uniform(-3, 3, (200_000, 1)))
                           .astype(np.float32)).to(device)
    return idx, src


def test_scatter_sum_equals_index_add_on_cpu():
    """The fixed-order scatter-sum adds each target's values in index order,
    as index_add_ does on the CPU: equal within 1e-6 relative (bit-equal
    in fact), and indices outside [0, n) dropped."""
    from tpuslam_torch.pipeline._index import scatter_sum, sum_plan

    idx, src = _scatter_inputs("cpu")
    want = torch.zeros((5000, 6)).index_add_(0, idx, src)
    got = scatter_sum(5000, idx, src)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)
    assert torch.equal(got, want)
    assert torch.equal(scatter_sum(5000, idx, src, sum_plan(idx, 5000)), got)
    out = scatter_sum(3, torch.tensor([0, 3, -1, 2, 0]), torch.ones(5))
    assert out.tolist() == [2.0, 0.0, 1.0]


@pytest.mark.cuda
def test_scatter_sum_is_bit_repeatable_on_card():
    """On the card the fixed-order scatter-sum gives the same bits on every
    run (index_add_'s atomics do not), and matches the CPU's within 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tpuslam_torch.pipeline._index import scatter_sum

    idx, src = _scatter_inputs("cuda")
    runs = [scatter_sum(5000, idx, src) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    cpu = scatter_sum(5000, idx.cpu(), src.cpu())
    torch.testing.assert_close(runs[0].cpu(), cpu, rtol=1e-6, atol=1e-6 * float(cpu.abs().max()))


@pytest.mark.cuda
def test_mono_session_repeats_on_card():
    """The 14-frame monocular session of the test below, twice on the card
    from the same seed: the same keyframes, and every pose and point the
    same to the bit (no float sum on the path changes its order between
    runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tpuslam_torch.geometry.camera import PinholeCamera
    from tpuslam_torch.testing import StepWallScene, mono_session, orbit_trajectory, render_frames

    cam = PinholeCamera(fx=350.0, fy=350.0, cx=160.0, cy=120.0, width=320, height=240)
    frames = render_frames(StepWallScene(np.random.default_rng(11)), cam, orbit_trajectory(14, step=0.045))
    runs = []
    for _ in range(2):
        system = System(cam, orb=ORBConfig(n_features=500), device="cuda", max_keyframes=16,
                        max_points=4096, kf_max_frames=10, enable_loop_closing=False)
        mono_session(system, [f.cuda() for f in frames])
        runs.append(system.tracker)
    a, b = runs
    assert a._n_kf_host == b._n_kf_host
    for name in ("kf_R", "kf_t", "kf_obs_pt", "pt_xyz", "pt_valid", "pt_normal"):
        assert torch.equal(getattr(a.map, name), getattr(b.map, name)), name
    for (fa, ra, Ra, ta, la), (fb, rb, Rb, tb, lb) in zip(a.trajectory, b.trajectory):
        assert (fa, ra, la) == (fb, rb, lb) and np.array_equal(Ra, Rb) and np.array_equal(ta, tb)


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """Both CUDA kernels against their plain versions on the card, at ragged
    and main-path shapes, with windows at the atlas edges."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = np.random.default_rng(0)
    for shape in [(4, 480, 640), (2, 97, 200), (1, 33, 31)]:
        img = gen.uniform(0, 255, shape).astype(np.float32)
        img[:, 10:20, 10:20] = 255.0  # a plateau: NMS ties
        x = torch.from_numpy(img).cuda()
        got = fast_nms(x, 7.0)
        torch.cuda.synchronize()
        assert torch.equal(got, fast_nms_plain(x, 7.0))
    # A pitch of 16-byte multiples and one that shifts every row's alignment;
    # 5 and 4001 windows, so the last block of 4 is ragged.
    for Ha, Wa in ((300, 400), (300, 403)):
        edges = [(0, 0), (Ha - PSIZE, Wa - PSIZE), (0, Wa - PSIZE), (Ha - PSIZE, 0), (17, 301)]
        many = np.stack([gen.integers(0, Ha - PSIZE + 1, 3996), gen.integers(0, Wa - PSIZE + 1, 3996)], -1)
        for corners in (edges, np.concatenate([edges, many])):
            corner = torch.tensor(np.asarray(corners), dtype=torch.int32, device="cuda")
            for dtype in (torch.uint8, torch.float32):
                atlas = torch.from_numpy(gen.integers(0, 256, (Ha, Wa))).to("cuda", dtype)
                got = gather_patches(atlas, corner)
                torch.cuda.synchronize()
                assert torch.equal(got, gather_patches_plain(atlas, corner)), (Ha, Wa, len(corners), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("shapes", LEVEL_SETS[1:] + [[(1, 480, 640), (2, 400, 533), (1, 134, 179)]])
def test_fast_nms_pyramid_matches_plain_on_card(shapes):
    """One launch over ragged level sets, each level equal to its plain
    version, with plateaus (NMS ties) on the larger levels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = np.random.default_rng(1)
    levels = []
    for shape in shapes:
        img = gen.uniform(0, 255, shape).astype(np.float32)
        img[:, 10:20, 10:20] = 255.0
        levels.append(torch.from_numpy(img).cuda())
    fast_nms.launches = 0
    got = fast_nms_pyramid(levels, 7.0)
    torch.cuda.synchronize()
    assert fast_nms.launches == 1
    for x, g in zip(levels, got):
        assert torch.equal(g, fast_nms_plain(x, 7.0)), tuple(x.shape)


@pytest.mark.cuda
def test_gather_window_outside_the_atlas_fails_the_device_assert():
    """On the card the wrapper reads nothing back: a window past the atlas
    fails the kernel's device-side assert. A child process takes the dead
    CUDA context."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    code = (
        "import torch\n"
        "from tpuslam_torch.ops.patches import gather_patches\n"
        "atlas = torch.zeros((100, 120), dtype=torch.uint8, device='cuda')\n"
        "corner = torch.tensor([[0, 0], [100 - 46, 0]], dtype=torch.int32, device='cuda')\n"
        "gather_patches(atlas, corner)\n"
        "torch.cuda.synchronize()\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert "device-side assert" in out.stderr, out.stderr[-2000:]


def _ba_problem(gen, device, K=6, P=150):
    """A perturbed bundle-adjustment problem in numpy: K keyframes in an arc
    over P points, keyframe 0 fixed."""
    from tpuslam_torch.geometry.camera import PinholeCamera, project
    from tpuslam_torch.geometry.se3 import so3_exp
    from tpuslam_torch.optim.ba import BAProblem

    cam = PinholeCamera(fx=500.0, fy=500.0, cx=320.0, cy=240.0)
    X = np.stack([gen.uniform(-3, 3, P), gen.uniform(-2, 2, P), gen.uniform(5, 12, P)], -1).astype(np.float32)
    R = so3_exp(torch.tensor([[0.0, -0.04 * k, 0.0] for k in range(K)]))
    t = torch.tensor([[-0.3 * k, 0.0, 0.0] for k in range(K)])
    uv = project(cam, torch.einsum("kij,pj->kpi", R, torch.from_numpy(X)) + t[:, None])
    kf = torch.arange(K).repeat_interleave(P)
    pt = torch.arange(P).repeat(K)
    uvr = torch.cat([uv.reshape(-1, 2) + torch.from_numpy(gen.normal(size=(K * P, 2)).astype(np.float32)) * 0.3,
                     -torch.ones(K * P, 1)], -1)
    prob = BAProblem(R=R, t=t + torch.from_numpy(gen.normal(size=(K, 3)).astype(np.float32)) * 0.05 * (torch.arange(K) > 0)[:, None],
                     X=torch.from_numpy(X + gen.normal(size=X.shape).astype(np.float32) * 0.1),
                     kf=kf.int(), pt=pt.int(), uvr=uvr, inv_sigma2=torch.ones(K * P),
                     valid=torch.from_numpy(gen.uniform(size=K * P) > 0.1), fixed_kf=torch.arange(K) == 0,
                     fixed_pt=torch.zeros(P, dtype=torch.bool))
    return cam, BAProblem(*(x.to(device) for x in prob))


@pytest.mark.cuda
def test_bundle_adjusters_on_card_match_cpu():
    """Both solvers on the card against the CPU: float sums in another order
    (atomics), so poses within 1e-3 and points within 1e-2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tpuslam_torch.optim.ba import bundle_adjustment, dense_schur_bundle_adjustment

    cam, prob = _ba_problem(np.random.default_rng(0), "cpu")
    _, gprob = _ba_problem(np.random.default_rng(0), "cuda")
    active = torch.tensor([1, 2, 3, 4, 5, -1])
    for solve in (lambda p: bundle_adjustment(cam, p, iters=10),
                  lambda p: dense_schur_bundle_adjustment(cam, p, active.to(p.X.device), iters=10)):
        ref, got = solve(prob), solve(gprob)
        for a, b, tol in zip(got[:3], ref[:3], (1e-3, 1e-3, 1e-2)):
            torch.testing.assert_close(a.cpu(), b, rtol=0, atol=tol)


@pytest.mark.cuda
def test_mono_session_on_card_matches_cpu():
    """The monocular System on the card and on the CPU over the same 14
    rendered frames (320x240, 500 features, small map), RANSAC drawn from
    the same seed: the same frames tracked from the same initialization
    frame, both kernels once on every frame (and once more in the warm-up
    run before the capture of the graph that holds them), keyframe counts
    within one (float sums in another order can tip a keyframe decision),
    and both trajectories within 3 cm of the truth after Sim3 alignment."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tpuslam_torch.geometry.camera import PinholeCamera
    from tpuslam_torch.testing import (
        StepWallScene,
        mono_session,
        orbit_trajectory,
        render_frames,
        trajectory_ate,
    )

    cam = PinholeCamera(fx=350.0, fy=350.0, cx=160.0, cy=120.0, width=320, height=240)
    scene = StepWallScene(np.random.default_rng(11))
    poses = orbit_trajectory(14, step=0.045)
    frames = render_frames(scene, cam, poses)
    runs = {}
    for device in ("cpu", "cuda"):
        system = System(cam, orb=ORBConfig(n_features=500), device=device, max_keyframes=16,
                        max_points=4096, kf_max_frames=10, enable_loop_closing=False)
        fast_nms.launches = gather_patches.launches = 0
        res = mono_session(system, [f.to(device) for f in frames])
        runs[device] = (system, [out is not None for out, _ in res], fast_nms.launches, gather_patches.launches)
    (cs, c_ok, *_), (gs, g_ok, g_fast, g_gather) = runs["cpu"], runs["cuda"]
    assert c_ok == g_ok and g_ok.index(True) < 6 and g_ok[-1]
    warm = {k: sum(c["launches"][k] for c in gs.tracker.graphs.captured)
            for k in ("fast_nms", "gather_patches")}
    assert warm == {"fast_nms": 1, "gather_patches": 1}
    assert (g_fast, g_gather) == (14 + warm["fast_nms"], 14 + warm["gather_patches"])
    assert abs(gs.tracker._n_kf_host - cs.tracker._n_kf_host) <= 1 and gs.tracker._n_kf_host >= 5
    for s in (cs, gs):
        ate, n, _ = trajectory_ate(s.tracker.export_trajectory(), poses)
        assert n == sum(c_ok) and ate < 0.03


KITTI_CAM = dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, bf=386.1448, width=1241, height=376)


def _kitti_pair(device):
    """A stereo pair at KITTI00-02.yaml's size, rendered on `device`, and
    its camera."""
    from tpuslam_torch.geometry.camera import PinholeCamera
    from tpuslam_torch.testing import StepWallScene, orbit_trajectory, render_stereo_frames

    cam = PinholeCamera(**KITTI_CAM)
    scene = StepWallScene(np.random.default_rng(5))
    (L, R), = render_stereo_frames(scene, cam, orbit_trajectory(1), device=device)
    return cam, L, R


@pytest.mark.cuda
def test_kernels_at_the_stereo_shapes_match_plain_on_card():
    """FAST+NMS over the 8 levels of a (2, 376, 1241) batch in one launch,
    and the gather on its 1257-byte-wide atlas at the describe windows and
    at the SAD windows, each equal to its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tpuslam_torch.ops.image import build_pyramid, pyramid_shapes
    from tpuslam_torch.ops.orb import ORBFeatures, extract_orb_batched_atlas
    from tpuslam_torch.ops.stereo import level_tables, row_band_match, sad_windows

    cfg = ORBConfig(n_features=2000)
    cam, L, R = _kitti_pair("cuda")
    imgs = torch.stack([L, R])
    levels = build_pyramid(imgs, 8, 1.2)
    fast_nms.launches = 0
    got = fast_nms_pyramid(levels, cfg.min_th_fast)
    torch.cuda.synchronize()
    assert fast_nms.launches == 1
    for x, g in zip(levels, got):
        assert torch.equal(g, fast_nms_plain(x, cfg.min_th_fast)), tuple(x.shape)
    *_, atlas, corner = torb.detect_batched(imgs, cfg)
    assert atlas.shape[1] == 1257
    fb, _ = extract_orb_batched_atlas(imgs, cfg)
    fL, fR = (ORBFeatures(*(x[b] for x in fb)) for b in (0, 1))
    tabs = level_tables(tuple(pyramid_shapes(376, 1241, 8, 1.2)), 1.2, atlas.device)
    i1, _ = row_band_match(fL, fR, tabs, cam.fx)
    sad_corner = sad_windows(tabs, 0, atlas.shape[0] // 2, fL.level, fL.xy[:, 0], fL.xy[:, 1],
                             fR.xy[i1, 0])[0]
    for c in (corner, sad_corner):
        g = gather_patches(atlas, c)
        torch.cuda.synchronize()
        assert torch.equal(g, gather_patches_plain(atlas, c)), tuple(c.shape)


@pytest.mark.cuda
def test_stereo_front_end_on_card_matches_cpu():
    """stereo_frame_features at 1241x376 and 2000 features on the card and
    the CPU: the same keypoints, the stereo verdict equal on >= 99.5% of
    them, u_right within 1e-3 px where both match; and stereo_match on the
    same features with tied Hamming minima picks the same right keypoints
    (the lowest index) on both."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tpuslam_torch.ops.image import build_pyramid
    from tpuslam_torch.ops.orb import ORBFeatures
    from tpuslam_torch.ops.stereo import stereo_match
    from tpuslam_torch.pipeline.steps import stereo_frame_features

    cfg = ORBConfig(n_features=2000)
    cam, L, R = _kitti_pair("cpu")
    g = stereo_frame_features(L.cuda(), R.cuda(), cfg, cam.fx, cam.bf)
    c = stereo_frame_features(L, R, cfg, cam.fx, cam.bf)
    assert torch.equal(g.xy.cpu(), c.xy) and torch.equal(g.valid.cpu(), c.valid)
    gv, cv = g.u_right.cpu() >= 0, c.u_right >= 0
    assert (gv == cv)[c.valid].float().mean() >= 0.995
    both = gv & cv
    assert int(both.sum()) > 500 and float((g.u_right.cpu() - c.u_right)[both].abs().max()) < 1e-3

    fb = extract_orb_batched(torch.stack([L, R]), cfg)
    fL, fR = (ORBFeatures(*(x[b] for x in fb)) for b in (0, 1))
    src = torch.arange(fR.xy.shape[0])
    src = torch.where(src % 3 == 2, src - 1, src)  # duplicated right descriptors: ties
    xy = fR.xy.clone()
    xy[:, 1] = fR.xy[src, 1]
    fR = fR._replace(xy=xy, desc=fR.desc[src], level=fR.level[src], valid=fR.valid[src])
    pL, pR = build_pyramid(L, 8, 1.2), build_pyramid(R, 8, 1.2)
    ref = stereo_match(fL, fR, pL, pR, cfg, cam.fx, cam.bf)
    got = stereo_match(ORBFeatures(*(x.cuda() for x in fL)), ORBFeatures(*(x.cuda() for x in fR)),
                       [x.cuda() for x in pL], [x.cuda() for x in pR], cfg, cam.fx, cam.bf)
    assert torch.equal(got[2].cpu(), ref[2])
    torch.testing.assert_close(got[0].cpu(), ref[0], rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("sensor", ["STEREO", "RGBD"])
def test_depth_session_on_card_matches_cpu(sensor):
    """A 12-frame stereo or RGB-D System at 320x240 and 500 features on the
    card and on the CPU: every frame tracked on both, initialized on the
    first, both kernels on every frame (and once more in the warm-up run
    before the capture of the front end's graph), both rigid ATEs below
    5 cm."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tpuslam_torch.geometry.camera import PinholeCamera
    from tpuslam_torch.pipeline.system import SensorType
    from tpuslam_torch.testing import (
        StepWallScene,
        depth_session,
        orbit_trajectory,
        render_rgbd_frames,
        render_stereo_frames,
        trajectory_ate,
    )

    cam = PinholeCamera(fx=350.0, fy=350.0, cx=160.0, cy=120.0, bf=42.0, width=320, height=240)
    scene = StepWallScene(np.random.default_rng(5))
    poses = orbit_trajectory(12, step=0.05)
    render = render_stereo_frames if sensor == "STEREO" else render_rgbd_frames
    frames = render(scene, cam, poses)
    for device in ("cpu", "cuda"):
        system = System(cam, SensorType[sensor], orb=ORBConfig(n_features=500), device=device,
                        max_keyframes=16, max_points=4096, kf_max_frames=8, enable_loop_closing=False,
                        depth_map_factor=1.0 if sensor == "STEREO" else 1 / 5000)
        fast_nms.launches = gather_patches.launches = 0
        res = depth_session(system, [tuple(x.to(device) if torch.is_tensor(x) else x for x in f)
                                     for f in frames])
        assert all(out is not None for out, _ in res), device
        ate, n, _ = trajectory_ate(system.tracker.export_trajectory(), poses, fix_scale=True)
        assert n == 12 and ate < 0.05, (device, ate)
        if device == "cuda":
            per_frame = {"fast_nms": 1, "gather_patches": 2 if sensor == "STEREO" else 1}
            warm = {k: sum(c["launches"][k] for c in system.tracker.graphs.captured) for k in per_frame}
            assert warm == per_frame
            assert fast_nms.launches == 13 * per_frame["fast_nms"]
            assert gather_patches.launches == 13 * per_frame["gather_patches"]


def test_facade_entry_points_run_on_their_inputs_device(rng):
    """detect_plane, remap_bilinear and topdown_layout take no device: they
    run where their inputs are (here the CPU)."""
    from tpuslam_torch.viz.ar import detect_plane
    from tpuslam_torch.viz.render import topdown_layout

    pts = torch.from_numpy(rng.normal(size=(80, 3)).astype(np.float32))
    fit = detect_plane(pts, torch.ones(80, dtype=torch.bool), np.zeros(3),
                       generator=torch.Generator().manual_seed(0))
    assert all(x.device.type == "cpu" for x in fit)
    img = torch.from_numpy(rng.uniform(0, 255, (6, 8)).astype(np.float32))
    grid = torch.meshgrid(torch.arange(6.0), torch.arange(8.0), indexing="ij")
    assert rectify.remap_bilinear(img, grid[1], grid[0]).device.type == "cpu"
    lay = topdown_layout(mapcore.make_empty_map(4, 8, 16, "cpu"))
    assert all(x.device.type == "cpu" for x in lay)


@pytest.mark.cuda
def test_native_build_works_under_noconftest(tmp_path, monkeypatch):
    """The host library compiles from the package's sources with g++ and
    zlib into a fresh build directory, and its PNG decoder reads back what
    testing.png_bytes (no PIL) wrote."""
    if not torch.cuda.is_available():
        pytest.skip("runs with the card tests: the card machine's toolchain")
    from tpuslam_torch.io.datasets import load_grayscale
    from tpuslam_torch.testing import png_bytes

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    info = _build.build_host()
    assert info["path"].startswith(str(tmp_path)) and info["seconds"] > 0
    monkeypatch.undo()
    gen = np.random.default_rng(0)
    for a in (gen.integers(0, 256, (30, 40), dtype=np.uint8), gen.integers(0, 65536, (30, 40)).astype(np.uint16)):
        p = tmp_path / "x.png"
        p.write_bytes(png_bytes(a))
        np.testing.assert_array_equal(load_grayscale(str(p)), a.astype(np.float32))


@pytest.mark.cuda
def test_loaded_map_localizes_on_card_as_on_cpu(tmp_path):
    """A 14-frame stereo map (320x240, 400 features) saved on the card, then
    loaded into a card System and a CPU System: both relocalize frame 7 by
    brute force with the same picks (one seeded generator each), within
    1 cm and 0.1 deg of each other, and the card's map does not change."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tpuslam_torch.geometry.camera import PinholeCamera
    from tpuslam_torch.pipeline.system import SensorType
    from tpuslam_torch.testing import StepWallScene, depth_session, orbit_trajectory, render_stereo_frames

    cam = PinholeCamera(fx=350.0, fy=350.0, cx=160.0, cy=120.0, bf=42.0, width=320, height=240)
    frames = render_stereo_frames(StepWallScene(np.random.default_rng(5)), cam, orbit_trajectory(14, step=0.05))
    kw = dict(orb=ORBConfig(n_features=400), max_keyframes=20, max_points=5000)
    build = System(cam, SensorType.STEREO, device="cuda", kf_max_frames=6, **kw)
    depth_session(build, [(L.cuda(), R.cuda()) for L, R in frames])
    path = str(tmp_path / "map.npz")
    build.save_map(path)
    poses = {}
    for device in ("cpu", "cuda"):
        system = System(cam, SensorType.STEREO, device=device, **kw)
        system.load_map(path)
        before = map_to_numpy(system.tracker.map)
        L, R = frames[7]
        poses[device] = system.track_stereo(L.to(device), R.to(device), 99.0)
        assert poses[device] is not None and system.tracker.reloc_path == "brute_force", device
        for name, a, b in zip(before._fields, map_to_numpy(system.tracker.map), before):
            assert a.tobytes() == b.tobytes(), (device, name)
    (Rc, tc), (Rg, tg) = poses["cpu"], poses["cuda"]
    assert np.linalg.norm(-Rc.T @ tc + Rg.T @ tg) < 0.01
    d = Rc.astype(np.float64).T @ Rg.astype(np.float64)
    assert np.degrees(np.arcsin(min(1.0, np.linalg.norm([d[2, 1] - d[1, 2], d[0, 2] - d[2, 0],
                                                           d[1, 0] - d[0, 1]]) / 2))) < 0.1


def test_torch_trace_writes_a_chrome_trace(tmp_path):
    """torch_trace (jax_trace's counterpart) writes the block's profile as
    a Chrome trace into its directory, and the profiler stays readable.
    With a recorder, it traces during the block, and the block's spans are
    in the same file on the profiler's timeline: the span's slice encloses
    the product's."""
    import json

    from tpuslam_torch.utils.metrics import Metrics, torch_trace

    met = Metrics()
    with torch_trace(str(tmp_path / "trace"), metrics=met) as prof:
        with met.trace("product"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert not met.tracing
    assert prof.trace_path.startswith(str(tmp_path / "trace"))
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    mm = [e for e in events if e.get("name") == "aten::mm" and e.get("ph") == "X"]
    assert mm
    (span,) = [e for e in events if e.get("cat") == "span"]
    assert span["name"] == "product"
    for e in mm:
        assert span["ts"] <= e["ts"] and e["ts"] + e["dur"] <= span["ts"] + span["dur"]
    assert any("mm" in e.key for e in prof.key_averages())


@pytest.mark.cuda
def test_async_mono_session_on_card_under_the_stream_sanitizer():
    """The 14-frame monocular session with mapping on the background thread
    and its own stream, on the card, in a child process under PyTorch's
    CUDA stream sanitizer (TORCH_CUDA_SANITIZER=1, set before torch is
    imported): no unsynchronized access between the tracking, mapping and
    global-BA streams, and the session's accuracy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    code = (
        "import numpy as np, torch\n"
        "from tpuslam_torch.geometry.camera import PinholeCamera\n"
        "from tpuslam_torch.ops.orb import ORBConfig\n"
        "from tpuslam_torch.pipeline.system import System\n"
        "from tpuslam_torch.testing import StepWallScene, mono_session, orbit_trajectory, render_frames, trajectory_ate\n"
        "cam = PinholeCamera(fx=350.0, fy=350.0, cx=160.0, cy=120.0, width=320, height=240)\n"
        "poses = orbit_trajectory(14, step=0.045)\n"
        "frames = render_frames(StepWallScene(np.random.default_rng(11)), cam, poses, device='cuda')\n"
        "system = System(cam, orb=ORBConfig(n_features=500), device='cuda', max_keyframes=16, max_points=4096,\n"
        "                kf_max_frames=10, async_mapping=True)\n"
        "res = mono_session(system, frames)\n"
        "tr = system.tracker\n"
        "ate, n, _ = trajectory_ate(tr.export_trajectory(), poses)\n"
        "jobs = len(tr.metrics.timer.samples['map.job'])\n"
        "system.shutdown()\n"
        "torch.cuda.synchronize()\n"
        "from torch.cuda._sanitizer import cuda_sanitizer\n"
        "assert cuda_sanitizer is not None and cuda_sanitizer.enabled, 'the sanitizer is not on'\n"
        "print('session', tr.state.name, n, ate, jobs, tr.metrics.counters['frames.keyframe'])\n"
    )
    env = dict(os.environ, TORCH_CUDA_SANITIZER="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=1500, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "CSAN" not in out.stderr and "data race" not in out.stderr.lower(), out.stderr[-4000:]
    _, state, n, ate, jobs, kfs = out.stdout.split()[-6:]
    assert state == "OK" and int(n) >= 8 and float(ate) < 0.03 and int(jobs) == int(kfs) >= 1, out.stdout


@pytest.mark.cuda
def test_sharded_solvers_on_card_match_cpu():
    """Both sharded solvers with 2 shards on the card (the first two cards,
    or the one card twice): against the single-device solver on the card
    at tests/test_dist_ba.py's tolerances (R 1e-4, t and X 1e-3), and
    against the same solver with 2 shards of the CPU at
    test_bundle_adjusters_on_card_match_cpu's (poses 1e-3, points 1e-2:
    the card's sums come in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tpuslam_torch.optim.ba import bundle_adjustment
    from tpuslam_torch.testing import synthetic_ba_problem

    mesh = dist_ba.make_mesh(2) if torch.cuda.device_count() >= 2 else [torch.device("cuda", 0)] * 2
    cam, prob = synthetic_ba_problem(np.random.default_rng(0), K=6, P=128, n_obs_per_kf=64)
    gprob = type(prob)(*(x.cuda() for x in prob))
    single = bundle_adjustment(cam, gprob, iters=4, cg_iters=20)
    for solve in (dist_ba.point_sharded_bundle_adjustment, dist_ba.distributed_bundle_adjustment):
        ref = solve(cam, prob, ["cpu"] * 2, iters=4, cg_iters=20)
        got = solve(cam, gprob, mesh, iters=4, cg_iters=20)
        for a, b, c, tol, tol_cpu in zip(got[:3], single[:3], ref[:3], (1e-4, 1e-3, 1e-3), (1e-3, 1e-3, 1e-2)):
            assert a.device.type == "cuda"
            torch.testing.assert_close(a, b, rtol=0, atol=tol)
            torch.testing.assert_close(a.cpu(), c, rtol=0, atol=tol_cpu)


@pytest.mark.cuda
def test_mapping_process_job_on_card_equals_the_job_in_process():
    """The first keyframe job of a 14-frame stereo session on the card, run
    by a worker process on the card and by a fresh tracker in process on
    the card: the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses

    from tpuslam_torch.geometry.camera import PinholeCamera
    from tpuslam_torch.pipeline.system import SensorType
    from tpuslam_torch.testing import StepWallScene, depth_session, keep_mapping_inputs, orbit_trajectory, render_stereo_frames

    cam = PinholeCamera(fx=350.0, fy=350.0, cx=160.0, cy=120.0, bf=42.0, width=320, height=240)
    frames = render_stereo_frames(StepWallScene(np.random.default_rng(5)), cam, orbit_trajectory(14, step=0.05),
                                  device="cuda")
    system = System(cam, SensorType.STEREO, orb=ORBConfig(n_features=400), device="cuda", max_keyframes=20,
                    max_points=5000, kf_max_frames=6)
    kept = keep_mapping_inputs(system.tracker, jobs={0})
    depth_session(system, frames)
    m, ki = kept[0]
    cfg = dataclasses.replace(system.tracker.cfg, mapping_process=False)
    ref = Tracker(cfg, device="cuda")
    ref._depth_mode = True
    want = ref._mapping_compute(m, ki)
    worker = mapping_worker.RemoteMappingWorker(cfg, device="cuda")
    try:
        got, _, rows, voc = worker.process(m, ki, True)
    finally:
        worker.close()
    assert worker.info["device"].startswith("cuda") and worker.info["foreign_modules"] == []
    assert rows and voc is not None
    for name, a, b in zip(want._fields, got, want):
        assert torch.equal(a, b), name
