"""optim/pose.py's wrapper and its CUDA kernel (csrc/pose_lm.cu).

On the CPU: the wrapper is the plain version bit for bit, with and without
batch dims; it refuses what the kernel cannot take before any launch; each
C entry point's argument list matches its ctypes signature in
_build._SIGNATURES; the graphs count the kernel's launches.

On a card (`cuda`): the kernel against pose_optimization_plain on the same
card tensors at the frame step's shapes (B=1 N=4000 stereo and mono edges,
B=4 N=2000 mono), all-mono, no valid edge, edges at |z| ~ 1e-7, edges past
the kernel's shared-memory bound. Poses agree within 1e-4 (float32 sums in
another order, the plain path's own card-against-CPU class); inlier masks are
equal but on edges whose final chi2 lies within a relative 1e-4 of its
threshold. Ten calls repeat to the bit, a CUDA graph replay equals the eager
call, and the launch counter counts launches and replays.

This module imports no jax, so its card tests run on a machine without it:
    python -m pytest --noconftest tests/test_torch_pose_kernel.py -m cuda
"""

import ctypes
import re
from pathlib import Path

import pytest
import torch

from tpuslam_torch import _build
from tpuslam_torch.geometry.camera import PinholeCamera
from tpuslam_torch.optim.pose import PoseObs, pose_optimization, pose_optimization_plain
from tpuslam_torch.pipeline import graphs
from tpuslam_torch.testing import pose_disagreement, pose_problem

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
# ORB-SLAM2's KITTI00-02.yaml: the benchmark's camera.
CAM = PinholeCamera(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, bf=386.1448,
                    width=1241, height=376)


def make_problem(seed: int, batch=(), n: int = 400, **opts):
    return pose_problem(CAM, seed, batch, n, **opts)


def _on(obs: PoseObs, dev) -> PoseObs:
    return PoseObs(*(x.to(dev) for x in obs))


# -- CPU ---------------------------------------------------------------------


@pytest.mark.parametrize("batch", [(), (3,), (2, 2)])
def test_cpu_wrapper_is_the_plain_version(batch):
    before = pose_optimization.launches
    R0, t0, obs = make_problem(1, batch, n=300)
    got = pose_optimization(CAM, R0, t0, obs)
    ref = pose_optimization_plain(CAM, R0, t0, obs)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype
        assert torch.equal(g, r)
    assert pose_optimization.launches == before


def test_cpu_plain_version_converges():
    """The test problems are sound: the plain version lands near the truth
    and keeps the inliers (the card tests compare the kernel with it)."""
    R0, t0, obs = make_problem(2, (2,), n=600)
    R, t, inl, n = pose_optimization_plain(CAM, R0, t0, obs)
    assert torch.equal(n, inl.sum(-1))
    assert (n > 0.6 * 600).all()
    assert torch.isfinite(R).all() and torch.isfinite(t).all()


@pytest.mark.parametrize("field", ["R0", "t0", "pts_w", "uvr", "inv_sigma2"])
def test_wrapper_rejects_float64(field):
    before = pose_optimization.launches
    R0, t0, obs = make_problem(3, (), n=50)
    args = {"R0": R0, "t0": t0, **obs._asdict()}
    args[field] = args[field].double()
    with pytest.raises(ValueError, match="float32"):
        pose_optimization(CAM, args.pop("R0"), args.pop("t0"), PoseObs(**args))
    assert pose_optimization.launches == before


@pytest.mark.parametrize("field", ["t0", "pts_w", "valid"])
def test_wrapper_rejects_mixed_devices(field):
    before = pose_optimization.launches
    R0, t0, obs = make_problem(4, (), n=50)
    args = {"R0": R0, "t0": t0, **obs._asdict()}
    args[field] = args[field].to("meta")
    with pytest.raises(ValueError, match="meta"):
        pose_optimization(CAM, args.pop("R0"), args.pop("t0"), PoseObs(**args))
    assert pose_optimization.launches == before


def test_wrapper_rejects_other_shapes_and_layouts():
    R0, t0, obs = make_problem(5, (2,), n=50)
    with pytest.raises(ValueError, match="want"):
        pose_optimization(CAM, R0[0], t0[0], obs)  # batch dims differ
    with pytest.raises(ValueError, match="want"):
        pose_optimization(CAM, R0, t0, obs._replace(valid=obs.valid[:, :40].contiguous()))
    with pytest.raises(ValueError, match="contiguous"):
        pose_optimization(CAM, R0.transpose(-1, -2), t0, obs)
    with pytest.raises(ValueError, match="bool"):
        pose_optimization(CAM, R0, t0, obs._replace(valid=obs.valid.to(torch.uint8)))
    with pytest.raises(ValueError, match="rounds"):
        pose_optimization(CAM, R0, t0, obs, rounds=-1)


def test_wrapper_runs_the_plain_version_on_meta_tensors():
    """The segment tests trace the frame step on meta tensors."""
    R0, t0, obs = make_problem(6, (2,), n=50)
    R, t, inl, n = pose_optimization(CAM, R0.to("meta"), t0.to("meta"), _on(obs, "meta"))
    assert R.shape == (2, 3, 3) and inl.shape == (2, 50) and n.shape == (2,)
    assert all(x.device.type == "meta" for x in (R, t, inl, n))


def _c_entry_points() -> dict:
    """Every `extern "C" int tpuslam_*(...)` of csrc/*.cu: {name: [kind of
    each argument: "pointer", "int" or "float"]}."""
    found = {}
    for src in sorted((ROOT / "tpuslam_torch" / "csrc").glob("*.cu")):
        for name, params in re.findall(r'extern "C" int (tpuslam_\w+)\(([^)]*)\)', src.read_text()):
            found[name] = ["pointer" if "*" in p else p.split()[-2] for p in params.split(",")]
    return found


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_signatures_match_the_kernels_c_arguments(name):
    """Each ctypes signature has the C function's arity, with a pointer type
    for each pointer and c_int / c_float for each int / float (a pointer
    passed as c_int would be cut to 32 bits)."""
    params = _c_entry_points()[name]
    sig = _build._SIGNATURES[name]
    assert len(sig) == len(params), (params, sig)
    for kind, py_type in zip(params, sig):
        if kind == "pointer":
            assert py_type is ctypes.c_void_p or issubclass(py_type, ctypes._Pointer), (kind, py_type)
        else:
            assert py_type is {"int": ctypes.c_int, "float": ctypes.c_float}[kind], (kind, py_type)


def test_graphs_count_the_pose_kernel():
    assert pose_optimization in graphs._COUNTERS
    assert "pose_optimization" in graphs.StepGraphs("cpu").replayed_launches


# -- card --------------------------------------------------------------------

# (name, batch, n, problem options): the frame step's shapes, then the edges.
CARD_CASES = [
    ("stereo_b1_n4000", (), 4000, {}),
    ("mono_b4_n2000", (4,), 2000, dict(stereo_share=0.0)),
    ("mono_b1_n2000", (), 2000, dict(stereo_share=0.0)),
    ("no_valid_edge", (2,), 500, dict(valid_share=0.0)),
    ("tiny_z", (), 1000, dict(tiny_z=3)),
    ("past_shared_memory", (2,), 9000, {}),
    ("no_edge", (3,), 0, {}),
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _agree(got, ref, obs) -> None:
    d = pose_disagreement(CAM, got, ref, obs)
    assert d["dR"] <= 1e-4 and d["dt"] <= 1e-4, d
    assert d["counts_match"] and d["mask_differs_far"] == 0, d


@pytest.mark.cuda
@pytest.mark.parametrize("name,batch,n,opts", CARD_CASES, ids=[c[0] for c in CARD_CASES])
def test_kernel_matches_plain_on_card(name, batch, n, opts):
    dev = _card()
    R0, t0, obs = make_problem(7, batch, n=n, **opts)
    R0, t0, obs = R0.to(dev), t0.to(dev), _on(obs, dev)
    before = pose_optimization.launches
    got = pose_optimization(CAM, R0, t0, obs)
    torch.cuda.synchronize()
    assert pose_optimization.launches == before + 1
    ref = pose_optimization_plain(CAM, R0, t0, obs)
    assert all(g.shape == r.shape and g.dtype == r.dtype for g, r in zip(got, ref))
    _agree(got, ref, obs)
    if name == "no_valid_edge":
        assert not got[2].any() and (got[3] == 0).all()


@pytest.mark.cuda
def test_kernel_repeats_to_the_bit_on_card():
    dev = _card()
    R0, t0, obs = make_problem(8, (), n=4000)
    R0, t0, obs = R0.to(dev), t0.to(dev), _on(obs, dev)
    first = pose_optimization(CAM, R0, t0, obs)
    for _ in range(9):
        again = pose_optimization(CAM, R0, t0, obs)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_kernel_in_a_graph_equals_the_eager_call_and_counts_replays():
    """Through a StepGraphs: the warm-up launches, the capture records one
    kernel node and launches nothing, each replay adds its launch to the
    counter; every replay's output equals the eager call's."""
    dev = _card()
    R0, t0, obs = make_problem(9, (4,), n=2000, stereo_share=0.0)
    R0, t0, obs = R0.to(dev), t0.to(dev), _on(obs, dev)
    eager = pose_optimization(CAM, R0, t0, obs)
    sg = graphs.StepGraphs(dev)

    def segment(cam, R0, t0, obs):
        return pose_optimization(cam, R0, t0, obs)

    before = pose_optimization.launches
    for k in range(3):
        out = sg.run("pose", segment, {"cam": CAM}, R0=R0, t0=t0, obs=obs)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, eager))
        assert pose_optimization.launches == before + 2 + k  # warm-up, then a replay each
    assert sg.captures == 1 and sg.replays == 3
    assert sg.captured[0]["kernel_nodes"] == 1
    assert sg.captured[0]["launches"]["pose_optimization"] == 1
    assert sg.replayed_launches["pose_optimization"] == 3
