"""Package-level properties of the PyTorch port: no jax at import, CPU
tensors take the kernels' plain versions, state crosses both ways, and (on
a card) each CUDA kernel equals its plain version.

This module imports no jax at its top (one test imports it inside), so its
card test runs on a machine without it:
    python -m pytest --noconftest tests/test_torch_package.py -m cuda
"""

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
from tpuslam_torch.ops.fast import fast_nms, fast_nms_plain
from tpuslam_torch.ops.orb import ORBConfig, extract_orb_batched
from tpuslam_torch.ops.patches import PSIZE, gather_patches, gather_patches_plain

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def test_import_pulls_in_no_jax():
    code = (
        "import sys, pkgutil, importlib, tpuslam_torch\n"
        "for m in pkgutil.walk_packages(tpuslam_torch.__path__, 'tpuslam_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'tpuslam'))\n"
        "assert not bad, bad\n"
        "assert {'tpuslam_torch.mapstate.core', 'tpuslam_torch.pipeline.steps'} <= set(sys.modules)\n"
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
    t = array_to_tensor(words)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(desc_to_numpy(t), words)


def test_features_cross_both_ways(rng):
    f = extract_orb_batched(
        torch.from_numpy(rng.uniform(0, 255, (1, 120, 160)).astype(np.float32)),
        ORBConfig(n_features=100),
    )
    npf = features_to_numpy(f)
    assert npf.desc.dtype == np.uint32
    back = features_to_torch(npf)
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
    t = map_to_torch(ref)
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
        desc=array_to_tensor(rng.integers(0, 2**32, (7, 8), dtype=np.uint32)),
        valid=torch.ones(7, dtype=torch.bool),
        u_right=torch.full((7,), -1.0),
        depth=torch.linspace(0, 3, 7),
    )
    npf = frame_features_to_numpy(f)
    assert npf.desc.dtype == np.uint32
    for a, b in zip(f, frame_features_to_torch(npf)):
        assert torch.equal(a, b)


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
    Ha, Wa = 300, 400
    corner = torch.tensor(
        [(0, 0), (Ha - PSIZE, Wa - PSIZE), (0, Wa - PSIZE), (Ha - PSIZE, 0), (17, 301)],
        dtype=torch.int32, device="cuda")
    for dtype in (torch.uint8, torch.float32):
        atlas = torch.from_numpy(gen.integers(0, 256, (Ha, Wa))).to("cuda", dtype)
        got = gather_patches(atlas, corner)
        torch.cuda.synchronize()
        assert torch.equal(got, gather_patches_plain(atlas, corner))
