"""The port's ORB front end against the JAX package, on the CPU.

The same seeded numpy inputs go through both. The JAX functions run
op by op (not under jit): under jit XLA:CPU contracts multiply-adds into
fused multiply-adds, which moves the bilinear pyramid by up to ~7e-3 at
640x480, while the port (and the JAX package op by op) rounds every product.
Op by op the two agree bit for bit, which the exact checks below rely on.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuslam.ops.orb as jorb
from tpuslam.ops.image import build_pyramid as jax_build_pyramid
from tpuslam.ops.image import gaussian_blur as jax_gaussian_blur
from tpuslam.ops.patches import gather_patches_xla
from tpuslam_torch.convert import desc_to_numpy
from tpuslam_torch.ops import orb as torb
from tpuslam_torch.ops.fast import fast_nms, fast_nms_pyramid
from tpuslam_torch.ops.image import build_pyramid, gaussian_blur
from tpuslam_torch.ops.patches import PSIZE, gather_patches

torch.set_num_threads(2)


def _texture(rng, h, w, n_squares=80, blur=False):
    img = rng.uniform(0, 255, size=(h, w)).astype(np.float32)
    if blur:
        img = np.array(jax_gaussian_blur(jnp.asarray(img), 7, 2.0))
    for _ in range(n_squares):
        y, x = rng.integers(5, h - 15), rng.integers(5, w - 15)
        s = rng.integers(3, 12)
        img[y : y + s, x : x + s] = rng.uniform(0, 255)
    return img


@pytest.mark.parametrize("shape", [(120, 160), (97, 200)])
def test_build_pyramid_matches_jax(rng, shape):
    img = rng.uniform(0, 255, shape).astype(np.float32)
    ref = jax_build_pyramid(jnp.asarray(img), 8, 1.2)
    got = build_pyramid(torch.from_numpy(img), 8, 1.2)
    assert len(got) == len(ref) == 8
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-4)


def test_gaussian_blur_matches_jax(rng):
    img = rng.uniform(0, 255, (60, 90)).astype(np.float32)
    np.testing.assert_allclose(
        gaussian_blur(torch.from_numpy(img)).numpy(),
        np.asarray(jax_gaussian_blur(jnp.asarray(img), 7, 2.0)), rtol=0, atol=1e-4,
    )


@pytest.mark.parametrize("shape", [(120, 160), (97, 200)])
def test_fast_nms_plain_exact(rng, shape):
    """Plain FAST+NMS == the JAX package's _nms3(fast_response) everywhere,
    borders included (both replicate the edge)."""
    img = _texture(rng, *shape)
    ref = np.asarray(jorb._nms3(jorb.fast_response(jnp.asarray(img), 7.0)))
    got = fast_nms(torch.from_numpy(img)[None], 7.0)[0].numpy()
    np.testing.assert_array_equal(got, ref)
    assert (ref > 0).sum() > 50


def test_fast_nms_pyramid_exact(rng):
    """fast_nms_pyramid on CPU tensors == the JAX package's
    _nms3(fast_response) on every level of a two-stream pyramid, and on a
    ragged set of levels with other stream counts."""
    imgs = np.stack([_texture(rng, 120, 160), _texture(rng, 120, 160)])
    levels = build_pyramid(torch.from_numpy(imgs), 8, 1.2)
    levels += [torch.from_numpy(_texture(rng, 97, 200)[None]),
               torch.from_numpy(np.stack([_texture(rng, 40, 45)] * 3))]
    got = fast_nms_pyramid(levels, 7.0)
    assert len(got) == len(levels) == 10
    for lvl, g in zip(levels, got):
        for b in range(lvl.shape[0]):
            ref = np.asarray(jorb._nms3(jorb.fast_response(jnp.asarray(lvl[b].numpy()), 7.0)))
            np.testing.assert_array_equal(g[b].numpy(), ref)
    assert (got[0] > 0).sum() > 50


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_gather_plain_exact(rng, dtype):
    Ha, Wa = 200, 300
    atlas = rng.integers(0, 256, (Ha, Wa)).astype(dtype)
    corner = np.stack([rng.integers(0, Ha - PSIZE + 1, 37),
                       rng.integers(0, Wa - PSIZE + 1, 37)], -1)
    edges = [(0, 0), (Ha - PSIZE, Wa - PSIZE), (0, Wa - PSIZE), (Ha - PSIZE, 0)]
    corner = np.concatenate([corner, edges]).astype(np.int32)
    ref = np.asarray(gather_patches_xla(jnp.asarray(atlas), jnp.asarray(corner)))
    got = gather_patches(torch.from_numpy(atlas), torch.from_numpy(corner))
    assert got.dtype == torch.float32 and got.shape == (41, PSIZE, PSIZE)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_select_level_keypoints_ties_exact(rng):
    """Integer scores with many ties (zero cells, equal responses): the port's
    stable sort must pick what lax.top_k picks (ties to the lower index)."""
    score = (rng.integers(0, 4, (2, 90, 125)) * 10).astype(np.float32)
    score[:, 40:70, 30:60] = 0.0  # empty cells
    ref = [jorb._select_level_keypoints(jnp.asarray(s), 100, 30, 20.0) for s in score]
    xy, resp, valid = torb._select_level_keypoints(torch.from_numpy(score), 100, 30, 20.0)
    for b, (rxy, rresp, rvalid) in enumerate(ref):
        np.testing.assert_array_equal(xy[b].numpy(), np.asarray(rxy))
        np.testing.assert_array_equal(resp[b].numpy(), np.asarray(rresp))
        np.testing.assert_array_equal(valid[b].numpy(), np.asarray(rvalid))


def test_extract_orb_batched_matches_jax(rng):
    imgs = np.stack([_texture(rng, 120, 160, 200, blur=True) for _ in range(2)])
    ref = jorb.extract_orb_batched(jnp.asarray(imgs), jorb.ORBConfig(n_features=300))
    got = torb.extract_orb_batched(torch.from_numpy(imgs), torb.ORBConfig(n_features=300))
    for name in ("xy", "level", "valid", "response"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))
    v = np.asarray(ref.valid)
    assert v.sum() > 200
    np.testing.assert_allclose(got.angle.numpy(), np.asarray(ref.angle), rtol=0, atol=1e-5)
    # arctan2 may differ by an ulp between the frameworks and flip a rotated
    # sample's rounding, so a descriptor can differ in a bit or two.
    same = (desc_to_numpy(got.desc) == np.asarray(ref.desc)).all(-1)
    assert same[v].mean() >= 0.99


def test_extract_orb_single_is_batch_of_one(rng):
    img = _texture(rng, 120, 160, 200, blur=True)
    cfg = torb.ORBConfig(n_features=200)
    one = torb.extract_orb(torch.from_numpy(img), cfg)
    both = torb.extract_orb_batched(torch.from_numpy(np.stack([img, img])), cfg)
    for name in ("xy", "level", "valid", "response"):
        assert torch.equal(getattr(one, name), getattr(both, name)[1])
    # The CPU's vectorized atan2 and its scalar tail differ by an ulp, and a
    # keypoint's place in the batch decides which one computes its angle.
    torch.testing.assert_close(one.angle, both.angle[1], rtol=0, atol=1e-6)
    assert (one.desc == both.desc[1]).all(-1).float().mean() >= 0.99


def test_brief_pattern_is_the_shipped_one():
    np.testing.assert_array_equal(torb.BRIEF_PATTERN, jorb.BRIEF_PATTERN)
    assert torb.BRIEF_PATTERN.shape == (256, 2, 2)
