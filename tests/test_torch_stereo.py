"""The port's stereo front end against the JAX package, on the CPU:
project_stereo, build_patch_atlas, stereo_match (row-banded Hamming search,
SAD refinement, median-SAD cull) and stereo_frame_features.

stereo_match is compared op by op on shared inputs: the port's features
and pyramids go into both, so `valid` must be equal, u_right within 1e-4
px and depth within 1e-5 relative. The JAX stereo_frame_features is
jitted: XLA:CPU contracts the pyramid's multiply-adds into FMAs (up to
7e-3 at 640x480), which can move a corner or flip a threshold, so the
comparison with it states a tolerance: the same keypoints (xy, level,
valid) on >= 99% of the slots, the same stereo verdict on >= 97% of the
keypoints both keep, and u_right within 0.05 px on 99% of those both
match.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuslam.ops.orb as jorb
import tpuslam.ops.stereo as jstereo
from tpuslam.geometry.camera import PinholeCamera as JCamera, project_stereo as jax_project_stereo
from tpuslam.ops.image import build_pyramid as jax_build_pyramid
from tpuslam.pipeline.steps import stereo_frame_features as jax_stereo_frame_features
from tpuslam_torch.convert import features_to_numpy
from tpuslam_torch.geometry.camera import PinholeCamera, project_stereo
from tpuslam_torch.mapstate.core import _nanmedian_last
from tpuslam_torch.matching.hamming import hamming_matrix
from tpuslam_torch.ops import orb as torb
from tpuslam_torch.ops import stereo as tstereo
from tpuslam_torch.ops.image import build_pyramid
from tpuslam_torch.ops.orb import ORBConfig, ORBFeatures, build_patch_atlas, detect_batched, extract_orb_batched
from tpuslam_torch.pipeline import steps
from tpuslam_torch.testing import StepWallScene, orbit_trajectory, render_stereo_frames

torch.set_num_threads(2)

CFG = ORBConfig(n_features=500)
JCFG = jorb.ORBConfig(n_features=500)
# 320x240 and an odd width, so the atlas pitch (W + 16) is odd.
CAMS = {
    (240, 320): PinholeCamera(fx=350.0, fy=350.0, cx=160.0, cy=120.0, bf=42.0, width=320, height=240),
    (188, 621): PinholeCamera(fx=359.4, fy=359.4, cx=303.6, cy=92.6, bf=193.1, width=621, height=188),
}


@pytest.fixture(scope="module")
def scene():
    return StepWallScene(np.random.default_rng(5))


def _pair(scene, shape, i=0):
    cam = CAMS[shape]
    (L, R), = render_stereo_frames(scene, cam, orbit_trajectory(i + 1, step=0.05)[i:])
    return cam, L, R


def _split(fb):
    return ORBFeatures(*(x[0] for x in fb)), ORBFeatures(*(x[1] for x in fb))


def _jax_features(f: ORBFeatures):
    return jorb.ORBFeatures(*(jnp.asarray(x) for x in features_to_numpy(f)))


def _jax_pyramid(levels):
    return [jnp.asarray(x.numpy()) for x in levels]


def _both(cam, fL, fR, pL, pR):
    """(port, JAX) stereo_match on the same features and pyramids."""
    got = tstereo.stereo_match(fL, fR, pL, pR, CFG, cam.fx, cam.bf)
    ref = jstereo.stereo_match(_jax_features(fL), _jax_features(fR), _jax_pyramid(pL),
                               _jax_pyramid(pR), JCFG, cam.fx, cam.bf)
    return [x.numpy() for x in got], [np.asarray(x) for x in ref]


def _assert_same(got, ref):
    (u, d, v), (ju, jd, jv) = got, ref
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_allclose(u, ju, rtol=0, atol=1e-4)
    np.testing.assert_allclose(d, jd, rtol=1e-5, atol=0)


def test_project_stereo_matches_jax(rng):
    cam = CAMS[(240, 320)]
    x = np.stack([rng.uniform(-2, 2, 500), rng.uniform(-1, 1, 500), rng.uniform(0.5, 9, 500)], -1)
    x = x.astype(np.float32)
    x[:3, 2] = [0.0, 1e-12, -1.0]  # the z guard and a point behind
    got = project_stereo(cam, torch.from_numpy(x)).numpy()
    ref = np.asarray(jax_project_stereo(JCamera(**cam._asdict()), jnp.asarray(x)))
    assert got.shape == (500, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", list(CAMS))
def test_build_patch_atlas_bytes_match_jax(scene, shape):
    _, L, _ = _pair(scene, shape)
    levels = build_pyramid(L, 8, 1.2)
    atlas, offs, wa = build_patch_atlas(levels)
    ja, joffs, jwa = jorb.build_patch_atlas(jax_build_pyramid(jnp.asarray(L.numpy()), 8, 1.2))
    assert atlas.dtype == torch.uint8 and wa == jwa == shape[1] + 16
    np.testing.assert_array_equal(offs, joffs)
    np.testing.assert_array_equal(atlas.numpy(), np.asarray(ja))


@pytest.mark.parametrize("shape, n_features", [((240, 320), 500), ((188, 621), 500), ((188, 621), 5)])
def test_detect_atlas_slabs_are_patch_atlases(scene, shape, n_features):
    """Each stream's slab of the describe stage's atlas is build_patch_atlas
    of its pyramid, byte for byte, also when a level has no feature budget
    (5 features): what lets stereo_frame_features reuse it."""
    _, L, R = _pair(scene, shape)
    cfg = ORBConfig(n_features=n_features)
    assert (0 in cfg.level_budgets()) == (n_features == 5)
    atlas = detect_batched(torch.stack([L, R]), cfg)[4]
    for b, img in enumerate((L, R)):
        single = build_patch_atlas(build_pyramid(img, 8, 1.2))[0]
        Ha = single.shape[0]
        assert atlas.shape == (2 * Ha, single.shape[1])
        assert torch.equal(atlas[b * Ha:(b + 1) * Ha], single)


@pytest.mark.parametrize("shape", list(CAMS))
def test_stereo_match_matches_jax(scene, shape):
    cam, L, R = _pair(scene, shape)
    fL, fR = _split(extract_orb_batched(torch.stack([L, R]), CFG))
    pL, pR = build_pyramid(L, 8, 1.2), build_pyramid(R, 8, 1.2)
    got, ref = _both(cam, fL, fR, pL, pR)
    _assert_same(got, ref)
    assert got[2].sum() > 0.3 * fL.valid.sum().item()


def _tied(fL: ORBFeatures, fR: ORBFeatures, drop_left: int = 0):
    """Right features where every third keypoint repeats the previous one's
    descriptor and level at the same row, so many left rows have tied
    minimum distances; the first `drop_left` valid left keypoints dropped."""
    idx = torch.arange(fR.xy.shape[0])
    src = torch.where(idx % 3 == 2, idx - 1, idx)
    xy = fR.xy.clone()
    xy[:, 1] = fR.xy[src, 1]
    fR2 = fR._replace(xy=xy, desc=fR.desc[src], level=fR.level[src], valid=fR.valid[src])
    keep = fL.valid.clone()
    keep[torch.nonzero(keep)[:drop_left, 0]] = False
    return fL._replace(valid=keep), fR2


def _pre_cull_valid(cam, fL, fR, pL, pR) -> np.ndarray:
    """(The keypoints stereo_match holds before its median-SAD cull, the
    masked distance matrix), through the port's internals."""
    tabs = tstereo.level_tables(tuple(tuple(x.shape) for x in pL), CFG.scale_factor, torch.device("cpu"))
    sL = tabs.scale[fL.level.long()]
    uL, vL, uR, vR = fL.xy[:, 0], fL.xy[:, 1], fR.xy[:, 0], fR.xy[:, 1]
    pair = (fL.valid[:, None] & fR.valid[None, :] & ((vR[None] - vL[:, None]).abs() <= 2 * sL[:, None])
            & (fR.level[None] >= fL.level[:, None] - 1) & (fR.level[None] <= fL.level[:, None] + 1)
            & (uR[None] >= uL[:, None] - cam.fx) & (uR[None] <= uL[:, None]))
    dist = torch.where(pair, hamming_matrix(fL.desc, fR.desc), tstereo._BIG)
    i1 = dist.argmin(1)
    matched = dist.min(1).values < tstereo.TH_ORB
    uR_l0, _, ok = tstereo._sad_refine_all_levels(pL, pR, fL.level, uL, vL, uR[i1], matched, CFG)
    disp = uL - torch.where(ok, uR_l0, -1.0)
    return (ok & (disp > 0) & (disp < cam.fx)).numpy(), dist.numpy()


@pytest.mark.parametrize("shape", list(CAMS))
def test_stereo_match_ties_and_even_median_match_jax(scene, shape):
    """Tied Hamming minima (integer distances: the lowest index wins in
    both) and an even count of valid SADs before the median cull (the
    median is the mean of the two middle values, not the lower one)."""
    cam, L, R = _pair(scene, shape)
    fL, fR = _split(extract_orb_batched(torch.stack([L, R]), CFG))
    pL, pR = build_pyramid(L, 8, 1.2), build_pyramid(R, 8, 1.2)
    fL2, fR2 = _tied(fL, fR)
    pre, dist = _pre_cull_valid(cam, fL2, fR2, pL, pR)
    if pre.sum() % 2:
        # Drop valid left keypoints until the pre-cull count is even.
        for k in range(1, 20):
            fL2, fR2 = _tied(fL, fR, drop_left=k)
            pre, dist = _pre_cull_valid(cam, fL2, fR2, pL, pR)
            if pre.sum() % 2 == 0:
                break
    assert pre.sum() % 2 == 0 and pre.sum() > 10
    low = dist.min(1, keepdims=True)
    ties = ((dist == low) & (low < tstereo.TH_ORB)).sum(1) > 1
    assert ties.sum() > 10, "the case has no tied minima"
    got, ref = _both(cam, fL2, fR2, pL, pR)
    _assert_same(got, ref)


def test_nanmedian_rule_of_the_cull():
    """The cull's median: the mean of the two middle values for an even
    count, as jnp.nanmedian; torch.nanmedian would take the lower."""
    x = torch.tensor([7.0, float("nan"), 3.0, 12.0, 5.0, float("nan")])
    assert float(_nanmedian_last(x)) == float(jnp.nanmedian(jnp.asarray(x.numpy()))) == 6.0
    assert float(torch.nanmedian(x)) == 5.0
    assert torch.isnan(_nanmedian_last(torch.full((4,), float("nan"))))


@pytest.mark.parametrize("shape", list(CAMS))
def test_atlas_reuse_equals_stereo_match(scene, shape, monkeypatch):
    """stereo_frame_features (one extraction of both images, the SAD windows
    from its atlas) equals extraction then stereo_match on rebuilt
    pyramids, bit for bit, with one FAST+NMS call and two gathers."""
    cam, L, R = _pair(scene, shape)
    calls = {"fast": 0, "gather": 0}
    fast, gather = torb.fast_nms_pyramid, tstereo.gather_patches

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(torb, "fast_nms_pyramid", count("fast", fast))
    monkeypatch.setattr(torb, "gather_patches", count("gather", torb.gather_patches))
    monkeypatch.setattr(tstereo, "gather_patches", count("gather", gather))
    ff = steps.stereo_frame_features(L, R, CFG, cam.fx, cam.bf)
    assert calls == {"fast": 1, "gather": 2}
    fL, fR = _split(extract_orb_batched(torch.stack([L, R]), CFG))
    u, d, v = tstereo.stereo_match(fL, fR, build_pyramid(L, 8, 1.2), build_pyramid(R, 8, 1.2),
                                   CFG, cam.fx, cam.bf)
    assert torch.equal(ff.xy, fL.xy) and torch.equal(ff.desc, fL.desc)
    assert torch.equal(ff.u_right, torch.where(v, u, -1.0))
    assert torch.equal(ff.depth, torch.where(v, d, 0.0))


def test_stereo_frame_features_matches_jitted_jax(scene):
    cam, L, R = _pair(scene, (240, 320), i=3)
    got = steps.stereo_frame_features(L, R, CFG, cam.fx, cam.bf)
    ref = jax_stereo_frame_features(jnp.asarray(L.numpy()), jnp.asarray(R.numpy()), JCFG, cam.fx, cam.bf)
    same_kp = ((np.abs(got.xy.numpy() - np.asarray(ref.xy)) < 1e-3).all(-1)
               & (got.level.numpy() == np.asarray(ref.level)) & (got.valid.numpy() == np.asarray(ref.valid)))
    assert same_kp.mean() >= 0.99, same_kp.mean()
    both = same_kp & got.valid.numpy()
    gv, jv = got.u_right.numpy() >= 0, np.asarray(ref.u_right) >= 0
    assert (gv == jv)[both].mean() >= 0.97, (gv == jv)[both].mean()
    m = both & gv & jv
    du = np.abs(got.u_right.numpy() - np.asarray(ref.u_right))[m]
    assert m.sum() > 100 and np.quantile(du, 0.99) < 0.05, np.quantile(du, 0.99)


def test_stereo_match_depth_is_metric(scene):
    """The matched depths are the rendered scene's: median relative error
    below 5% on the keypoints stereo_match keeps."""
    cam, L, R = _pair(scene, (240, 320))
    (_, z), = [scene.render(cam, *orbit_trajectory(1, step=0.05)[0], with_depth=True)]
    f = steps.stereo_frame_features(L, R, CFG, cam.fx, cam.bf)
    v = (f.depth > 0).numpy()
    xy = f.xy.numpy()
    zz = z[np.clip(np.round(xy[:, 1]).astype(int), 0, cam.height - 1),
           np.clip(np.round(xy[:, 0]).astype(int), 0, cam.width - 1)]
    ok = v & (zz > 0)
    assert ok.sum() > 100
    assert np.median(np.abs(f.depth.numpy()[ok] - zz[ok]) / zz[ok]) < 0.05
