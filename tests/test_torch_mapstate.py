"""The port's MapState functions against the JAX package's, on the CPU, on
seeded random maps: exact for every integer, mask and copied field, 1e-5
for the normals (a float sum over observations, in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.mapstate import core as jcore
from tpuslam_torch.convert import array_to_tensor, map_to_numpy, map_to_torch
from tpuslam_torch.mapstate import core as tcore

torch.set_num_threads(2)

K, N, P = 6, 24, 40


def _random_map(rng, n_kf=5, n_pt=32):
    """A map of numpy arrays with the JAX package's dtypes: observations
    with repeats (point 5 in six slots of every keyframe: more than
    max_obs), invalid keyframes, keypoints and points."""
    m = jcore.make_empty_map(K, N, P)
    f = {k: np.array(v) for k, v in m._asdict().items()}
    w = rng.normal(0, 0.2, (K, 3))
    for k in range(K):
        th = np.linalg.norm(w[k])
        a = w[k] / th
        A = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        f["kf_R"][k] = np.eye(3) + np.sin(th) * A + (1 - np.cos(th)) * A @ A
    f["kf_t"] = rng.normal(0, 0.5, (K, 3)).astype(np.float32)
    f["kf_valid"] = np.arange(K) < n_kf
    f["kf_valid"][1] = False
    f["kf_frame_id"] = np.arange(K, dtype=np.int32) * 3
    f["kf_kp_xy"] = rng.uniform(0, 300, (K, N, 2)).astype(np.float32)
    f["kf_kp_level"] = rng.integers(0, 8, (K, N)).astype(np.int32)
    f["kf_kp_angle"] = rng.uniform(-np.pi, np.pi, (K, N)).astype(np.float32)
    f["kf_kp_desc"] = rng.integers(0, 2**32, (K, N, 8), dtype=np.uint32)
    f["kf_kp_valid"] = rng.uniform(size=(K, N)) < 0.9
    obs = np.where(rng.uniform(size=(K, N)) < 0.7, rng.integers(0, n_pt, (K, N)), -1)
    obs[:, :6] = 5
    f["kf_obs_pt"] = obs.astype(np.int32)
    f["pt_xyz"] = rng.normal(0, 2.0, (P, 3)).astype(np.float32)
    f["pt_valid"] = (np.arange(P) < n_pt) & (rng.uniform(size=P) < 0.85)
    f["pt_valid"][5] = True
    f["pt_desc"] = rng.integers(0, 2**32, (P, 8), dtype=np.uint32)
    f["pt_normal"] = rng.normal(0, 1, (P, 3)).astype(np.float32)
    f["pt_min_dist"] = rng.uniform(0.1, 1, P).astype(np.float32)
    f["pt_max_dist"] = rng.uniform(2, 9, P).astype(np.float32)
    f["pt_ref_kf"] = rng.integers(0, K, P).astype(np.int32)
    f["pt_first_kf"] = f["pt_ref_kf"].copy()
    f["pt_found"] = rng.integers(1, 5, P).astype(np.float32)
    f["pt_visible"] = f["pt_found"] + rng.integers(0, 5, P).astype(np.float32)
    f["n_kf"] = np.int32(n_kf)
    f["n_pt"] = np.int32(n_pt)
    return jcore.MapState(**{k: np.asarray(v, m._asdict()[k].dtype) for k, v in f.items()})


def _jax(m):
    return jcore.MapState(*(jnp.asarray(x) for x in m))


def _assert_maps_equal(got: tcore.MapState, ref):
    g = map_to_numpy(got)
    for name, a, b in zip(tcore.MapState._fields, g, ref):
        assert a.dtype == np.asarray(b).dtype, name
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)


def _frame(rng, n=N):
    return jcore.FrameFeatures(
        xy=rng.uniform(0, 300, (n, 2)).astype(np.float32),
        level=rng.integers(0, 8, n).astype(np.int32),
        angle=rng.uniform(-np.pi, np.pi, n).astype(np.float32),
        desc=rng.integers(0, 2**32, (n, 8), dtype=np.uint32),
        valid=rng.uniform(size=n) < 0.8,
        u_right=np.full(n, -1.0, np.float32),
        depth=np.zeros(n, np.float32),
    )


def test_make_empty_map_exact():
    _assert_maps_equal(tcore.make_empty_map(K, N, P, "cpu"), jcore.make_empty_map(K, N, P))


@pytest.mark.parametrize("case", ["watermark", "full", "recycled_slot"])
def test_insert_keyframe_exact(rng, case):
    m = _random_map(rng, n_kf=K if case == "full" else 3)
    feats = _frame(rng)
    R = np.eye(3, dtype=np.float32)[[1, 2, 0]]
    t = np.array([0.1, -0.2, 0.3], np.float32)
    obs = rng.integers(-1, P, N).astype(np.int32)
    slot = 1 if case == "recycled_slot" else None
    jm, jki = jcore.insert_keyframe(_jax(m), jcore.FrameFeatures(*map(jnp.asarray, feats)),
                                    jnp.asarray(R), jnp.asarray(t), 17, jnp.asarray(obs), slot=slot)
    tm, tki = tcore.insert_keyframe(
        map_to_torch(m, "cpu"), tcore.FrameFeatures(*(array_to_tensor(x, "cpu") for x in feats)),
        torch.from_numpy(R), torch.from_numpy(t), 17, array_to_tensor(obs, "cpu"), slot=slot)
    _assert_maps_equal(tm, jm)
    assert int(tki) == int(jki)
    if case == "full":
        _assert_maps_equal(tm, m)  # a no-op


@pytest.mark.parametrize("n_pt", [10, P - 5, P])
def test_insert_points_exact(rng, n_pt):
    """The watermark, an overflow whose dropped rows park at the last slot
    (a created row lands there too, then parked rows write over it), and
    a full map."""
    m = _random_map(rng, n_pt=min(n_pt, P - 1))._replace(n_pt=np.int32(n_pt))
    B = 12
    args = dict(
        xyz=rng.normal(0, 3, (B, 3)).astype(np.float32),
        desc=rng.integers(0, 2**32, (B, 8), dtype=np.uint32),
        new_valid=rng.uniform(size=B) < 0.75,
        normal=rng.normal(0, 1, (B, 3)).astype(np.float32),
        min_dist=rng.uniform(0.1, 1, B).astype(np.float32),
        max_dist=rng.uniform(2, 9, B).astype(np.float32),
    )
    args["new_valid"][[0, 3, 4, 5, 6, -1]] = [True, True, True, True, False, False]
    jm, jslots = jcore.insert_points(_jax(m), ref_kf=3, **{k: jnp.asarray(v) for k, v in args.items()})
    tm, tslots = tcore.insert_points(map_to_torch(m, "cpu"), ref_kf=3,
                                     **{k: array_to_tensor(v, "cpu") for k, v in args.items()})
    _assert_maps_equal(tm, jm)
    np.testing.assert_array_equal(tslots.numpy(), np.asarray(jslots))
    if n_pt == P - 5:
        # The row created at the last slot was overwritten by a parked row.
        assert int(jm.n_pt) == P and not bool(jm.pt_valid[P - 1])
        assert int(jslots[np.flatnonzero(args["new_valid"])[4]]) == P - 1


def test_compact_point_slots_exact(rng):
    m = _random_map(rng)
    jm, jo2n = jcore.compact_point_slots(_jax(m))
    tm, to2n = tcore.compact_point_slots(map_to_torch(m, "cpu"))
    _assert_maps_equal(tm, jm)
    np.testing.assert_array_equal(to2n.numpy(), np.asarray(jo2n))


def test_observation_incidence_exact(rng):
    m = _random_map(rng)
    got = tcore.observation_incidence(map_to_torch(m, "cpu"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcore.observation_incidence(_jax(m))))


@pytest.mark.parametrize("block", [16384, 7])
def test_covisibility_weights_exact(rng, block):
    """The single product (P <= block) and the blocked form (block=7)."""
    m = _random_map(rng)
    ref = np.asarray(jcore.covisibility_weights(_jax(m), block=block))
    got = tcore.covisibility_weights(map_to_torch(m, "cpu"), block=block).numpy()
    np.testing.assert_array_equal(got, ref)
    assert ref.max() > 0


def test_shared_point_counts_exact(rng):
    m = _random_map(rng)
    tm = map_to_torch(m, "cpu")
    for anchor in range(K):
        ref = np.asarray(jcore.shared_point_counts(_jax(m), anchor))
        np.testing.assert_array_equal(tcore.shared_point_counts(tm, anchor).numpy(), ref)
        np.testing.assert_array_equal(
            tcore.shared_point_counts(tm, torch.tensor(anchor)).numpy(), ref)


def test_compute_point_descriptors_exact(rng):
    m = _random_map(rng)
    # Near-duplicate descriptors, so that the median choice is not trivial.
    base = rng.integers(0, 2**32, (P, 8), dtype=np.uint32)
    obs = np.asarray(m.kf_obs_pt)
    noise = rng.integers(0, 2**32, (K, N, 8), dtype=np.uint32) & rng.integers(
        0, 2**32, (K, N, 8), dtype=np.uint32) & rng.integers(0, 2**32, (K, N, 8), dtype=np.uint32)
    m = m._replace(kf_kp_desc=np.where(obs[..., None] >= 0, base[np.maximum(obs, 0)] ^ noise,
                                       m.kf_kp_desc).astype(np.uint32))
    mask = rng.uniform(size=P) < 0.8
    mask[5] = True
    ref = jcore.compute_point_descriptors(_jax(m), jnp.asarray(mask))
    got = tcore.compute_point_descriptors(map_to_torch(m, "cpu"), array_to_tensor(mask, "cpu"))
    _assert_maps_equal(got, ref)
    # The case list holds an even observation count and one above max_obs.
    live = (obs >= 0) & np.asarray(m.kf_kp_valid) & np.asarray(m.kf_valid)[:, None]
    counts = np.bincount(obs[live], minlength=P)
    used = mask & np.asarray(m.pt_valid) & (counts > 0)
    assert (used & (counts % 2 == 0) & (counts <= 16)).any() and counts[5] > 16
    assert (np.asarray(ref.pt_desc) != np.asarray(m.pt_desc)).any()


def test_nanmedian_takes_the_mean_of_the_middle_pair():
    d = torch.tensor([[3.0, 1.0, float("nan"), 4.0, 2.0],
                      [5.0, float("nan"), 1.0, float("nan"), float("nan")],
                      [float("nan")] * 5])
    got = tcore._nanmedian_last(d)
    ref = jnp.nanmedian(jnp.asarray(d.numpy()), axis=-1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got[0] == 2.5 and got[1] == 3.0 and torch.isnan(got[2])


def test_update_point_normals_close(rng):
    m = _random_map(rng)
    sf = np.array([1.2**l for l in range(8)], np.float32)
    ref = jcore.update_point_normals(_jax(m), jnp.asarray(sf))
    got = map_to_numpy(tcore.update_point_normals(map_to_torch(m, "cpu"), torch.from_numpy(sf)))
    for name in ("pt_normal", "pt_min_dist", "pt_max_dist"):
        np.testing.assert_allclose(getattr(got, name), np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    for name in tcore.MapState._fields:
        if name not in ("pt_normal", "pt_min_dist", "pt_max_dist"):
            np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(ref, name)))
    # Some ranges changed, some points had no reference observation.
    changed = np.asarray(ref.pt_max_dist) != np.asarray(m.pt_max_dist)
    assert changed.any() and not changed[np.asarray(m.pt_valid)].all()
