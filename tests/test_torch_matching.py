"""The port's Hamming distance and search modes against the JAX package,
on the CPU: exact on integer distances, indices and masks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.matching.hamming import hamming_distance as jax_hamming_distance
from tpuslam.matching.hamming import hamming_matrix as jax_hamming_matrix
from tpuslam.matching import search as jsearch
from tpuslam.matching.search import resolve_duplicates as jax_resolve_duplicates
from tpuslam.matching.search import search_by_projection_points as jax_search
from tpuslam_torch.convert import array_to_tensor
from tpuslam_torch.matching import search as tsearch
from tpuslam_torch.matching.hamming import hamming_distance, hamming_matrix
from tpuslam_torch.matching.search import resolve_duplicates, search_by_projection_points

torch.set_num_threads(2)


def _desc(rng, n):
    return rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)


def _flip_bits(rng, desc, nbits):
    out = desc.copy()
    for i in range(len(out)):
        for b in rng.integers(0, 256, nbits):
            out[i, b // 32] ^= np.uint32(1) << np.uint32(b % 32)
    return out


def test_hamming_matrix_exact(rng):
    a, b = _desc(rng, 40), _desc(rng, 56)
    b[:8] = _flip_bits(rng, a[:8], 5)
    b[8] = a[9]
    b[9] = ~a[10]  # all 256 bits differ, incl. the int32 sign bits
    got = hamming_matrix(array_to_tensor(a, "cpu"), array_to_tensor(b, "cpu"))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    )
    assert got[10, 9] == 256


def test_hamming_distance_exact(rng):
    a, b = _desc(rng, 33), _desc(rng, 33)
    ref = np.unpackbits((a ^ b).view(np.uint8), axis=-1).sum(-1)
    got = hamming_distance(array_to_tensor(a, "cpu"), array_to_tensor(b, "cpu")).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, np.asarray(jax_hamming_distance(jnp.asarray(a), jnp.asarray(b))))


def _search_case(rng, n_pts=120, n_kp=150):
    """Keypoints on a 200x150 image; half the points project near a keypoint
    with a corrupted copy of its descriptor, some keypoints are shared
    (duplicates to resolve), the rest are clutter."""
    kp_xy = np.stack([rng.uniform(0, 200, n_kp), rng.uniform(0, 150, n_kp)], -1).astype(np.float32)
    kp_desc = _desc(rng, n_kp)
    kp_level = rng.integers(0, 4, n_kp).astype(np.int32)
    kp_angle = rng.uniform(-np.pi, np.pi, n_kp).astype(np.float32)
    kp_valid = rng.uniform(size=n_kp) < 0.9
    src = rng.integers(0, n_kp, n_pts)
    src[:10] = src[10:20]  # shared targets
    uv = kp_xy[src] + rng.normal(0, 2.0, (n_pts, 2)).astype(np.float32)
    uv[n_pts // 2 :] = np.stack([rng.uniform(0, 200, n_pts - n_pts // 2),
                                 rng.uniform(0, 150, n_pts - n_pts // 2)], -1)
    pt_desc = _flip_bits(rng, kp_desc[src], 20)
    pt_level = kp_level[src]
    return dict(
        uv_proj=uv.astype(np.float32), pt_desc=pt_desc,
        pt_valid=rng.uniform(size=n_pts) < 0.95,
        radius=(rng.uniform(3, 12, n_pts)).astype(np.float32),
        level_lo=np.maximum(pt_level - 1, 0).astype(np.int32),
        level_hi=(pt_level + 1).astype(np.int32),
        kp_xy=kp_xy, kp_desc=kp_desc, kp_level=kp_level, kp_angle=kp_angle, kp_valid=kp_valid,
    )


@pytest.mark.parametrize("nn_ratio", [0.0, 0.8])
def test_search_by_projection_points_exact(rng, nn_ratio):
    case = _search_case(rng)
    ref = jax_search(**{k: jnp.asarray(v) for k, v in case.items()}, max_dist=100, nn_ratio=nn_ratio)
    got = search_by_projection_points(
        **{k: array_to_tensor(v, "cpu") for k, v in case.items()}, max_dist=100, nn_ratio=nn_ratio
    )
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert 10 < int(got[2].sum()) < 120


@pytest.mark.parametrize("nn_ratio", [0.0, 0.8])
def test_search_batched_equals_per_stream(rng, nn_ratio):
    """Leading stream dim in the port == jax.vmap over streams."""
    cases = [_search_case(rng, 60, 80) for _ in range(3)]
    stacked = {k: np.stack([c[k] for c in cases]) for k in cases[0]}
    ref = jax.vmap(lambda *a: jax_search(*a, max_dist=100, nn_ratio=nn_ratio))(
        *[jnp.asarray(v) for v in stacked.values()]
    )
    got = search_by_projection_points(
        *[array_to_tensor(v, "cpu") for v in stacked.values()], max_dist=100, nn_ratio=nn_ratio
    )
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_resolve_duplicates_exact(rng):
    idx = rng.integers(0, 12, 64).astype(np.int32)
    dist = rng.integers(0, 6, 64).astype(np.int32)  # many equal distances
    valid = rng.uniform(size=64) < 0.8
    ref = jax_resolve_duplicates(jnp.asarray(idx), jnp.asarray(dist), jnp.asarray(valid), 12)
    got = resolve_duplicates(
        array_to_tensor(idx, "cpu").long(), array_to_tensor(dist, "cpu"), array_to_tensor(valid, "cpu"), 12
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _both(fn_name, *args, **kw):
    """The JAX and the port's function on the same numpy inputs, as numpy."""
    ref = getattr(jsearch, fn_name)(*(jnp.asarray(a) for a in args), **kw)
    got = getattr(tsearch, fn_name)(*(array_to_tensor(a, "cpu") for a in args), **kw)
    if not isinstance(ref, tuple):
        ref, got = (ref,), (got,)
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


def test_constants_match():
    assert (tsearch.TH_HIGH, tsearch.TH_LOW, tsearch.HISTO_LENGTH) == (
        jsearch.TH_HIGH, jsearch.TH_LOW, jsearch.HISTO_LENGTH)


@pytest.mark.parametrize("case", ["random", "dominant", "bin_edges"])
def test_rotation_consistency_mask_exact(rng, case):
    """Random offsets, three dominant bins with weak ones dropped by the
    0.1x rule, and offsets on bin edges and across the 2*pi wrap (floor
    modulo, half-to-even rounding)."""
    n = 200
    a_t = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    if case == "random":
        off = rng.uniform(-7, 7, n)
    elif case == "dominant":
        off = np.concatenate([np.full(80, 0.3), np.full(60, -1.0), np.full(40, 2.0),
                              rng.uniform(-np.pi, np.pi, 20)]) + rng.normal(0, 0.02, n)
    else:
        k = rng.integers(-40, 40, n)
        off = (k + 0.5) * (2 * np.pi / 30) + rng.choice([0.0, 1e-7, -1e-7], n)
    a_q = (a_t + off).astype(np.float32)
    valid = rng.uniform(size=n) < 0.9
    ref, got = _both("rotation_consistency_mask", a_q, a_t, valid)
    np.testing.assert_array_equal(got[0], ref[0])
    assert 0 < got[0].sum() < valid.sum() or case == "random"


def test_rotation_consistency_mask_batched(rng):
    a_q = rng.uniform(-np.pi, np.pi, (3, 50)).astype(np.float32)
    a_t = rng.uniform(-np.pi, np.pi, (3, 50)).astype(np.float32)
    valid = rng.uniform(size=(3, 50)) < 0.8
    got = tsearch.rotation_consistency_mask(*(array_to_tensor(a, "cpu") for a in (a_q, a_t, valid)))
    for b in range(3):
        ref = jsearch.rotation_consistency_mask(jnp.asarray(a_q[b]), jnp.asarray(a_t[b]),
                                                jnp.asarray(valid[b]))
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(ref))


def test_match_nn_ratio_exact(rng):
    """Includes rows whose best and second best are equal: the strict ratio
    rejects them."""
    q, t = _desc(rng, 60), _desc(rng, 80)
    t[:30] = _flip_bits(rng, q[:30], 8)
    t[30:40] = _flip_bits(rng, q[:10], 8)  # second candidates for rows 0..9
    t[40] = t[0]  # row 0: equal best and second best
    pair = rng.uniform(size=(60, 80)) < 0.7
    pair[0, [0, 40]] = True
    for max_dist, ratio in ((50, 0.9), (100, 0.7)):
        ref, got = _both("match_nn_ratio", q, t, pair, max_dist=max_dist, nn_ratio=ratio)
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(g, r)
    assert not got[2][0] and got[2].sum() > 10


def test_search_for_initialization_exact(rng):
    n1, n2 = 120, 140
    xy1 = rng.uniform(0, 300, (n1, 2)).astype(np.float32)
    src = rng.integers(0, n1, n2)
    xy2 = (xy1[src] + rng.normal(0, 20, (n2, 2))).astype(np.float32)
    d1 = _desc(rng, n1)
    d2 = _flip_bits(rng, d1[src], 10)
    lv1 = np.where(rng.uniform(size=n1) < 0.7, 0, 1).astype(np.int32)
    lv2 = np.where(rng.uniform(size=n2) < 0.7, 0, 2).astype(np.int32)
    an1 = rng.uniform(-np.pi, np.pi, n1).astype(np.float32)
    an2 = (an1[src] + rng.choice([0.05, 0.1, 1.5], n2)).astype(np.float32)
    v1, v2 = rng.uniform(size=n1) < 0.95, rng.uniform(size=n2) < 0.95
    for check_rotation in (True, False):
        ref, got = _both("search_for_initialization", xy1, d1, lv1, an1, v1,
                         xy2, d2, lv2, an2, v2, window=40.0, check_rotation=check_rotation)
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(g, r)
        assert got[2].sum() > 10


def test_search_by_projection_frame_exact(rng):
    case = _search_case(rng)
    n_kp = case["kp_xy"].shape[0]
    last_angle = rng.uniform(-np.pi, np.pi, case["uv_proj"].shape[0]).astype(np.float32)
    args = (case["uv_proj"], case["pt_valid"], case["level_lo"] + 1, case["pt_desc"], last_angle,
            case["kp_xy"], case["kp_desc"], case["kp_level"],
            rng.uniform(-np.pi, np.pi, n_kp).astype(np.float32), case["kp_valid"])
    for check_rotation in (True, False):
        ref, got = _both("search_by_projection_frame", *args, th=3.0, scale_factor=1.2,
                         check_rotation=check_rotation)
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(g, r)
        assert got[2].sum() > 5
