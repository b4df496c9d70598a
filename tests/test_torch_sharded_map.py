"""The port's sharded map (tpuslam_torch/parallel/sharded_map.py) on 8
shards of the CPU, against the port's dense functions and the JAX package's
sharded ones on its 8-device virtual mesh (tests/conftest.py), on
tests/test_sharded_map.py's random map (6 keyframes, 32 keypoints, 100
point slots, 60 points) built in numpy and crossed through convert.py.

Covisibility counts are integers in float32, so every form must give the
same numbers exactly, culled points left out; the search must equal the
dense search on every matched point.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tpuslam.geometry.camera import PinholeCamera as JCamera
from tpuslam.mapstate.core import make_empty_map as jmake_empty_map
from tpuslam.parallel.sharded_map import PT_AXIS
from tpuslam.parallel.sharded_map import sharded_covisibility_weights as jsharded_covisibility
from tpuslam.parallel.sharded_map import sharded_search_local_points as jsharded_search
from tpuslam_torch.convert import array_to_tensor, camera_from, map_to_torch
from tpuslam_torch.geometry.camera import project
from tpuslam_torch.geometry.se3 import se3_apply
from tpuslam_torch.mapstate.core import covisibility_weights
from tpuslam_torch.matching.search import search_by_projection_points
from tpuslam_torch.parallel.sharded_map import (
    POINT_FIELDS,
    pad_point_capacity,
    shard_map_state,
    sharded_covisibility_weights,
    sharded_search_local_points,
)

torch.set_num_threads(2)

JCAM = JCamera(fx=300.0, fy=300.0, cx=160.0, cy=120.0, width=320, height=240)
CAM = camera_from(JCAM)
MESH = ["cpu"] * 8


def _random_map(seed=0, K=6, N=32, Pcap=100, n_pt=60, culled=0):
    """tests/test_sharded_map.py's map in numpy: each keyframe observes a
    random half of the points; `culled` of them then invalid. Returns (the
    JAX MapState, the port's)."""
    rng = np.random.default_rng(seed)
    m = jmake_empty_map(K, N, Pcap)
    xyz = np.stack([rng.uniform(-2, 2, n_pt), rng.uniform(-1.5, 1.5, n_pt), rng.uniform(3, 9, n_pt)],
                   -1).astype(np.float32)
    pt_valid = np.zeros(Pcap, bool)
    pt_valid[:n_pt] = True
    pt_valid[rng.choice(n_pt, culled, replace=False)] = False
    obs = np.full((K, N), -1, np.int32)
    for k in range(K):
        obs[k, :N // 2] = rng.choice(n_pt, N // 2, replace=False)
    m = m._replace(
        pt_xyz=m.pt_xyz.at[:n_pt].set(jnp.asarray(xyz)), pt_valid=jnp.asarray(pt_valid),
        pt_desc=m.pt_desc.at[:n_pt].set(jnp.asarray(rng.integers(0, 2**32, (n_pt, 8), dtype=np.uint32))),
        kf_valid=m.kf_valid.at[:K].set(True), n_kf=jnp.asarray(K), n_pt=jnp.asarray(n_pt),
        kf_obs_pt=jnp.asarray(obs), kf_kp_valid=jnp.ones((K, N), bool))
    return m, map_to_torch(m, "cpu")


def _jmesh():
    return Mesh(np.array(jax.devices()[:8]), (PT_AXIS,))


@pytest.mark.parametrize("culled", [0, 20])
def test_sharded_covisibility_equals_dense_and_jax(culled):
    jm, m = _random_map(culled=culled)
    dense = covisibility_weights(m)
    got = sharded_covisibility_weights(m, MESH)
    assert torch.equal(got, dense)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsharded_covisibility(jm, _jmesh())))
    # A culled point's observations do not count.
    obs, valid = m.kf_obs_pt.numpy(), m.pt_valid.numpy()
    shared = set(obs[0][obs[0] >= 0]) & set(obs[1][obs[1] >= 0])
    assert got[0, 1] == sum(1 for p in shared if valid[p])


@pytest.mark.parametrize("n_shards, block", [(8, 5), (3, 7), (2, 16384)])
def test_sharded_covisibility_in_sub_blocks_equals_dense(n_shards, block):
    """Each shard's product formed `block` points at a time (the blocking
    the card uses at 200,000 slots), with ragged last blocks."""
    _, m = _random_map(seed=1, Pcap=103, n_pt=90, culled=11)
    assert torch.equal(sharded_covisibility_weights(m, ["cpu"] * n_shards, block=block), covisibility_weights(m))


def _frame(m, rng, nk=40):
    """40 keypoints, the first 20 re-detections of points 0..19 (their
    projection plus sub-radius jitter, their descriptor)."""
    uv = project(CAM, se3_apply(torch.eye(3), torch.zeros(3), m.pt_xyz[:20])).numpy()
    xy = rng.uniform(0, 240, (nk, 2)).astype(np.float32)
    xy[:20] = uv + rng.uniform(-3, 3, (20, 2))
    desc = rng.integers(0, 2**32, (nk, 8), dtype=np.uint32)
    desc[:20] = m.pt_desc[:20].numpy().view(np.uint32)
    return (array_to_tensor(xy, "cpu"), array_to_tensor(desc, "cpu"), torch.zeros(nk, dtype=torch.int32),
            torch.zeros(nk), torch.ones(nk, dtype=torch.bool))


def test_sharded_search_equals_dense_and_jax():
    jm, m = _random_map()
    rng = np.random.default_rng(2)
    kp = _frame(m, rng)
    R, t = torch.eye(3), torch.zeros(3)
    idx_s, dist_s, ok_s = sharded_search_local_points(CAM, m, MESH, R, t, *kp)
    mp = pad_point_capacity(m, 8)
    Pn = mp.capacity_pt
    pc = se3_apply(R, t, mp.pt_xyz)
    idx_d, dist_d, ok_d = search_by_projection_points(
        project(CAM, pc), mp.pt_desc, mp.pt_valid & (pc[:, 2] > 0.1), torch.full((Pn,), 15.0),
        torch.zeros(Pn, dtype=torch.int32), torch.full((Pn,), 7, dtype=torch.int32), *kp)
    assert torch.equal(ok_s, ok_d) and int(ok_d.sum()) > 0
    assert torch.equal(idx_s[ok_d], idx_d[ok_d]) and torch.equal(dist_s[ok_d], dist_d[ok_d])
    j_idx, _, j_ok = jsharded_search(JCAM, jm, _jmesh(), jnp.eye(3), jnp.zeros(3),
                                     *(jnp.asarray(x.numpy()) for x in (kp[0],)),
                                     jnp.asarray(kp[1].numpy().view(np.uint32)),
                                     *(jnp.asarray(x.numpy()) for x in kp[2:]))
    np.testing.assert_array_equal(ok_s.numpy(), np.asarray(j_ok))
    np.testing.assert_array_equal(idx_s[ok_s].numpy(), np.asarray(j_idx)[ok_s.numpy()])


def test_shard_map_state_splits_points_and_replicates_keyframes():
    _, m = _random_map()
    shards = shard_map_state(m, ["cpu"] * 3)
    mp = pad_point_capacity(m, 3)
    blk = mp.capacity_pt // 3
    assert len(shards) == 3 and blk * 3 == 102
    for s, ms in enumerate(shards):
        for f in m._fields:
            a, b = getattr(ms, f), getattr(mp, f)
            want = b[s * blk:(s + 1) * blk] if f in POINT_FIELDS else b
            assert a.device.type == "cpu" and torch.equal(a, want), (s, f)
    assert torch.equal(torch.cat([ms.pt_xyz for ms in shards])[:m.capacity_pt], m.pt_xyz)


def test_pad_point_capacity():
    _, m = _random_map()
    assert pad_point_capacity(m, 4) is m  # 100 slots: already a multiple
    p = pad_point_capacity(m, 8)
    assert p.capacity_pt == 104
    for f in POINT_FIELDS:
        a = getattr(p, f)
        assert a.shape[0] == 104 and a.dtype == getattr(m, f).dtype
        assert torch.equal(a[:100], getattr(m, f)) and not a[100:].any(), f
    for f in set(m._fields) - set(POINT_FIELDS):
        assert getattr(p, f) is getattr(m, f)
