"""The port's tracking step in the large-map regime against the JAX
package's, on the CPU: local keyframes (local_keyframe_mask), a fixed-size
gather of their newest points (max_local_pts) and the compaction of the
frustum survivors (cand_cap), on the map of test_torch_track_map.py. Also
the index rules that have no one-call torch form: the ranking of tied
votes, jnp.nonzero with a static size, and the JAX scatter's handling of
repeated and out-of-bounds indices."""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.mapstate import core as jcore
from tpuslam.pipeline import steps as jsteps
from tpuslam_torch.convert import map_to_torch
from tpuslam_torch.pipeline import steps as tsteps
from tpuslam_torch.pipeline._index import nonzero_static, scatter_last, scatter_last_dropping

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_track_map import (  # noqa: E402
    SNAP,
    _features,
    _run_both,
    assert_step_matches,
    session,  # noqa: F401  (the module-scoped map fixture)
)

torch.set_num_threads(2)


@pytest.mark.parametrize("has_vel", [True, False])
@pytest.mark.parametrize("max_local_pts,cand_cap", [(1024, 512), (256, 128)])
def test_fused_track_frame_subset_matches_jax(session, has_vel, max_local_pts, cand_cap):  # noqa: F811
    """(1024, 512) holds every local point; (256, 128) overflows both
    blocks, so the newest-first selection and compaction decide."""
    s, _, _ = session
    ref, got = _run_both(s, _features(s), has_vel, max_local_pts=max_local_pts, cand_cap=cand_cap)
    assert_step_matches(ref, got)
    p = got[-1]
    assert p[tsteps.FUSED_ACCEPT] == 1 and p[tsteps.FUSED_N_TRACKED] >= 100
    st, _ = s.snapshots[SNAP]
    n_live = int(st.m.pt_valid.sum())
    assert (n_live > max_local_pts) == (max_local_pts == 256)


def _vote_map():
    """K=10 keyframes, N=20 slots, P=50 points. Keyframes 2, 3, 4 and 7
    each see 5 of the matched points 0..4 (a four-way tie), keyframe 9
    shares 18 points with keyframe 2, keyframe 6 is invalid."""
    K, N, P = 10, 20, 50
    m = {k: np.array(v) for k, v in jcore.make_empty_map(K, N, P)._asdict().items()}
    obs = np.full((K, N), -1, np.int32)
    for k in (2, 3, 4, 7):
        obs[k, :5] = np.arange(5)
    obs[2, 5:] = np.arange(5, 20)
    obs[9, :18] = np.arange(2, 20)
    obs[5, :3] = [0, 1, 30]
    obs[6, :5] = np.arange(5)
    obs[8, :4] = [40, 41, 42, 43]
    m["kf_obs_pt"] = obs
    m["kf_kp_valid"][:] = True
    m["kf_valid"][:] = True
    m["kf_valid"][6] = False
    m["pt_valid"][:45] = True
    m["n_kf"] = np.int32(K)
    m["n_pt"] = np.int32(45)
    return jcore.MapState(**{k: np.asarray(v, np.asarray(getattr(jcore.make_empty_map(1, 1, 1), k)).dtype)
                             for k, v in m.items()})


@pytest.mark.parametrize("case", ["tied_votes", "no_votes"])
@pytest.mark.parametrize("max_kfs", [2, 80])
def test_local_keyframe_mask_exact(case, max_kfs):
    m = _vote_map()
    obs = np.full(30, -1, np.int32)
    if case == "tied_votes":
        obs[[3, 7, 11, 12, 20]] = [0, 1, 2, 3, 4]
    ref = jsteps.local_keyframe_mask(jcore.MapState(*map(jnp.asarray, m)), jnp.asarray(obs),
                                     max_kfs=max_kfs, ref_kf=jnp.int32(8))
    got = tsteps.local_keyframe_mask(map_to_torch(m, "cpu"), torch.from_numpy(obs), max_kfs=max_kfs, ref_kf=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if case == "tied_votes":
        # The stable ranking keeps the lowest tied slots; keyframe 9 joins
        # as the best voter's covisible neighbour.
        assert got[[2, 9]].all() and got.sum() == (6 if max_kfs == 80 else 3)
    else:
        assert got.numpy().tolist() == [k == 8 for k in range(10)]


@pytest.mark.parametrize("n_true", [0, 5, 16, 40])
def test_nonzero_static_matches_jnp_nonzero(rng, n_true):
    """Fewer than, exactly and more than `size` true entries."""
    L = 16
    mask = np.zeros(64, bool)
    mask[rng.choice(64, n_true, replace=False)] = True
    for size, fill in ((L, 64), (L, -3), (80, 65)):
        ref = np.asarray(jnp.nonzero(jnp.asarray(mask), size=size, fill_value=fill)[0])
        got = nonzero_static(torch.from_numpy(mask), size, fill)
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("trailing", [False, True])
def test_scatter_rules_match_jax(rng, trailing):
    """.at[idx].set with repeated indices (the last write wins on XLA:CPU)
    and with index N (dropped): what obs_pt, already/found, insert_points'
    parked slot and the motion model's rejected rows rely on."""
    n, q = 12, 40
    idx = rng.integers(0, n, q)
    idx[:5] = 0  # a run of writes to slot 0, like every -1 observation
    shape = (q, 3) if trailing else (q,)
    src = rng.integers(-5, 5, shape).astype(np.int32)
    dst = np.full((n, 3) if trailing else (n,), 9, np.int32)
    ref = jnp.asarray(dst).at[jnp.asarray(idx)].set(jnp.asarray(src))
    got = scatter_last(torch.from_numpy(dst), torch.from_numpy(idx), torch.from_numpy(src))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    idx_oob = np.where(rng.uniform(size=q) < 0.4, n, idx)
    ref = jnp.asarray(dst).at[jnp.asarray(idx_oob)].set(jnp.asarray(src))
    got = scatter_last_dropping(torch.from_numpy(dst), torch.from_numpy(idx_oob), torch.from_numpy(src))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
