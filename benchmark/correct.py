"""The comparison that decides `correct`: what the timed path produced,
judged against the plain reference (benchmark/reference/) working from
the scene and the route the benchmark made from the seed.

The numbers, each held to the cell's limit (its data file's `limits`):
- rpe_t, rpe_r_deg: every pose the window returned, as the camera's motion
  between consecutive tracked frames against the true motion (translation
  RMS as a share of the route's step, after the monocular scale; rotation
  RMS in degrees);
- kf_rpe_t, kf_rpe_r_deg: the same for the keyframes the window inserted
  and the map kept, at their poses in the map after the window (the
  keyframe job's local BA has refined them), the translation as a share of
  the true spacing;
- pt_depth_err: the map's points, as those keyframes see them, against
  the true surface (point_numbers);
- map_kf, map_pt: the map's fill at the window's end, each held to a
  least number (the cell's `at_least`), so that the window times a map
  that keeps what it builds;
- fast_diff, patch_diff: elements where the kernels' outputs differ from
  the reference's (exact, limit 0): FAST+NMS over the frame's pyramid, and
  the 47x47 windows at the keypoints' corners. This is a pass of its own
  after the window, through the kernels' entry points, on a sample of the
  window's frames drawn from the seed: the window's graph replays keep no
  kernel output that the harness could read.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import kernels as ref_k
from benchmark.reference import points as ref_pt
from benchmark.reference import poses as ref_p


def _spread(x) -> dict:
    x = np.asarray(x, np.float64)
    return {"p50": float(np.median(x)), "p90": float(np.percentile(x, 90)), "max": float(x.max()),
            "argmax": int(np.argmax(x))} if x.size else {}


def pose_numbers(frame_ids, R, t, truth_R, truth_t, step: float, metric: bool, epochs=None) -> tuple:
    """({rpe_t, rpe_r_deg}, info) of the tracked frames (ids in order)
    against their true poses: the RMS over consecutive tracked frames of
    one map epoch (see session._epochs) of the motion's translation error
    as a share of the route's step (a monocular motion put at its true
    length first), and of its rotation error in degrees. Fewer than two
    such frames reads inf. The ATE (not compared) is over the last epoch."""
    epochs = np.zeros(len(frame_ids), np.int64) if epochs is None else np.asarray(epochs)
    same = epochs[1:] == epochs[:-1]
    if not same.any():
        return {"rpe_t": float("inf"), "rpe_r_deg": float("inf")}, {}
    last = epochs == epochs[-1]
    ate, (s, _, _) = (ref_p.ate(R[last], t[last], truth_R[last], truth_t[last], metric)
                      if last.sum() >= 3 else (float("nan"), (float("nan"), None, None)))
    dt, dr = ref_p.relative_errors(R, t, truth_R, truth_t, metric)
    dt, dr = dt[same], dr[same]
    frame_ids = np.asarray(frame_ids)[1:][same]
    Cg = ref_p.centres(truth_R[last], truth_t[last])
    span = float(np.sum(np.linalg.norm(np.diff(Cg, axis=0), axis=1)))
    sp = _spread(dt / step)
    sp["worst_frame"] = int(frame_ids[sp.pop("argmax")])
    return ({"rpe_t": ref_p.rms(dt) / step, "rpe_r_deg": ref_p.rms(dr)},
            {"ate_m": ate, "ate_share": ate / span if span else float("inf"), "scale": s,
             "rpe_t_share": sp, "rpe_r_deg_p90": float(np.percentile(dr, 90))})


def window_keyframes(map_h: dict, first_id: int) -> np.ndarray:
    """Slots of the valid keyframes made from frames >= first_id, by frame."""
    fid = map_h["kf_frame_id"].astype(np.int64)
    slots = np.nonzero(map_h["kf_valid"].astype(bool) & (fid >= first_id))[0]
    return slots[np.argsort(fid[slots])]


def keyframe_numbers(map_h: dict, first_id: int, truth_of, metric: bool) -> tuple:
    """({kf_rpe_t, kf_rpe_r_deg}, info) of the keyframes made from frames
    >= first_id, at their poses in the map, against the truth at their
    frames: pose_numbers' errors, the translation as a share of the RMS
    true spacing of the keyframes."""
    slots = window_keyframes(map_h, first_id)
    if len(slots) < 2:
        return {"kf_rpe_t": float("inf"), "kf_rpe_r_deg": float("inf")}, {"n_kf": len(slots)}
    R, t = map_h["kf_R"][slots].astype(np.float64), map_h["kf_t"][slots].astype(np.float64)
    Rg, tg = truth_of(map_h["kf_frame_id"][slots].astype(np.int64))
    dt, dr = ref_p.relative_errors(R, t, Rg, tg, metric)
    spacing = ref_p.rms(np.linalg.norm(np.diff(ref_p.centres(Rg, tg), axis=0), axis=1))
    return {"kf_rpe_t": ref_p.rms(dt) / spacing, "kf_rpe_r_deg": ref_p.rms(dr)}, {"n_kf": len(slots)}


def point_numbers(map_h: dict, first_id: int, truth_of, scene, metric: bool) -> tuple:
    """({pt_depth_err}, info): the median, over every valid point that a
    keyframe made from frame first_id on observes, of the point's relative
    depth error in that keyframe's camera against the true depth along the
    same ray (reference/points.depth_errors; a monocular keyframe's depths
    put at the truth's by their median ratio; a point behind the camera or
    not finite counts as an infinite error). `scene` gives the slabs:
    depths, x_lo, band. No such point reads inf."""
    slots = window_keyframes(map_h, first_id)
    pv = map_h["pt_valid"].astype(bool)
    Rg, tg = truth_of(map_h["kf_frame_id"][slots].astype(np.int64))
    errs = []
    for k, slot in enumerate(slots):
        ids = map_h["kf_obs_pt"][slot].astype(np.int64)
        ids = ids[(ids >= 0) & (ids < len(pv))]
        ids = ids[pv[ids]]
        if len(ids):
            errs.append(ref_pt.depth_errors(map_h["kf_R"][slot], map_h["kf_t"][slot], map_h["pt_xyz"][ids],
                                            Rg[k], tg[k], scene.depths, scene.x_lo, scene.band, metric))
    e = np.concatenate(errs) if errs else np.zeros(0)
    e = e[~np.isnan(e)]
    if not e.size:
        return {"pt_depth_err": float("inf")}, {"pt_obs": 0}
    return ({"pt_depth_err": float(np.median(e))},
            {"pt_obs": int(e.size), "pt_depth_err_p90": float(np.quantile(e, 0.9, method="lower")),
             "pt_over_5pct": float(np.mean(e > 0.05))})


def fill_numbers(map_h: dict) -> dict:
    """The map's fill: valid keyframes and points."""
    return {"map_kf": int(map_h["kf_valid"].astype(bool).sum()),
            "map_pt": int(map_h["pt_valid"].astype(bool).sum())}


def kernel_numbers(views_list, orb: dict, program, dtype=torch.float32, device="cuda") -> dict:
    """fast_diff and patch_diff over the frames in views_list (each a
    tuple of host uint8 images, the stereo pair as one batch of 2): the
    program's kernels (FAST+NMS over its pyramid of the frame; the gather
    of its keypoints' windows from its atlas) against the reference's
    pyramid, FAST+NMS and atlas. With `program` None the reference in
    `dtype` stands in the program's place (the control), still held to
    the float32 reference. The corners are the program's detection's,
    where the kernel was given them."""
    fast_diff = patch_diff = 0
    nl, sf, th = orb["n_levels"], orb["scale_factor"], orb["min_th_fast"]
    for views in views_list:
        imgs = torch.stack([torch.from_numpy(np.ascontiguousarray(v)) for v in views]).to(device).float()
        ref_levels = ref_k.pyramid(imgs, nl, sf)
        ref_fast = [ref_k.fast_nms(x, th) for x in ref_levels]
        ref_atlas = ref_k.atlas(ref_levels)
        if program is not None:
            levels = program.build_pyramid(imgs, nl, sf)
            got_fast = program.fast_nms_pyramid(levels, th)
            det = program.detect_batched(imgs, program.ORBConfig(**orb))
            corner = det[5]
            got_patch = program.gather_patches(det[4], corner)
        else:  # the control: the reference at `dtype` in the program's place
            levels = ref_k.pyramid(imgs, nl, sf, dtype)
            got_fast = [ref_k.fast_nms(x, th) for x in levels]
            corner = _corners_like(ref_atlas, imgs.shape[0], orb)
            got_patch = ref_k.gather(ref_k.atlas(levels), corner)
        fast_diff += sum(int((g.float() != r).sum()) for g, r in zip(got_fast, ref_fast))
        patch_diff += int((got_patch != ref_k.gather(ref_atlas, corner)).sum())
    return {"fast_diff": fast_diff, "patch_diff": patch_diff}


def _corners_like(atlas_u8: torch.Tensor, B: int, orb: dict) -> torch.Tensor:
    """Corners for the control, where no detection ran: n_features windows
    per stream spread over its blocks (the control's gather is judged
    at the same corners against the float32 atlas)."""
    Ha = atlas_u8.shape[0] // B
    Wa = atlas_u8.shape[1]
    n = int(orb["n_features"])
    g = torch.Generator().manual_seed(0)
    rows = torch.randint(0, Ha - ref_k.PSIZE + 1, (B, n), generator=g)
    rows = rows + torch.arange(B)[:, None] * Ha
    cols = torch.randint(0, Wa - ref_k.PSIZE, (B, n), generator=g)
    return torch.stack([rows, cols], -1).reshape(-1, 2).to(torch.int32).to(atlas_u8.device)


def decide(numbers: dict, limits: dict, at_least: dict | None = None) -> tuple:
    """(correct, [(name, value, limit, sense)]): every number of `limits`
    at or under its limit ("at_most"), every number of `at_least` at or
    over its own ("at_least"); a number that is missing or not finite
    fails."""
    at_least = at_least or {}
    rows = ([(k, float(numbers[k]), float(v), "at_most") for k, v in limits.items() if k in numbers]
            + [(k, float(numbers[k]), float(v), "at_least") for k, v in at_least.items() if k in numbers])
    ok = (all(k in numbers for k in list(limits) + list(at_least))
          and all(np.isfinite(v) and (v <= lim if sense == "at_most" else v >= lim)
                  for _, v, lim, sense in rows))
    return ok, rows
