"""Stereo keypoint matching: row-banded Hamming search, then SAD subpixel
refinement. Port of tpuslam/ops/stereo.py (Frame::ComputeStereoMatches).

Each left keypoint is matched to the right keypoints in a row band (radius
2 x its octave's scale), within the disparity range [0, fx], by descriptor
distance < (TH_HIGH + TH_LOW) / 2 = 75; the match is refined with an 11x11
SAD slide of +-5 columns on the keypoint's pyramid level and a parabola
fit, and outliers are culled against 2.1 x the median SAD.

The windows come from a single-pyramid uint8 atlas (ops/orb.py's layout)
through gather_patches (kernel 2): the left and the right windows in one
launch. `stereo_match` builds the atlas from the two pyramids, as the JAX
function does; `stereo_match_atlas` takes an atlas that already holds both
pyramids, such as the describe stage's stream-major atlas of a stereo
batch, and reads nothing back from the device. Its per-level tables are
built once per (pyramid shapes, scale factor, device).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from tpuslam_torch.mapstate.core import _nanmedian_last
from tpuslam_torch.matching.hamming import hamming_matrix
from tpuslam_torch.ops.orb import _CENTER_RAW, _PAD, ORBConfig, ORBFeatures, build_patch_atlas
from tpuslam_torch.ops.patches import PSIZE, gather_patches

_BIG = 1 << 20
_W = 5  # SAD half-window (Frame.cc:799, w = 5)
_L = 5  # SAD slide radius (Frame.cc:805, L = 5)
TH_ORB = (100 + 50) // 2  # (TH_HIGH + TH_LOW) / 2


class LevelTables(NamedTuple):
    """Per-level constants of the SAD refinement, (n_levels,) each."""

    scale: torch.Tensor   # float32 scale_factor ** l
    inv: torch.Tensor     # float32 1 / scale_factor ** l
    lo: torch.Tensor      # int32 first window row of the level's block
    hi: torch.Tensor      # int32 last window row of the level's block
    col_hi: torch.Tensor  # int32 last window column inside the level
    width: torch.Tensor   # int32 level width


@functools.lru_cache(maxsize=None)
def level_tables(shapes: tuple, scale_factor: float, device: torch.device) -> LevelTables:
    """The tables for pyramid level shapes ((H_l, W_l), ...) on `device`,
    built on the host from the shapes alone, once per argument set."""
    lo, off = [], 0
    for h, _ in shapes:
        lo.append(off)
        off += h + 2 * _PAD
    n = len(shapes)

    def t(vals, dtype):
        return torch.tensor(vals, dtype=dtype).to(device)

    return LevelTables(
        scale=t([scale_factor**l for l in range(n)], torch.float32),
        inv=t([1.0 / scale_factor**l for l in range(n)], torch.float32),
        lo=t(lo, torch.int32),
        hi=t([lo[l] + h + 2 * _PAD - PSIZE for l, (h, _) in enumerate(shapes)], torch.int32),
        col_hi=t([w + 2 * _PAD - PSIZE for _, w in shapes], torch.int32),
        width=t([w for _, w in shapes], torch.int32),
    )


def sad_windows(tabs: LevelTables, row_l: int, row_r: int, level: torch.Tensor, uL0: torch.Tensor,
                vL0: torch.Tensor, uR0_l0: torch.Tensor):
    """The 47x47 atlas windows of the SAD refinement: (corner (2N, 2) int32,
    the left windows then the right ones; iR_u0 (N,) the right column at
    the keypoint's level; inv (N,) 1 / its scale; in_level (N,) whether the
    11x11 window plus the slide stays inside the level image). The row and
    column clips keep every window inside its level block: rows to the
    block, columns to the level's own width (upper levels are narrower)."""
    lvl = level.long()
    inv = tabs.inv[lvl]
    iL_u = torch.round(uL0 * inv).to(torch.int32)
    iL_v = torch.round(vL0 * inv).to(torch.int32)
    iR_u0 = torch.round(uR0_l0 * inv).to(torch.int32)
    row = torch.clamp(tabs.lo[lvl] + _PAD + iL_v - _CENTER_RAW, tabs.lo[lvl], tabs.hi[lvl])
    col_hi = tabs.col_hi[lvl]
    zero = torch.zeros_like(col_hi)
    colL = torch.clamp(_PAD + iL_u - _CENTER_RAW, zero, col_hi)
    colR = torch.clamp(_PAD + iR_u0 - _CENTER_RAW, zero, col_hi)
    win = _W + _L
    in_level = (iR_u0 - win >= 0) & (iR_u0 + win < tabs.width[lvl])
    corner = torch.cat([torch.stack([row + row_l, colL], dim=-1),
                        torch.stack([row + row_r, colR], dim=-1)]).to(torch.int32).contiguous()
    return corner, iR_u0, inv, in_level


def _sad_refine_atlas(atlas: torch.Tensor, row_l: int, row_r: int, tabs: LevelTables,
                      level: torch.Tensor, uL0: torch.Tensor, vL0: torch.Tensor,
                      uR0_l0: torch.Tensor, active: torch.Tensor):
    """SAD subpixel refinement over every level at once, the left pyramid's
    blocks at atlas row `row_l`, the right one's at `row_r`. Returns
    (uR refined at level 0 (N,), best SAD (N,), ok (N,))."""
    corner, iR_u0, inv, in_level = sad_windows(tabs, row_l, row_r, level, uL0, vL0, uR0_l0)
    active = active & in_level
    p = gather_patches(atlas, corner)  # (2N, 47, 47), one launch
    n = uL0.shape[0]
    pL, pR = p[:n], p[n:]

    C = _CENTER_RAW
    patchL = pL[:, C - _W:C + _W + 1, C - _W:C + _W + 1] - pL[:, C:C + 1, C:C + 1]
    # Every slide's 11x11 right window: (N, 11 rows, 11 slides, 11 cols),
    # each less the right image at its own centre.
    band = pR[:, C - _W:C + _W + 1, C - _W - _L:C + _W + _L + 1]
    slides = band.unfold(2, 2 * _W + 1, 1)
    centre = pR[:, C, C - _L:C + _L + 1]
    # Integer-valued floats below 2^24: every sum is exact in any order.
    sad = torch.abs(patchL[:, :, None, :] - (slides - centre[:, None, :, None])).sum(dim=(1, 3))

    best = torch.argmin(sad, dim=1)  # the lowest index on a tie, as jnp.argmin
    best_sad = torch.gather(sad, 1, best[:, None])[:, 0]
    interior = (best > 0) & (best < 2 * _L)
    bi = torch.clamp(best, 1, 2 * _L - 1)
    d_m = torch.gather(sad, 1, (bi - 1)[:, None])[:, 0]
    d_0 = torch.gather(sad, 1, bi[:, None])[:, 0]
    d_p = torch.gather(sad, 1, (bi + 1)[:, None])[:, 0]
    denom = d_m + d_p - 2.0 * d_0
    delta = torch.where(torch.abs(denom) > 1e-6, (d_m - d_p) / (2.0 * denom),
                        torch.zeros_like(denom))
    ok = active & interior & (delta >= -1.0) & (delta <= 1.0)
    uR = iR_u0.to(torch.float32) + (bi - _L).to(torch.float32) + delta
    return uR / inv, best_sad, ok


def _sad_refine_all_levels(pyrL, pyrR, level, uL0, vL0, uR0_l0, active, config: ORBConfig):
    """The JAX function's form: single-pyramid atlases of both pyramids
    (stacked into one, so one gather takes both sides), then the
    refinement. Returns (uR refined at level 0, best SAD, ok)."""
    atlasL, _, _ = build_patch_atlas(pyrL)
    atlasR, _, _ = build_patch_atlas(pyrR)
    shapes = tuple(tuple(x.shape[-2:]) for x in pyrL)
    tabs = level_tables(shapes, config.scale_factor, atlasL.device)
    return _sad_refine_atlas(torch.cat([atlasL, atlasR]), 0, atlasL.shape[0], tabs,
                             level, uL0, vL0, uR0_l0, active)


def row_band_match(feats_left: ORBFeatures, feats_right: ORBFeatures, tabs: LevelTables,
                   fx: float):
    """Each left keypoint's best right keypoint by descriptor distance in
    its row band (2 x its octave's scale), octaves within one, disparity
    in [0, fx]: (i1 (N,), matched (N,): distance < TH_ORB). Unmatched rows
    take the first column of their row (i1 = 0 when none is in range)."""
    fL, fR = feats_left, feats_right
    sL = tabs.scale[fL.level.long()]
    uL, vL = fL.xy[:, 0], fL.xy[:, 1]
    uR, vR = fR.xy[:, 0], fR.xy[:, 1]
    min_d, max_d = 0.0, fx  # minZ = baseline, so maxD = bf / minZ = fx
    pair = (
        fL.valid[:, None] & fR.valid[None, :]
        & (torch.abs(vR[None, :] - vL[:, None]) <= (2.0 * sL)[:, None])
        & (fR.level[None, :] >= fL.level[:, None] - 1)
        & (fR.level[None, :] <= fL.level[:, None] + 1)
        & (uR[None, :] >= uL[:, None] - max_d)
        & (uR[None, :] <= uL[:, None] - min_d)
    )
    dist = torch.where(pair, hamming_matrix(fL.desc, fR.desc), _BIG)
    i1 = torch.argmin(dist, dim=1)  # the lowest index on a tie, as jnp.argmin
    return i1, torch.gather(dist, 1, i1[:, None])[:, 0] < TH_ORB


def stereo_match_atlas(feats_left: ORBFeatures, feats_right: ORBFeatures, atlas: torch.Tensor,
                       row_l: int, row_r: int, shapes: tuple, config: ORBConfig, fx: float,
                       bf: float):
    """stereo_match over an atlas that holds the left pyramid's blocks from
    row `row_l` and the right one's from `row_r` (build_patch_atlas's layout
    of `shapes`, the pyramid's level shapes). Returns (u_right, depth,
    valid), as stereo_match."""
    tabs = level_tables(tuple(shapes), config.scale_factor, atlas.device)
    fL, fR = feats_left, feats_right
    uL, vL = fL.xy[:, 0], fL.xy[:, 1]
    i1, matched = row_band_match(fL, fR, tabs, fx)
    # Unmatched rows read column i1 = 0: in range, and inactive.
    uR_l0, sad_best, ok_all = _sad_refine_atlas(
        atlas, row_l, row_r, tabs, fL.level, uL, vL, fR.xy[i1, 0], matched)
    uR_best = torch.where(ok_all, uR_l0, -1.0)
    sad_best = torch.where(ok_all, sad_best, float("inf"))

    disparity = uL - uR_best
    valid = ok_all & (disparity > 0.0) & (disparity < fx)

    # Median-SAD outlier cull (jnp.nanmedian's rule: an even count averages
    # the two middle values).
    med = _nanmedian_last(torch.where(valid, sad_best, float("nan")))
    med = torch.where(torch.isnan(med), float("inf"), med)
    valid = valid & (sad_best < 2.1 * med)

    disparity = torch.clamp(disparity, min=1e-6)
    depth = torch.where(valid, torch.full_like(disparity, bf) / disparity, 0.0)
    u_right = torch.where(valid, uR_best, -1.0)
    return u_right, depth, valid


def stereo_match(feats_left: ORBFeatures, feats_right: ORBFeatures, pyr_left, pyr_right,
                 config: ORBConfig, fx: float, bf: float):
    """Match left keypoints to the right image: ORBFeatures of each side in
    level-0 coordinates and each side's pyramid (lists of (H_l, W_l)) in.
    Returns (u_right (N,), depth (N,), valid (N,)): u_right is the refined
    right column at level 0, depth = bf / (uL - uR); invalid entries carry
    u_right = -1 and depth = 0."""
    atlasL, _, _ = build_patch_atlas(pyr_left)
    atlasR, _, _ = build_patch_atlas(pyr_right)
    shapes = tuple(tuple(x.shape[-2:]) for x in pyr_left)
    return stereo_match_atlas(feats_left, feats_right, torch.cat([atlasL, atlasR]), 0,
                              atlasL.shape[0], shapes, config, fx, bf)
