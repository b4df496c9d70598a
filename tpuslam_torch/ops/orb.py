"""ORB feature extraction over a batch of streams. Port of tpuslam/ops/orb.py.

Pyramid, FAST+NMS of every level in one launch (kernel 1, ops/fast.py) and
spatially uniform per-cell selection, then one orientation + descriptor pass over all levels
and streams: the edge-padded uint8 levels of every stream are stacked into
one atlas, the 47x47 patch of every keypoint is gathered from it (kernel 2,
ops/patches.py), and the intensity-centroid angle, the 7x7 blur and the
steered 256-bit BRIEF are batched tensor math on the patches.

Descriptors are (..., 8) int32: the JAX package's uint32 words as bit
patterns (torch has no uint32 shifts); convert.py crosses between the two.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from tpuslam_torch.ops.fast import fast_nms_pyramid
from tpuslam_torch.ops.image import _gaussian_kernel_1d, build_pyramid
from tpuslam_torch.ops.patches import PSIZE, gather_patches

_DETECT_BORDER = 16  # no keypoint within 16 px of a level's edge
HALF_PATCH = 15      # orientation patch radius (IC_Angle)
_N_PAIRS = 256
_PAD = 8             # atlas edge padding so patches never leave their level
_BLUR_PATCH = 41     # blurred interior of the raw patch
_CENTER_RAW = 23     # keypoint position inside the raw patch
_CENTER_BLUR = 20    # keypoint position inside the blurred patch

BRIEF_PATTERN_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "tpuslam", "data", "brief_pattern.npz",
)


def _load_brief_pattern() -> np.ndarray:
    """The JAX package's shipped learned pattern, (256, 2, 2) int32 (pair,
    point, xy). A missing or malformed file raises: any other pattern gives
    descriptors that match nothing the JAX package produced."""
    pat = np.load(BRIEF_PATTERN_PATH)["pattern"].astype(np.int32)
    if pat.shape != (_N_PAIRS, 2, 2):
        raise ValueError(f"{BRIEF_PATTERN_PATH}: pattern shape {pat.shape}, want (256, 2, 2)")
    return pat


BRIEF_PATTERN = _load_brief_pattern()


@dataclasses.dataclass(frozen=True)
class ORBConfig:
    """Extraction settings (the ORBextractor.* block of a settings file)."""

    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: float = 20.0
    min_th_fast: float = 7.0
    cell_size: int = 30

    def level_budgets(self) -> tuple:
        """Geometric per-level feature budget (ORBextractor ctor)."""
        factor = 1.0 / self.scale_factor
        n_desired = self.n_features * (1 - factor) / (1 - factor**self.n_levels)
        budgets = []
        total = 0
        for _ in range(self.n_levels - 1):
            b = int(round(n_desired))
            budgets.append(b)
            total += b
            n_desired *= factor
        budgets.append(max(self.n_features - total, 0))
        return tuple(budgets)

    def level_scales(self) -> tuple:
        return tuple(self.scale_factor**l for l in range(self.n_levels))


class ORBFeatures(NamedTuple):
    """Fixed-capacity keypoint arrays (N = config.n_features), level-0 coords."""

    xy: torch.Tensor        # (..., N, 2) float32
    response: torch.Tensor  # (..., N) float32 FAST score
    angle: torch.Tensor     # (..., N) float32 radians
    level: torch.Tensor     # (..., N) int32 pyramid octave
    desc: torch.Tensor      # (..., N, 8) int32 bit patterns of uint32 words
    valid: torch.Tensor     # (..., N) bool


def _stable_topk(x: torch.Tensor, k: int):
    """top-k along the last dim, ties to the lower index (lax.top_k's rule;
    torch.topk does not promise it)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _select_level_keypoints(score: torch.Tensor, n_keep: int, cell_size: int, ini_th: float):
    """Spatially uniform top-n_keep selection from (..., H, W) response maps:
    candidates ranked inside their cell_size cell, then taken by (rank in
    cell, -response); a cell whose best response is >= ini_th keeps only its
    >= ini_th corners. Returns (xy (..., n_keep, 2) int32, resp, valid)."""
    H, W = score.shape[-2:]
    lead = score.shape[:-2]
    dev = score.device
    ys_g = torch.arange(H, device=dev)[:, None]
    xs_g = torch.arange(W, device=dev)[None, :]
    in_border = (
        (xs_g >= _DETECT_BORDER) & (xs_g < W - _DETECT_BORDER)
        & (ys_g >= _DETECT_BORDER) & (ys_g < H - _DETECT_BORDER)
    )
    s = torch.where(in_border, score, torch.zeros_like(score))

    n_cells_y = (H + cell_size - 1) // cell_size
    n_cells_x = (W + cell_size - 1) // cell_size
    n_cells = n_cells_y * n_cells_x
    area = cell_size * cell_size
    sp = F.pad(s, (0, n_cells_x * cell_size - W, 0, n_cells_y * cell_size - H))
    cells = sp.reshape(*lead, n_cells_y, cell_size, n_cells_x, cell_size)
    cells = cells.transpose(-3, -2).reshape(*lead, n_cells, area)

    r = min(max(8, -(-4 * n_keep // n_cells)), area, n_keep)
    resp_c, idx_c = _stable_topk(cells, r)  # (..., n_cells, r)
    valid = resp_c > 0.0
    valid &= ~((resp_c[..., :1] >= ini_th) & (resp_c < ini_th))

    ci = torch.arange(n_cells, device=dev)[:, None]
    ys = (ci // n_cells_x) * cell_size + idx_c // cell_size
    xs = (ci % n_cells_x) * cell_size + idx_c % cell_size

    rank = torch.arange(r, dtype=torch.float32, device=dev)[None, :]
    prio = rank * 4096.0 - torch.clamp(resp_c, 0, 4095.0)
    prio = torch.where(valid, prio, torch.full_like(prio, float("inf")))
    _, final = _stable_topk(-prio.reshape(*lead, -1), n_keep)
    out_valid = torch.gather(valid.reshape(*lead, -1), -1, final) & (
        torch.arange(n_keep, device=dev) < n_cells * r
    )
    xy = torch.stack(
        [torch.gather(xs.reshape(*lead, -1), -1, final),
         torch.gather(ys.reshape(*lead, -1), -1, final)],
        dim=-1,
    ).to(torch.int32)
    return xy, torch.gather(resp_c.reshape(*lead, -1), -1, final), out_valid


@functools.cache
def _describe_constants(device: torch.device) -> tuple:
    """(m10 mask, m01 mask, BRIEF pattern as float32) on `device`, built
    once per device. The masks are the circular first-moment masks (47, 47)
    centered at _CENTER_RAW."""
    r = HALF_PATCH
    dy, dx = np.mgrid[-r : r + 1, -r : r + 1]
    umax = np.round(np.sqrt(np.maximum(r * r - dy * dy, 0.0)))
    mask = (np.abs(dx) <= umax).astype(np.float32)
    m10 = np.zeros((PSIZE, PSIZE), np.float32)
    m01 = np.zeros((PSIZE, PSIZE), np.float32)
    c = _CENTER_RAW
    m10[c - r : c + r + 1, c - r : c + r + 1] = dx * mask
    m01[c - r : c + r + 1, c - r : c + r + 1] = dy * mask
    return tuple(
        torch.from_numpy(a).to(device=device, dtype=torch.float32)
        for a in (m10, m01, BRIEF_PATTERN)
    )


def _blur_patches(p: torch.Tensor) -> torch.Tensor:
    """Batched 7x7 sigma-2 Gaussian on (N, 47, 47) -> (N, 41, 41) valid part."""
    k = [float(v) for v in _gaussian_kernel_1d(7, 2.0)]
    acc = torch.zeros((p.shape[0], PSIZE, _BLUR_PATCH), dtype=p.dtype, device=p.device)
    for i in range(7):
        acc = acc + k[i] * p[:, :, i : i + _BLUR_PATCH]
    out = torch.zeros((p.shape[0], _BLUR_PATCH, _BLUR_PATCH), dtype=p.dtype, device=p.device)
    for i in range(7):
        out = out + k[i] * acc[:, i : i + _BLUR_PATCH, :]
    return out


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 256) bool -> (..., 8) int32 bit patterns of the uint32 words
    (bit j of word w = bits[32 w + j]); packed in int64, kept low 32 bits."""
    b = bits.reshape(*bits.shape[:-1], 8, 32).to(torch.int64)
    words = torch.sum(b << torch.arange(32, device=bits.device), dim=-1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def _orient_and_describe_at(atlas: torch.Tensor, corner: torch.Tensor):
    """Angle (N,) and descriptor (N, 8) int32 of the keypoints whose 47x47
    patches start at corner (N, 2) int32 (row, col) of the atlas."""
    n = corner.shape[0]
    dev = atlas.device
    praw = gather_patches(atlas, corner)
    m10_mask, m01_mask, pat = _describe_constants(dev)
    # Integer moments below 2^24: exact in any summation order.
    m10 = torch.sum(praw * m10_mask, dim=(1, 2))
    m01 = torch.sum(praw * m01_mask, dim=(1, 2))
    angle = torch.atan2(m01, m10)

    # Round the blurred patch to integers, as the reference blurs an 8-bit
    # image into an 8-bit image (round half to even, as jnp.round).
    pblur = torch.round(_blur_patches(praw))
    ca, sa = torch.cos(angle)[:, None, None], torch.sin(angle)[:, None, None]
    px = pat[None, :, :, 0]
    py = pat[None, :, :, 1]
    cols = torch.round(px * ca - py * sa).long()
    rows = torch.round(px * sa + py * ca).long()
    r = (rows + _CENTER_BLUR).reshape(n, 2 * _N_PAIRS)
    c = (cols + _CENTER_BLUR).reshape(n, 2 * _N_PAIRS)
    vals = pblur[torch.arange(n, device=dev)[:, None], r, c].reshape(n, _N_PAIRS, 2)
    return angle, _pack_bits(vals[:, :, 0] < vals[:, :, 1])


def _atlas_block(lvl: torch.Tensor, W_atlas: int) -> torch.Tensor:
    """(B, H, W) level images -> (B, H + 2 PAD, W_atlas) uint8: edge-padded
    by _PAD, zero-filled on the right to the atlas width, rounded half to
    even and clipped to [0, 255]."""
    blk = F.pad(lvl[:, None], (_PAD, _PAD, _PAD, _PAD), mode="replicate")[:, 0]
    blk = F.pad(blk, (0, W_atlas - blk.shape[-1]))
    return torch.clamp(torch.round(blk), 0.0, 255.0).to(torch.uint8)


def build_patch_atlas(levels):
    """Single-pyramid uint8 patch atlas: the edge-padded blocks of the
    (H_l, W_l) `levels` stacked row-wise, the layout gather_patches takes.
    Returns (atlas (Ha, Wa) uint8, row offset of each level (n_levels,)
    np.int32, Wa). Stream b's slab of detect_batched's atlas, rows
    [b Ha, (b + 1) Ha), is this atlas of b's pyramid."""
    W_atlas = levels[0].shape[-1] + 2 * _PAD
    blocks, offs, off = [], [], 0
    for lvl in levels:
        blocks.append(_atlas_block(lvl[None], W_atlas)[0])
        offs.append(off)
        off += blocks[-1].shape[0]
    return torch.cat(blocks, dim=0), np.asarray(offs, np.int32), W_atlas


def detect_batched(imgs: torch.Tensor, config: ORBConfig):
    """Everything before the descriptors, for (B, H, W) images: pyramid,
    FAST+NMS of every level with a budget (one kernel launch), selection per
    level, and the stream-major uint8 atlas of edge-padded levels with each
    keypoint's 47x47 patch corner in it. Every level has its block, so each
    stream's slab is build_patch_atlas of its pyramid.
    Returns (xy, response, level, valid), each (B, N, ...), then atlas
    (B * Ha, Wa) uint8 and corner (B * N, 2) int32."""
    B = imgs.shape[0]
    dev = imgs.device
    levels = build_pyramid(imgs, config.n_levels, config.scale_factor)
    budgets = config.level_budgets()
    scales = config.level_scales()

    used = [l for l, n_l in enumerate(budgets) if n_l > 0]
    scores = dict(zip(used, fast_nms_pyramid([levels[l] for l in used], config.min_th_fast)))

    xs, resps, valids, lvls, corners, atlas_blocks = [], [], [], [], [], []
    row_off = 0
    W_atlas = levels[0].shape[-1] + 2 * _PAD
    for l, lvl_imgs in enumerate(levels):
        # Edge-padded uint8 level block; the detection border keeps every
        # valid keypoint's 47x47 patch inside its own block.
        atlas_blocks.append(_atlas_block(lvl_imgs, W_atlas))
        block_row, row_off = row_off, row_off + atlas_blocks[-1].shape[-2]
        if l not in scores:
            continue
        n_l = budgets[l]
        xy, resp, valid = _select_level_keypoints(scores[l], n_l, config.cell_size, config.ini_th_fast)
        cy = torch.clamp(xy[..., 1] + (_PAD - _CENTER_RAW + block_row), min=0)
        cx = torch.clamp(xy[..., 0] + (_PAD - _CENTER_RAW), min=0)
        corners.append(torch.stack([cy, cx], dim=-1))
        # float32(scale) * float32(xy), as the JAX package's weakly typed product.
        xs.append(xy.to(torch.float32) * float(np.float32(scales[l])))
        resps.append(resp)
        valids.append(valid)
        lvls.append(torch.full((B, n_l), l, dtype=torch.int32, device=dev))

    # Stream-major atlas: stream b's levels live in rows [b*Ha, (b+1)*Ha).
    atlas = torch.cat(atlas_blocks, dim=1)
    Ha = atlas.shape[1]
    atlas = atlas.reshape(B * Ha, W_atlas)
    corner = torch.cat(corners, dim=1)  # (B, N, 2)
    corner = corner + torch.stack(
        [torch.arange(B, device=dev, dtype=torch.int32) * Ha,
         torch.zeros(B, device=dev, dtype=torch.int32)], dim=-1,
    )[:, None, :]
    # Invalid keypoints may sit in the cell padding past a level's edge; clamp
    # their windows into the atlas as the JAX package's dynamic_slice does.
    corner = torch.stack(
        [torch.clamp(corner[..., 0], 0, B * Ha - PSIZE),
         torch.clamp(corner[..., 1], 0, W_atlas - PSIZE)], dim=-1,
    ).to(torch.int32).reshape(-1, 2).contiguous()
    return (torch.cat(xs, dim=1), torch.cat(resps, dim=1), torch.cat(lvls, dim=1),
            torch.cat(valids, dim=1), atlas, corner)


def extract_orb_batched_atlas(imgs: torch.Tensor, config: ORBConfig):
    """extract_orb_batched, and the stream-major (B * Ha, Wa) uint8 atlas
    its descriptors were gathered from (detect_batched's), which the stereo
    SAD refinement reuses."""
    xy, response, level, valid, atlas, corner = detect_batched(imgs, config)
    B, n = level.shape
    angle, desc = _orient_and_describe_at(atlas, corner)
    return ORBFeatures(xy=xy, response=response, angle=angle.reshape(B, n), level=level,
                       desc=desc.reshape(B, n, 8), valid=valid), atlas


def extract_orb_batched(imgs: torch.Tensor, config: ORBConfig) -> ORBFeatures:
    """ORB extraction for (B, H, W) grayscale images in [0, 255]. Outputs are
    (B, n_features, ...) with a validity mask; coordinates are level 0."""
    return extract_orb_batched_atlas(imgs, config)[0]


def extract_orb(img: torch.Tensor, config: ORBConfig) -> ORBFeatures:
    """ORB extraction for one (H, W) image: extract_orb_batched with B = 1."""
    f = extract_orb_batched(img[None], config)
    return ORBFeatures(*(leaf[0] for leaf in f))
