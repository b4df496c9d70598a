"""Plain reference of the two kernels' work on a frame: the image pyramid,
FAST-9/16 with its 3x3 NMS, and the edge-padded uint8 patch atlas with the
47x47 windows gathered from it.

Plain torch, importing nothing of the program: the arithmetic of the
ORB-SLAM2 extractor as tpuslam_torch/ops/image.py, ops/fast.py and
ops/orb.py state it (commit 431b9431), written out again. `dtype` is the
precision every float step runs in: float32 as the configurations state,
bfloat16 for the control.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# FAST-9/16 Bresenham circle of radius 3, clockwise from 12 o'clock, (dx, dy).
FAST_OFFSETS = ((0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
                (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3))
PSIZE = 47      # patch side
ATLAS_PAD = 8   # edge padding of each level block in the atlas


def pyramid_shapes(h: int, w: int, n_levels: int, scale_factor: float) -> list:
    return [(int(round(h / scale_factor**l)), int(round(w / scale_factor**l))) for l in range(n_levels)]


def _resize(img: torch.Tensor, new_h: int, new_w: int) -> torch.Tensor:
    """Bilinear resize with half-pixel centres (cv::resize INTER_LINEAR).
    The sample positions are float32 whatever the image's dtype (they
    index); the weights and the pixels are in the image's dtype."""
    H, W = img.shape[-2:]
    dev, f32 = img.device, torch.float32
    ys = (torch.arange(new_h, dtype=f32, device=dev) + 0.5) * (H / new_h) - 0.5
    xs = (torch.arange(new_w, dtype=f32, device=dev) + 0.5) * (W / new_w) - 0.5
    y0 = torch.clamp(torch.floor(ys), 0, H - 1)
    x0 = torch.clamp(torch.floor(xs), 0, W - 1)
    y1 = torch.clamp(y0 + 1, 0, H - 1)
    x1 = torch.clamp(x0 + 1, 0, W - 1)
    wy = torch.clamp(ys - y0, 0.0, 1.0).to(img.dtype)
    wx = torch.clamp(xs - x0, 0.0, 1.0).to(img.dtype)
    r0, r1 = img[..., y0.long(), :], img[..., y1.long(), :]
    top = r0[..., x0.long()] * (1 - wx) + r0[..., x1.long()] * wx
    bot = r1[..., x0.long()] * (1 - wx) + r1[..., x1.long()] * wx
    return top * (1 - wy)[:, None] + bot * wy[:, None]


def pyramid(imgs: torch.Tensor, n_levels: int, scale_factor: float, dtype=torch.float32) -> list:
    """Cascaded pyramid of (B, H, W) images: level l resized from l - 1."""
    levels = [imgs.to(dtype).contiguous()]
    for h, w in pyramid_shapes(imgs.shape[-2], imgs.shape[-1], n_levels, scale_factor)[1:]:
        levels.append(_resize(levels[-1], h, w).contiguous())
    return levels


def fast_score(img: torch.Tensor, min_th: float) -> torch.Tensor:
    """OpenCV's FAST score of (B, H, W) images (the largest threshold at
    which 9 contiguous circle pixels are all brighter, or all darker), 0
    unless above min_th; circle reads replicate the edge."""
    H, W = img.shape[-2:]
    p = F.pad(img.reshape(-1, 1, H, W), (3, 3, 3, 3), mode="replicate").reshape(*img.shape[:-2], H + 6, W + 6)
    d = torch.stack([p[..., 3 + dy:3 + dy + H, 3 + dx:3 + dx + W] for dx, dy in FAST_OFFSETS], -1) - img[..., None]

    def arc9_min(x):
        m1 = torch.minimum(x, torch.roll(x, -1, dims=-1))
        m2 = torch.minimum(m1, torch.roll(m1, -2, dims=-1))
        m4 = torch.minimum(m2, torch.roll(m2, -4, dims=-1))
        return torch.minimum(m4, torch.roll(x, -8, dims=-1))

    score = torch.maximum(torch.amax(arc9_min(d), -1), torch.amax(arc9_min(-d), -1))
    return torch.where(score > min_th, score, torch.zeros_like(score))


def fast_nms(img: torch.Tensor, min_th: float) -> torch.Tensor:
    """FAST scores kept where they are the 3x3 maximum of score + the
    float32 tie-break bias lin * (-1e-6 / (H W)) (the smaller linear index
    wins a tie), 0 elsewhere."""
    score = fast_score(img, min_th)
    H, W = score.shape[-2:]
    step = float(np.float32(-1e-6 / (H * W)))
    lin = torch.arange(H * W, dtype=torch.float32, device=score.device).reshape(H, W)
    bias = (lin * torch.tensor(step, dtype=torch.float32, device=score.device)).to(score.dtype)
    s = score + torch.where(score > 0, bias, torch.zeros_like(score))
    pooled = F.max_pool2d(s.reshape(-1, 1, H, W).float(), 3, stride=1, padding=1).reshape(s.shape).to(s.dtype)
    return torch.where((s >= pooled) & (score > 0), score, torch.zeros_like(score))


def atlas(levels: list) -> torch.Tensor:
    """The stream-major (B * Ha, Wa) uint8 atlas: per stream, each level
    edge-padded by ATLAS_PAD, zero-filled on the right to the widest
    block, rounded half to even and clipped to [0, 255], stacked by rows."""
    W_atlas = levels[0].shape[-1] + 2 * ATLAS_PAD
    blocks = []
    for lvl in levels:
        b = F.pad(lvl[:, None], (ATLAS_PAD,) * 4, mode="replicate")[:, 0]
        b = F.pad(b, (0, W_atlas - b.shape[-1]))
        blocks.append(torch.clamp(torch.round(b), 0.0, 255.0).to(torch.uint8))
    a = torch.cat(blocks, dim=1)
    return a.reshape(a.shape[0] * a.shape[1], W_atlas)


def gather(atlas_u8: torch.Tensor, corner: torch.Tensor) -> torch.Tensor:
    """(N, 47, 47) float32 windows of the atlas at (N, 2) (row, col)."""
    ar = torch.arange(PSIZE, device=atlas_u8.device)
    rows = corner[:, 0].long()[:, None] + ar
    cols = corner[:, 1].long()[:, None] + ar
    return atlas_u8[rows[:, :, None], cols[:, None, :]].to(torch.float32)
