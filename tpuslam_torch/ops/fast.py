"""FAST-9/16 corner score + 3x3 NMS: the CUDA kernel and its plain version.

Port of tpuslam/ops/orb.py::fast_response + _nms3 (the plain version) and of
the TPU kernel tpuslam/ops/fast_pallas.py::fast_nms_pallas, whose Hopper
counterpart is csrc/fast_nms.cu. Both give the same map bit for bit: circle
reads replicate the image edge, and the NMS tie-break bias is a float32
product. The kernel takes every level of a pyramid in one launch
(`fast_nms_pyramid`); `fast_nms` is its one-level case.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from tpuslam_torch import _build
from tpuslam_torch.ops.launch_count import count_launch
from tpuslam_torch.ops.orb_common import FAST_OFFSETS


def fast_response(img: torch.Tensor, min_th: float) -> torch.Tensor:
    """Dense FAST-9/16 response of (..., H, W) float32 images: OpenCV's FAST
    score (the largest threshold at which >= 9 contiguous circle pixels are
    all brighter, or all darker, than the center), 0 unless > min_th."""
    H, W = img.shape[-2:]
    p = F.pad(img.reshape(-1, 1, H, W), (3, 3, 3, 3), mode="replicate")
    p = p.reshape(*img.shape[:-2], H + 6, W + 6)
    circ = torch.stack(
        [p[..., 3 + dy : 3 + dy + H, 3 + dx : 3 + dx + W] for dx, dy in FAST_OFFSETS.tolist()],
        dim=-1,
    )
    d = circ - img[..., None]

    def arc9_min(x):
        """min over 9 consecutive circular entries, for each start index."""
        m1 = torch.minimum(x, torch.roll(x, -1, dims=-1))
        m2 = torch.minimum(m1, torch.roll(m1, -2, dims=-1))
        m4 = torch.minimum(m2, torch.roll(m2, -4, dims=-1))
        return torch.minimum(m4, torch.roll(x, -8, dims=-1))

    score = torch.maximum(
        torch.amax(arc9_min(d), dim=-1), torch.amax(arc9_min(-d), dim=-1)
    )
    return torch.where(score > min_th, score, torch.zeros_like(score))


def nms_bias_step(H: int, W: int) -> float:
    """float32 per-linear-index tie-break step of the NMS (a Python float that
    is exactly the float32 value, so the kernel and the plain version agree)."""
    return float(np.float32(-1e-6 / (H * W)))


def _nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 NMS of (..., H, W) maps: keep maxima of score + lin * step, the
    smaller linear index winning ties."""
    H, W = score.shape[-2:]
    lin = torch.arange(H * W, dtype=torch.float32, device=score.device).reshape(H, W)
    bias = lin * torch.tensor(nms_bias_step(H, W), dtype=torch.float32, device=score.device)
    s = score + torch.where(score > 0, bias, torch.zeros_like(score))
    # max_pool2d pads with -inf, as reduce_window's SAME padding does.
    pooled = F.max_pool2d(s.reshape(-1, 1, H, W), 3, stride=1, padding=1).reshape(s.shape)
    return torch.where((s >= pooled) & (score > 0), score, torch.zeros_like(score))


def fast_nms_plain(img: torch.Tensor, min_th: float) -> torch.Tensor:
    """The plain PyTorch version of the kernel: _nms3(fast_response(...))."""
    return _nms3(fast_response(img, min_th))


TILE_W, TILE_H = 30, 30  # output tile of csrc/fast_nms.cu (kOut, kOutH)


def level_table(shapes) -> tuple:
    """The kernel's level table from (B, H, W) shapes alone: one dict per
    level with its tiles across and down one stream and `tile0`, its first
    block; blocks [tile0, tile0 + B * tiles_y * tiles_x) of the one launch
    take the level's tiles stream by stream, row by row. Returns (table,
    number of blocks)."""
    if len(shapes) > _build.MAX_LEVELS:
        raise ValueError(f"fast_nms: {len(shapes)} levels, the kernel takes at most {_build.MAX_LEVELS}")
    table, n_tiles = [], 0
    for B, H, W in shapes:
        if H * W >= 1 << 24:
            raise ValueError(f"fast_nms: H*W = {H * W} exceeds float32-exact indices")
        tiles_x, tiles_y = -(-W // TILE_W), -(-H // TILE_H)
        table.append(dict(B=B, H=H, W=W, tiles_x=tiles_x, tiles_y=tiles_y, tile0=n_tiles,
                          bias_step=nms_bias_step(H, W)))
        n_tiles += B * tiles_x * tiles_y
    return table, n_tiles


@functools.lru_cache(maxsize=64)
def _params_template(shapes: tuple) -> bytes:
    """The FastLevels table of these shapes with null pointers, as bytes."""
    table, n_tiles = level_table(shapes)
    params = _build.FastLevels(n_levels=len(table), n_tiles=n_tiles)
    for lv, row in zip(params.lv, table):
        for k in ("B", "H", "W", "tiles_x", "tiles_y", "tile0", "bias_step"):
            setattr(lv, k, row[k])
    return bytes(params)


def _kernel_params(levels: list) -> tuple:
    """(the kernel's FastLevels table, the outputs it fills) for CUDA
    levels; checks dtype, layout and device, reads no tensor."""
    dev = levels[0].device
    for img in levels:
        if img.dtype != torch.float32 or img.dim() != 3 or not img.is_contiguous():
            raise ValueError(
                f"fast_nms kernel takes contiguous (B, H, W) float32 tensors, "
                f"got {tuple(img.shape)} {img.dtype} contiguous={img.is_contiguous()}"
            )
        if img.device != dev:
            raise ValueError(f"fast_nms: levels on {dev} and {img.device}")
    params = _build.FastLevels.from_buffer_copy(_params_template(tuple(tuple(img.shape) for img in levels)))
    outs = [torch.empty_like(img) for img in levels]
    for lv, img, out in zip(params.lv, levels, outs):
        lv.img, lv.out = img.data_ptr(), out.data_ptr()
    return params, outs


def _fast_nms_cuda(levels: list, min_th: float) -> list:
    params, outs = _kernel_params(levels)
    if params.n_tiles == 0:
        return outs
    dev = levels[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = _build.lib().tpuslam_fast_nms_pyramid(params, float(min_th), stream)
    _build.check(status, "fast_nms")
    count_launch(fast_nms)
    return outs


def fast_nms_pyramid(levels, min_th: float) -> list:
    """NMS'd FAST score maps of a list of (B_l, H_l, W_l) float32 levels (at
    most 8). CUDA tensors go through one launch of the kernel
    (csrc/fast_nms.cu) for all of them; CPU tensors through the plain
    version. `fast_nms.launches` counts kernel launches; a replay of a
    captured graph does not move it, so pipeline/graphs.py adds the
    graph's captured launches on each replay."""
    if min_th < 0:
        raise ValueError(f"fast_nms: min_th = {min_th} < 0")  # the kernel's one-sign arc search needs >= 0
    levels = list(levels)
    devices = {x.device.type for x in levels}
    if devices == {"cuda"}:
        return _fast_nms_cuda(levels, min_th)
    if devices <= {"cpu"}:
        return [fast_nms_plain(x, min_th) for x in levels]
    raise ValueError(f"fast_nms: unsupported devices {sorted(devices)}")


def fast_nms(img: torch.Tensor, min_th: float) -> torch.Tensor:
    """NMS'd FAST score map of (B, H, W) float32 images: fast_nms_pyramid
    of one level. `fast_nms.launches` counts kernel launches."""
    return fast_nms_pyramid([img], min_th)[0]


fast_nms.launches = 0
