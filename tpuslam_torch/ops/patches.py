"""Per-keypoint patch gather: the CUDA kernel and its plain version.

Port of tpuslam/ops/patches.py: gather_patches_xla is the plain version, and
the TPU kernel gather_patches_pallas becomes csrc/gather_patches.cu, which
stages each window through shared memory by aligned 16-byte chunks (the
GPU's form of the TPU kernel's aligned DMA and _unshift).

A window outside the atlas is an error. On the CPU the wrapper raises; on
the card the kernel's device-side assert fails, reported at the next
synchronisation, so the wrapper reads nothing back from the device.
"""

from __future__ import annotations

import torch

from tpuslam_torch import _build
from tpuslam_torch.ops.launch_count import count_launch

PSIZE = 47  # patch side consumed by ops/orb.py


def _check_args(atlas: torch.Tensor, corner: torch.Tensor) -> None:
    """Dims, dtypes and devices, from the tensors' metadata alone."""
    if atlas.dim() != 2 or atlas.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"atlas must be (Ha, Wa) uint8 or float32, got {tuple(atlas.shape)} {atlas.dtype}")
    if corner.dim() != 2 or corner.shape[1] != 2 or corner.dtype != torch.int32:
        raise ValueError(f"corner must be (N, 2) int32, got {tuple(corner.shape)} {corner.dtype}")
    if corner.device != atlas.device:
        raise ValueError(f"atlas on {atlas.device}, corner on {corner.device}")


def _check_corners(atlas: torch.Tensor, corner: torch.Tensor) -> None:
    """Raise if a window leaves the atlas (reads the corners)."""
    Ha, Wa = atlas.shape
    outside = (corner < 0).any() | (corner[:, 0] > Ha - PSIZE).any() | (corner[:, 1] > Wa - PSIZE).any()
    if bool(outside):
        raise ValueError(f"patch corner outside the ({Ha}, {Wa}) atlas")


def gather_patches_plain(atlas: torch.Tensor, corner: torch.Tensor) -> torch.Tensor:
    """(N, PSIZE, PSIZE) float32: the window at each (row, col) corner."""
    ar = torch.arange(PSIZE, device=atlas.device)
    rows = corner[:, 0].long()[:, None] + ar
    cols = corner[:, 1].long()[:, None] + ar
    return atlas[rows[:, :, None], cols[:, None, :]].to(torch.float32)


def _gather_patches_cuda(atlas: torch.Tensor, corner: torch.Tensor) -> torch.Tensor:
    if not (atlas.is_contiguous() and corner.is_contiguous()):
        raise ValueError("gather_patches kernel takes contiguous atlas and corners")
    Ha, Wa = atlas.shape
    if Ha < PSIZE or Wa < PSIZE:
        raise ValueError(f"gather_patches: a ({Ha}, {Wa}) atlas holds no {PSIZE}x{PSIZE} window")
    n = corner.shape[0]
    out = torch.empty((n, PSIZE, PSIZE), dtype=torch.float32, device=atlas.device)
    if n == 0:
        return out
    fn = (
        _build.lib().tpuslam_gather_patches_u8
        if atlas.dtype == torch.uint8
        else _build.lib().tpuslam_gather_patches_f32
    )
    with torch.cuda.device(atlas.device):
        stream = torch.cuda.current_stream(atlas.device).cuda_stream
        status = fn(atlas.data_ptr(), corner.data_ptr(), out.data_ptr(), n, Ha, Wa, stream)
    _build.check(status, "gather_patches")
    count_launch(gather_patches)
    return out


def gather_patches(atlas: torch.Tensor, corner: torch.Tensor) -> torch.Tensor:
    """(N, PSIZE, PSIZE) float32 patches of a uint8 or float32 (Ha, Wa)
    atlas at (N, 2) int32 (row, col) corners, every window inside the atlas.
    A CUDA tensor goes through the kernel (csrc/gather_patches.cu), which
    asserts on the device that each window is inside; a CPU tensor through
    the plain version, after a check that raises. `gather_patches.launches`
    counts kernel launches; a replay of a captured graph does not move it,
    so pipeline/graphs.py adds the graph's captured launches on each
    replay."""
    _check_args(atlas, corner)
    if atlas.device.type == "cuda":
        return _gather_patches_cuda(atlas, corner)
    if atlas.device.type == "cpu":
        _check_corners(atlas, corner)
        return gather_patches_plain(atlas, corner)
    raise ValueError(f"gather_patches: unsupported device {atlas.device}")


gather_patches.launches = 0
