"""Sequence loaders for TUM RGB-D, KITTI odometry and EuRoC MAV datasets.
Port of tpuslam/io/datasets.py.

They mirror the reference drivers' file handling: TUM rgb.txt/depth.txt and
association files (Examples/RGB-D/rgbd_tum.cc, Examples/Monocular/
mono_tum.cc), KITTI image_0/image_1 and times.txt
(Examples/Stereo/stereo_kitti.cc), EuRoC mav0/cam0/data and external
timestamp lists (Examples/Monocular/mono_euroc.cc).

Images decode without PIL, through the host library's PNG decoder
(io/native.decode_png_raw), to float32 grayscale [0, 255] with PIL's rules,
so every image equals the JAX package's bit for bit: 8-bit and 16-bit grey
as stored, grey+alpha as its grey, RGB and RGBA as PIL's convert("L"), the
integer ITU-R 601-2 luma (R 19595 + G 38470 + B 7471 + 0x8000) >> 16.
Other formats raise.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np

from tpuslam_torch.io.native import decode_png_raw


def _gray(px: np.ndarray) -> np.ndarray:
    """(H, W, C) PNG samples (decode_png_raw) -> (H, W) float32 grey by
    PIL's rules."""
    c = px.shape[-1]
    if c in (1, 2):  # grey (8 or 16 bit), or grey+alpha: the grey channel
        return px[..., 0].astype(np.float32)
    rgb = px[..., :3].astype(np.int32)
    luma = (rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000) >> 16
    return luma.astype(np.float32)


def load_grayscale(path: str) -> np.ndarray:
    """A PNG file as (H, W) float32 grey, equal to the JAX package's
    load_grayscale."""
    with open(path, "rb") as f:
        return _gray(decode_png_raw(f.read()))


def _list_lines(path: str):
    """The non-empty, non-comment lines of a text file, split."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line.split()


class TUMSequence:
    """TUM RGB-D sequence. With an association file (rgb<->depth pairing,
    Examples/RGB-D/associations/), yields (t, gray, depth in metres); with
    only rgb.txt, yields (t, gray, None)."""

    def __init__(self, root: str, association: Optional[str] = None, depth_factor=1.0 / 5000.0):
        self.root = root
        self.depth_factor = depth_factor
        if association is not None:
            # t_rgb rgb_path t_depth depth_path
            self.items = [(float(p[0]), p[1], p[3]) for p in _list_lines(association)]
        else:
            self.items = [(float(p[0]), p[1], None)
                          for p in _list_lines(os.path.join(root, "rgb.txt"))]

    def __len__(self):
        return len(self.items)

    def __iter__(self) -> Iterator:
        for t, rgb_rel, depth_rel in self.items:
            gray = load_grayscale(os.path.join(self.root, rgb_rel))
            depth = None
            if depth_rel is not None:
                # TUM depth PNGs are uint16 with 5000 units per metre.
                depth = load_grayscale(os.path.join(self.root, depth_rel)) * self.depth_factor
            yield t, gray, depth


class KITTISequence:
    """KITTI odometry sequence dir (image_0/, image_1/, times.txt).
    Yields (t, left, right); right is None if image_1 is absent."""

    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "times.txt")) as f:
            self.times = [float(x) for x in f]
        self.left_dir = os.path.join(root, "image_0")
        self.right_dir = os.path.join(root, "image_1")
        self.has_right = os.path.isdir(self.right_dir)

    def __len__(self):
        return len(self.times)

    def __iter__(self) -> Iterator:
        for i, t in enumerate(self.times):
            name = f"{i:06d}.png"
            left = load_grayscale(os.path.join(self.left_dir, name))
            right = load_grayscale(os.path.join(self.right_dir, name)) if self.has_right else None
            yield t, left, right


class EuRoCSequence:
    """EuRoC ASL layout (mav0/cam0/data, mav0/cam1/data) with an optional
    external timestamp list (the reference's EuRoC_TimeStamps files)."""

    def __init__(self, root: str, timestamps: Optional[str] = None, stereo: bool = True):
        self.root = root
        self.stereo = stereo
        cam0 = os.path.join(root, "mav0", "cam0", "data")
        if timestamps is not None:
            with open(timestamps) as f:
                self.stamps = [line.strip() for line in f if line.strip()]
        else:
            self.stamps = sorted(os.path.splitext(f)[0] for f in os.listdir(cam0))

    def __len__(self):
        return len(self.stamps)

    def __iter__(self) -> Iterator:
        for s in self.stamps:
            t = float(s) * 1e-9
            left = load_grayscale(os.path.join(self.root, "mav0", "cam0", "data", s + ".png"))
            right = None
            if self.stereo:
                right = load_grayscale(os.path.join(self.root, "mav0", "cam1", "data", s + ".png"))
            yield t, left, right
