"""Stereo rectification maps and remap (EuRoC online rectification). Port
of tpuslam/io/rectify.py.

Counterpart of the cv::initUndistortRectifyMap and cv::remap calls of the
reference's EuRoC stereo driver (Examples/Stereo/stereo_euroc.cc:63-100):
each camera's K, D (radtan), rectifying rotation R and new projection P
from the settings YAML give per-pixel source-coordinate maps, built once
per camera in float64 numpy on the host; frames are remapped bilinearly on
the images' device, so a pair is rectified on the card before track_stereo.
"""

from __future__ import annotations

import numpy as np
import torch


def init_rectify_map(K, D, R, P, width: int, height: int):
    """Build (map_x, map_y) float32 arrays of source pixel coordinates.

    For each rectified pixel: back-project through P, rotate by R^-1 into
    the original camera, apply radtan distortion, project through K (the
    standard initUndistortRectifyMap construction).
    """
    K = np.asarray(K, np.float64)
    D = np.asarray(D, np.float64).reshape(-1)
    R = np.asarray(R, np.float64)
    P = np.asarray(P, np.float64)
    k1, k2, p1, p2 = D[0], D[1], D[2], D[3]
    k3 = D[4] if len(D) > 4 else 0.0

    fx_n, fy_n = P[0, 0], P[1, 1]
    cx_n, cy_n = P[0, 2], P[1, 2]

    u, v = np.meshgrid(np.arange(width, dtype=np.float64), np.arange(height, dtype=np.float64))
    x = (u - cx_n) / fx_n
    y = (v - cy_n) / fy_n
    rays = np.stack([x, y, np.ones_like(x)], axis=0).reshape(3, -1)
    rays = R.T @ rays
    xn = rays[0] / rays[2]
    yn = rays[1] / rays[2]

    r2 = xn * xn + yn * yn
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = xn * radial + 2 * p1 * xn * yn + p2 * (r2 + 2 * xn * xn)
    yd = yn * radial + p1 * (r2 + 2 * yn * yn) + 2 * p2 * xn * yn

    map_x = (K[0, 0] * xd + K[0, 2]).reshape(height, width).astype(np.float32)
    map_y = (K[1, 1] * yd + K[1, 2]).reshape(height, width).astype(np.float32)
    return map_x, map_y


def remap_bilinear(img: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor) -> torch.Tensor:
    """Bilinear remap of an (H, W) float32 image with border replication, on
    the image's device (the maps are moved there). The arithmetic is the
    JAX package's numpy arithmetic: float32 coordinates, float64 weights
    and sum, a float32 result."""
    H, W = img.shape
    dev = img.device
    x = torch.clamp(torch.as_tensor(map_x, device=dev), 0, W - 1.001)
    y = torch.clamp(torch.as_tensor(map_y, device=dev), 0, H - 1.001)
    x0 = x.to(torch.int32)
    y0 = y.to(torch.int32)
    wx = x.double() - x0
    wy = y.double() - y0
    flat = img.reshape(-1)
    i00 = (y0.long() * W + x0.long())

    def at(i):
        return flat[i].double()

    out = (at(i00) * (1 - wx) * (1 - wy) + at(i00 + 1) * wx * (1 - wy)
           + at(i00 + W) * (1 - wx) * wy + at(i00 + W + 1) * wx * wy)
    return out.to(torch.float32)


class StereoRectifier:
    """Precomputed rectification for a stereo pair from the Settings'
    LEFT/RIGHT blocks; the maps live on `device`, where the pair is
    remapped."""

    def __init__(self, left: dict, right: dict, width: int, height: int, device="cuda"):
        dev = torch.device(device)
        self.lmx, self.lmy, self.rmx, self.rmy = (
            torch.from_numpy(a).to(dev)
            for a in (*init_rectify_map(left["K"], left["D"], left["R"], left["P"], width, height),
                      *init_rectify_map(right["K"], right["D"], right["R"], right["P"], width, height)))

    def __call__(self, img_left, img_right):
        """The rectified pair, (H, W) float32 tensors on the maps' device."""
        dev = self.lmx.device
        L, R = (torch.as_tensor(x, dtype=torch.float32, device=dev) for x in (img_left, img_right))
        return remap_bilinear(L, self.lmx, self.lmy), remap_bilinear(R, self.rmx, self.rmy)
