"""Plain NumPy and torch reference for map points: the true depth along a
camera ray through the corridor of fronto-parallel slabs (the renderer's
own ray cast, benchmark/traffic/scene.py, in float64), the relative depth
error of a keyframe's points, and the control's points, made in a given
precision from two views: triangulated, or from a rectified pair's
disparity. Imports nothing of the program.

The slabs: band i covers world x in [x_lo + i band, x_lo + (i + 1) band)
at world depth z = depths[i]; a ray meets the nearest slab whose band
holds the hit.
"""

from __future__ import annotations

import numpy as np
import torch


def ray_depths(C: np.ndarray, d: np.ndarray, depths: np.ndarray, x_lo: float, band: float) -> np.ndarray:
    """The parameter lam >= 0 of the nearest slab hit C + lam d, for
    (n, 3) world origins and directions (nan where the ray meets none).
    With d = R^T (u, v, 1) lam is the hit's depth in the camera's frame."""
    C, d = np.asarray(C, np.float64), np.asarray(d, np.float64)
    depths = np.asarray(depths, np.float64)
    best = np.full(len(C), np.inf)
    dz = np.where(np.abs(d[:, 2]) < 1e-12, 1e-12, d[:, 2])
    for z in np.unique(depths):
        lam = (z - C[:, 2]) / dz
        x = C[:, 0] + lam * d[:, 0]
        i = np.floor((x - x_lo) / band).astype(np.int64)
        inside = (i >= 0) & (i < len(depths))
        hit = inside & (lam > 0) & (depths[np.clip(i, 0, len(depths) - 1)] == z)
        best = np.where(hit & (lam < best), lam, best)
    return np.where(np.isfinite(best), best, np.nan)


def depth_errors(R, t, X, Rg, tg, depths, x_lo, band, metric: bool) -> np.ndarray:
    """Relative depth errors of points X (n, 3) seen by one keyframe,
    whose pose in the estimate's world is (R, t) and in the truth's (Rg,
    tg): each point's depth in the keyframe's camera against the true depth
    along the same ray. A monocular map has no scale: its depths are put at
    the truth's by their median ratio first. A point behind the camera or
    not finite reads inf; one on a ray that meets no slab, nan."""
    with np.errstate(invalid="ignore", over="ignore"):
        Xc = np.asarray(X, np.float64) @ np.asarray(R, np.float64).T + np.asarray(t, np.float64)
    z = Xc[:, 2]
    front = np.isfinite(Xc).all(axis=1) & (z > 1e-9)
    u = np.where(front[:, None], Xc / np.where(front, z, 1.0)[:, None], np.float64([0.0, 0.0, 1.0]))
    Cg = -np.asarray(Rg, np.float64).T @ np.asarray(tg, np.float64)
    truth = ray_depths(np.broadcast_to(Cg, u.shape), u @ np.asarray(Rg, np.float64), depths, x_lo, band)
    ok = front & np.isfinite(truth)
    if not metric and ok.any():
        z = z * np.median(truth[ok] / z[ok])
    err = np.where(ok, np.abs(z - np.where(ok, truth, 1.0)) / np.where(ok, truth, 1.0), np.nan)
    return np.where(front, err, np.inf)


def triangulate(R1, t1, R2, t2, uv1, uv2, cam: dict, dtype=torch.float64) -> np.ndarray:
    """Midpoint triangulation, every step in `dtype`, of pixels uv1 in view
    1 and uv2 in view 2 (world->camera poses): the points (n, 3), float64
    numpy out."""
    def T(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=torch.float64).to(dtype)

    def ray(R, t, uv):
        R, t, uv = T(R), T(t), T(uv)
        x = (uv[:, 0] - cam["cx"]) / cam["fx"]
        y = (uv[:, 1] - cam["cy"]) / cam["fy"]
        d = torch.stack([x, y, torch.ones_like(x)], -1) @ R
        return -(R.T @ t), d

    C1, d1 = ray(R1, t1, uv1)
    C2, d2 = ray(R2, t2, uv2)
    w = C1 - C2
    a, b, c = (d1 * d1).sum(-1), (d1 * d2).sum(-1), (d2 * d2).sum(-1)
    e, f = (d1 * w).sum(-1), (d2 * w).sum(-1)
    den = a * c - b * b
    l1, l2 = (b * f - c * e) / den, (a * f - b * e) / den
    X = ((C1 + l1[:, None] * d1) + (C2 + l2[:, None] * d2)) / 2
    return X.to(torch.float64).numpy()


def stereo_points(R, t, uv_left, u_right, cam: dict, dtype=torch.float64) -> np.ndarray:
    """Points of a rectified pair, every step in `dtype`: the left pixel
    back-projected at the depth bf / (u_left - u_right), into the world
    from world->camera pose (R, t) of the left camera. (n, 3) float64."""
    def T(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=torch.float64).to(dtype)

    R, t, uv, ur = T(R), T(t), T(uv_left), T(u_right)
    z = cam["bf"] / (uv[:, 0] - ur)
    Xc = torch.stack([(uv[:, 0] - cam["cx"]) / cam["fx"] * z, (uv[:, 1] - cam["cy"]) / cam["fy"] * z, z], -1)
    return ((Xc - t) @ R).to(torch.float64).numpy()


def project(R, t, X, cam: dict) -> np.ndarray:
    """(n, 2) pixels of world points X at world->camera pose (R, t)."""
    Xc = np.asarray(X, np.float64) @ np.asarray(R, np.float64).T + np.asarray(t, np.float64)
    return np.stack([cam["fx"] * Xc[:, 0] / Xc[:, 2] + cam["cx"],
                     cam["fy"] * Xc[:, 1] / Xc[:, 2] + cam["cy"]], -1)


def surface_points(R, t, cam: dict, depths, x_lo, band, n: int, rng) -> np.ndarray:
    """n points of the corridor's surface seen at pose (R, t), at pixels
    drawn from `rng` (those whose ray meets a slab)."""
    uv = np.stack([rng.uniform(0, cam["width"], 4 * n), rng.uniform(0, cam["height"], 4 * n)], -1)
    u = np.stack([(uv[:, 0] - cam["cx"]) / cam["fx"], (uv[:, 1] - cam["cy"]) / cam["fy"],
                  np.ones(len(uv))], -1)
    R = np.asarray(R, np.float64)
    C = -R.T @ np.asarray(t, np.float64)
    lam = ray_depths(np.broadcast_to(C, u.shape), u @ R, depths, x_lo, band)
    ok = np.isfinite(lam)
    return (C + lam[ok, None] * (u[ok] @ R))[:n]
