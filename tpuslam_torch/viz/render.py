"""PNG renderers for frames and maps (PIL, no GL). Port of
tpuslam/viz/render.py.

- draw_frame: the current image, keypoints, tracked-match markers and a
  status text (FrameDrawer::DrawFrame).
- render_map_topdown: map points, keyframe positions, covisibility edges
  and the camera trajectory projected to a ground plane
  (MapDrawer::DrawMapPoints / DrawKeyFrames). Its geometry is
  topdown_layout, a tensor function on the map's device (covisibility,
  percentiles, pixel coordinates; no PIL); a thin PIL pass draws it.

PIL is imported inside the drawing functions only. The layout repeats the
JAX package's numpy arithmetic op for op and dtype for dtype (its float32
or float64 percentiles included), so the pixels equal the JAX renderer's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpuslam_torch.mapstate.core import MapState, covisibility_weights


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def draw_frame(img, kp_xy, kp_valid, tracked_mask, state_text: str = ""):
    """Returns a PIL Image: green squares are tracked keypoints, blue the
    rest. Arrays or tensors on any device."""
    from PIL import Image, ImageDraw

    base = Image.fromarray(np.clip(_np(img), 0, 255).astype(np.uint8)).convert("RGB")
    d = ImageDraw.Draw(base)
    xy, valid, tracked = _np(kp_xy), _np(kp_valid), _np(tracked_mask)
    for i in np.nonzero(valid)[0]:
        x, y = float(xy[i, 0]), float(xy[i, 1])
        color = (0, 255, 0) if tracked[i] else (80, 80, 255)
        d.rectangle([x - 2, y - 2, x + 2, y + 2], outline=color)
    if state_text:
        d.text((8, base.height - 14), state_text, fill=(255, 255, 0))
    return base


class TopdownLayout(NamedTuple):
    """Pixel coordinates (n, 2) of the map points, the keyframes and the
    trajectory, and the covisibility edges (E, 2) as indices into the
    keyframes' rows; tensors on the map's device."""

    points: torch.Tensor
    keyframes: torch.Tensor
    trajectory: torch.Tensor
    edges: torch.Tensor


def _percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """np.percentile(x, q, axis=0) (the linear method) in x's dtype, with
    numpy's own index, weight and interpolation arithmetic."""
    npdt = np.float32 if x.dtype == torch.float32 else np.float64
    n = x.shape[0]
    v = (n - 1) * np.true_divide(q, npdt(100))
    lo = min(max(int(np.floor(v)), 0), n - 1)
    hi = min(lo + 1, n - 1)
    gamma = npdt(v - lo)
    s = torch.sort(x, dim=0).values
    a, b = s[lo], s[hi]
    diff = b - a
    if gamma >= 0.5:
        return b - diff * float(npdt(1) - gamma)
    return a + diff * float(gamma)


def topdown_layout(m: MapState, trajectory: list | None = None, size: int = 800, axes=(0, 2),
                   covis_threshold: int = 15) -> TopdownLayout:
    """The geometry of render_map_topdown, on the map's device.
    `trajectory` holds (frame_id, R, t) rows of T_cw (numpy)."""
    dev = m.pt_xyz.device
    ax = list(axes)
    pts = m.pt_xyz[m.pt_valid]
    kf_valid = m.kf_valid
    kf_R, kf_t = m.kf_R[kf_valid], m.kf_t[kf_valid]
    # The JAX renderer's einsum("kij,ki->kj", R^T, t) is R t, not R^T t: its
    # keyframe "centres" are kept as it draws them.
    centers = -(kf_R[:, :, 0] * kf_t[:, 0:1] + kf_R[:, :, 1] * kf_t[:, 1:2]
                + kf_R[:, :, 2] * kf_t[:, 2:3])
    edges = torch.zeros((0, 2), dtype=torch.long, device=dev)
    if len(kf_R) > 1 and covis_threshold > 0:
        w = covisibility_weights(m)[kf_valid][:, kf_valid]
        edges = torch.nonzero(torch.triu(w, 1) >= covis_threshold)
    traj = [-np.asarray(R).T @ np.asarray(t) for _, R, t in trajectory or ()]
    traj_pts = torch.from_numpy(np.asarray(traj)).to(dev) if traj else torch.zeros((0, 3), device=dev)

    parts = [p[:, ax] for p in (pts, centers, traj_pts) if len(p)]
    if not parts:
        empty = torch.zeros((0, 2), device=dev)
        return TopdownLayout(empty, empty, empty, edges)
    all_xy = torch.cat(parts) if len({p.dtype for p in parts}) == 1 else torch.cat(
        [p.double() for p in parts])
    lo = _percentile(all_xy, 2)
    hi = _percentile(all_xy, 98)
    span = torch.clamp(hi - lo, min=1e-6)
    margin = 0.08 * span
    lo = lo - margin
    span = span + 2 * margin

    def to_px(p):
        q = (p[:, ax] - lo) / span
        return torch.stack([q[:, 0] * (size - 1), (1 - q[:, 1]) * (size - 1)], dim=-1)

    return TopdownLayout(to_px(pts), to_px(centers), to_px(traj_pts), edges)


def render_map_topdown(m: MapState, trajectory: list | None = None, size: int = 800, axes=(0, 2),
                       covis_threshold: int = 15):
    """Top-down (x-z by default) map render. Returns a PIL Image.

    Grey dots: map points; blue squares: keyframes; light-blue lines:
    covisibility-graph edges (>= covis_threshold shared points, like
    MapDrawer::DrawKeyFrames' graph pass); green line: the frame trajectory
    (camera centres)."""
    from PIL import Image, ImageDraw

    lay = TopdownLayout(*(_np(x) for x in topdown_layout(m, trajectory, size, axes, covis_threshold)))
    img = Image.new("RGB", (size, size), (255, 255, 255))
    d = ImageDraw.Draw(img)
    for x, y in lay.points:
        d.point((x, y), fill=(60, 60, 60))
    for i, j in lay.edges.tolist():
        d.line([tuple(lay.keyframes[i]), tuple(lay.keyframes[j])], fill=(150, 200, 255), width=1)
    if len(lay.trajectory) > 1:
        d.line([tuple(p) for p in lay.trajectory], fill=(0, 160, 0), width=2)
    for x, y in lay.keyframes:
        d.rectangle([x - 3, y - 3, x + 3, y + 3], outline=(0, 0, 255))
    return img
