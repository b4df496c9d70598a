"""Frames of a route, rendered on the device in chunks and handed over as
host uint8 arrays, with the true pose of each."""

from __future__ import annotations

import torch

from benchmark.traffic import routes


class FrameSource:
    """Frames i = 0, 1, ... of route `route` (its traffic parameters)
    through `scene`, seen by camera `cam` (a dict of intrinsics and size);
    with `baseline` > 0 each frame is a rectified pair."""

    def __init__(self, scene, cam: dict, route: dict, baseline: float = 0.0):
        self.scene, self.cam, self.route, self.baseline = scene, cam, route, float(baseline)

    def truth(self, frames) -> tuple:
        """World->camera (R (n, 3, 3), t (n, 3)) float64 of the frames."""
        return routes.poses(self.route, frames)

    def render(self, i0: int, n: int) -> list:
        """Frames i0 .. i0 + n - 1: one tuple of host uint8 (H, W) arrays
        (the image, or left and right) each. One copy to the host for the
        chunk."""
        R, t = self.truth(range(i0, i0 + n))
        views = [v for k in range(n) for v in self.scene.render_views(self.cam, (R[k], t[k]), self.baseline)]
        host = torch.stack(views).cpu().numpy()
        per = 2 if self.baseline else 1
        return [tuple(host[k * per + j] for j in range(per)) for k in range(n)]
