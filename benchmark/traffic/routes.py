"""Camera routes through the corridor, from a cell's traffic parameters.

One general generator: the camera centre moves along world x at `speed`
metres a frame from `x0`, its yaw sways with `yaw_rate` radians a frame at
the centre of a sway of amplitude `yaw_amp` (testing.orbit_trajectory's yaw
grows without bound, which a long route cannot have), and it bobs in y by
`bob` metres (orbit_trajectory's 0.01 sin(0.3 i)), at z = 0. Poses are
world->camera (R, t), as testing.orbit_trajectory gives them (commit
431b9431); `dtype` is the precision they are computed in (float64 for the
truth; the control computes them in bfloat16).
"""

from __future__ import annotations

import numpy as np
import torch


def _so3_y(yaw: torch.Tensor) -> torch.Tensor:
    """Rotations about the camera's y axis, (n, 3, 3), in yaw's dtype."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    z, o = torch.zeros_like(yaw), torch.ones_like(yaw)
    return torch.stack([torch.stack([c, z, s], -1), torch.stack([z, o, z], -1),
                        torch.stack([-s, z, c], -1)], -2)


def centres(p: dict, frames: np.ndarray, dtype=torch.float64) -> tuple:
    """(yaw (n,), camera centres (n, 3)) of route `p` at frame indices."""
    i = torch.as_tensor(np.asarray(frames, np.float64), dtype=torch.float64)
    x = float(p["x0"]) + float(p["speed"]) * i
    amp = float(p.get("yaw_amp", 0.15))
    yaw = amp * torch.sin(float(p.get("yaw_rate", 0.0)) * i / amp)
    y = float(p.get("bob", 0.01)) * torch.sin(0.3 * i)
    C = torch.stack([x, y, torch.zeros_like(x)], -1)
    return yaw.to(dtype), C.to(dtype)


def poses(p: dict, frames, dtype=torch.float64) -> tuple:
    """World->camera (R (n, 3, 3), t (n, 3)) of route `p` at the frame
    indices, every step computed in `dtype`; float64 numpy out."""
    yaw, C = centres(p, frames, dtype)
    R = _so3_y(yaw)
    t = -(R @ C[..., None])[..., 0]
    return R.to(torch.float64).numpy(), t.to(torch.float64).numpy()


def length_frames(p: dict, x_lo: float, x_hi: float, margin: float) -> int:
    """How many frames the route runs before its view leaves the corridor
    (`margin` metres before an end)."""
    return int((x_hi - margin - float(p["x0"])) / float(p["speed"]))
