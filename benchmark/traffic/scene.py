"""The synthetic scene the benchmark renders: a long corridor of textured,
fronto-parallel slabs (bands along world x, each at its own depth), and
its renderer.

A frozen, extended copy of tpuslam_torch/testing.py's StepWallScene and
render_frames / render_stereo_frames (commit 431b9431), in plain torch,
importing nothing of the program. What changed from the copy:
- the corridor has `n_bands` bands, not 8: `depths` over and over, the
  same for every seed (the geometry, and so the work, does not change
  with the seed; the texture does);
- one texture strip runs the corridor's length, made on the device from
  the seed in a few large calls (noise, a 7-tap sigma-2 blur, squares), and
  a band's texture is the strip under it, so the texture never clamps;
- the squares are one to a cell, the same sizes and values for every seed
  in another order (make_texture draws their count, places, sizes and
  values freely), so that no seed's corridor has more corners than
  another's;
- a frame intersects only the bands in its view;
- frames come out as (H, W) uint8 host arrays, the form a camera driver
  hands over.
"""

from __future__ import annotations

import math

import numpy as np
import torch

TEX_H = 500
TEX_PAD = 8  # texels of strip beyond each end of the corridor
CELL = 25  # texels a side of a square's cell: testing.make_texture's 400 squares in 500 x 500


def _blur7(x: torch.Tensor) -> torch.Tensor:
    """Separable 7-tap Gaussian (sigma 2) of an (H, W) image, edges
    replicated; a sum of shifted slices, so it repeats bit for bit."""
    k = np.exp(-(np.arange(7) - 3.0) ** 2 / 8.0)
    k = [float(v) for v in (k / k.sum()).astype(np.float32)]
    p = torch.nn.functional.pad(x[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
    H, W = x.shape
    acc = sum(k[i] * p[:, i:i + W] for i in range(7))
    return sum(k[i] * acc[i:i + H, :] for i in range(7))


def make_strip(gen: torch.Generator, width: int, device) -> torch.Tensor:
    """(TEX_H, width) float32 texture in [0, 255]: uniform noise blurred,
    then one uniform square in each CELL x CELL cell (make_texture's
    density) at a place in the cell drawn from `gen`. The squares' sizes (3
    to 10 texels) and values (over [0, 255)) are the same multiset for
    every seed, in equal shares, dealt to the cells in the seed's order:
    every seed's strip has as many corners of each kind."""
    tex = _blur7(torch.rand((TEX_H, width), generator=gen, device=device) * 255.0)
    rows, cols = (TEX_H - 20) // CELL, (width - 20) // CELL
    n = rows * cols
    k = torch.arange(n, device=device)
    s = (3 + k % 8)[torch.randperm(n, generator=gen, device=device)]
    v = ((k + 0.5) * (255.0 / n))[torch.randperm(n, generator=gen, device=device)]
    y = 5 + (k // cols) * CELL + torch.randint(0, CELL - 10, (n,), generator=gen, device=device)
    x = 5 + (k % cols) * CELL + torch.randint(0, CELL - 10, (n,), generator=gen, device=device)
    d = torch.arange(10, device=device)
    dy, dx = d[:, None].expand(10, 10), d[None, :].expand(10, 10)
    inside = (dy[None] < s[:, None, None]) & (dx[None] < s[:, None, None])
    lin = (y[:, None, None] + dy[None]) * width + x[:, None, None] + dx[None]
    flat = tex.reshape(-1).clone()
    flat[lin[inside]] = v[:, None, None].expand_as(lin)[inside].to(flat.dtype)
    return flat.reshape(TEX_H, width)


class Corridor:
    """Bands of width `band` along world x from x_lo = -band * n_bands / 2,
    band i at depth depths_i (world z), textured by one strip at
    `tex_scale` texels per metre. Poses are world->camera (R, t)."""

    def __init__(self, seed: int, n_bands: int, depths, band: float, tex_scale: float,
                 ssaa: int = 3, device="cuda"):
        self.device = torch.device(device)
        self.band, self.tex_scale, self.ssaa = float(band), float(tex_scale), int(ssaa)
        self.n_bands = int(n_bands)
        self.x_lo = -0.5 * self.n_bands * self.band
        base = np.asarray(depths, np.float64)
        if self.n_bands % len(base):
            raise ValueError(f"{self.n_bands} bands: not whole blocks of the {len(base)} depths")
        self.depths = np.tile(base, self.n_bands // len(base))
        self._depths_t = torch.tensor(self.depths, dtype=torch.float32, device=self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed) % (2**63))
        width = int(math.ceil(self.n_bands * self.band * self.tex_scale)) + 2 * TEX_PAD
        self.strip = make_strip(gen, width, self.device)

    @property
    def x_hi(self) -> float:
        return self.x_lo + self.n_bands * self.band

    def _bands_in_view(self, cam: dict, R: torch.Tensor, C: torch.Tensor) -> range:
        """Bands whose slab the view can reach: the image corners' rays cut
        with the nearest and farthest depth planes, one band of margin."""
        W, H = cam["width"], cam["height"]
        uv = torch.tensor([[0.0, 0.0], [W, 0.0], [0.0, H], [W, H], [W / 2, H / 2]],
                          dtype=torch.float32, device=self.device)
        d = torch.stack([(uv[:, 0] - cam["cx"]) / cam["fx"], (uv[:, 1] - cam["cy"]) / cam["fy"],
                         torch.ones(5, device=self.device)], 0)
        d = R.T @ d
        xs = []
        for z in (float(self.depths.min()), float(self.depths.max())):
            lam = (z - C[2]) / torch.where(d[2].abs() < 1e-9, torch.full_like(d[2], 1e-9), d[2])
            xs.append(C[0] + lam.clamp(min=0) * d[0])
        xs = torch.cat(xs + [C[0:1]]).cpu().numpy()
        i0 = int(np.floor((xs.min() - self.x_lo) / self.band)) - 1
        i1 = int(np.floor((xs.max() - self.x_lo) / self.band)) + 1
        return range(max(i0, 0), min(i1, self.n_bands - 1) + 1)

    def _render_once(self, cam: dict, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """(H, W) float32 image by ray casting, bilinear in the strip."""
        H, W = cam["height"], cam["width"]
        dev, f32 = self.device, torch.float32
        vv, uu = torch.meshgrid(torch.arange(H, dtype=f32, device=dev),
                                torch.arange(W, dtype=f32, device=dev), indexing="ij")
        C = -R.T @ t
        d = R.T @ torch.stack([(uu - cam["cx"]) / cam["fx"], (vv - cam["cy"]) / cam["fy"],
                               torch.ones_like(uu)], 0).reshape(3, -1)
        d2 = torch.where(d[2].abs() < 1e-9, torch.full_like(d[2], 1e-9), d[2])
        out = torch.zeros(H * W, dtype=f32, device=dev)
        best = torch.full((H * W,), float("inf"), dtype=f32, device=dev)
        th, tw = self.strip.shape
        for i in self._bands_in_view(cam, R, C):
            lam = (self._depths_t[i] - C[2]) / d2
            P = C[:, None] + lam * d
            hit = (lam > 0) & (lam < best) & (torch.floor((P[0] - self.x_lo) / self.band) == i)
            tx = torch.clamp((P[0] - self.x_lo) * self.tex_scale + TEX_PAD, 0, tw - 2)
            ty = torch.clamp(P[1] * self.tex_scale + th / 2, 0, th - 2)
            x0, y0 = tx.long(), ty.long()
            wx, wy = tx - x0, ty - y0
            s = self.strip
            val = (s[y0, x0] * (1 - wx) * (1 - wy) + s[y0, x0 + 1] * wx * (1 - wy)
                   + s[y0 + 1, x0] * (1 - wx) * wy + s[y0 + 1, x0 + 1] * wx * wy)
            out = torch.where(hit, val, out)
            best = torch.where(hit, lam, best)
        return out.reshape(H, W)

    def render(self, cam: dict, R, t) -> torch.Tensor:
        """(H, W) uint8 image on the device at world->camera pose (R, t),
        `ssaa` x `ssaa` supersampled, rounded half to even."""
        s = self.ssaa
        R = torch.as_tensor(np.asarray(R, np.float32), device=self.device)
        t = torch.as_tensor(np.asarray(t, np.float32), device=self.device)
        hi = dict(cam, fx=cam["fx"] * s, fy=cam["fy"] * s, cx=cam["cx"] * s + (s - 1) / 2.0,
                  cy=cam["cy"] * s + (s - 1) / 2.0, width=cam["width"] * s, height=cam["height"] * s)
        img = self._render_once(hi, R, t)
        img = img.reshape(cam["height"], s, cam["width"], s).mean(dim=(1, 3))
        return torch.clamp(torch.round(img), 0, 255).to(torch.uint8)

    def render_views(self, cam: dict, pose, baseline: float = 0.0) -> list:
        """The uint8 images of one frame on the device: the left view, and
        with a baseline the right view too, moved by it along the camera's
        own x axis (a rectified pair)."""
        R, t = pose
        views = [self.render(cam, R, t)]
        if baseline:
            views.append(self.render(cam, R, np.asarray(t, np.float32) - np.float32([baseline, 0, 0])))
        return views
