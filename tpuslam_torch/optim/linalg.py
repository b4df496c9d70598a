"""Small batched SPD solve. Port of tpuslam/optim/linalg.py::solve_spd."""

from __future__ import annotations

import torch


def solve_spd(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve H x = b for small SPD H (..., n, n) by Cholesky, batched over
    leading dims. As in the JAX package, each pivot is clamped to >= 1e-12
    before its square root, so a singular H gives a finite answer.

    The JAX version unrolls every scalar; here each Cholesky column and each
    substitution row is one vector step, which keeps the number of kernel
    launches per solve small (about 6 per column) on the card."""
    n = H.shape[-1]
    L = torch.zeros_like(H)
    for j in range(n):
        Lj = L[..., j, :j]
        d = torch.sqrt(torch.clamp(H[..., j, j] - (Lj * Lj).sum(-1), min=1e-12))
        s = H[..., j + 1 :, j] - (L[..., j + 1 :, :j] * Lj[..., None, :]).sum(-1)
        col = s * (1.0 / d)[..., None]
        L[..., j, j] = d
        L[..., j + 1 :, j] = col
    y = torch.zeros_like(b)
    for i in range(n):
        y[..., i] = (b[..., i] - (L[..., i, :i] * y[..., :i]).sum(-1)) / L[..., i, i]
    x = torch.zeros_like(b)
    for i in reversed(range(n)):
        x[..., i] = (y[..., i] - (L[..., i + 1 :, i] * x[..., i + 1 :]).sum(-1)) / L[..., i, i]
    return x


def load_cuda_linalg(device) -> None:
    """Load torch's CUDA linear-algebra library now, from the calling
    thread. It loads lazily at the first call of a solver (inv, solve, svd,
    eigh, ...), and that load is not thread-safe: two threads making their
    first such call at once fail ("lazy wrapper should be called at most
    once"). Call it before starting threads that may; a no-op off the card."""
    if torch.device(device).type == "cuda":
        torch.linalg.inv_ex(torch.eye(3, device=device))
