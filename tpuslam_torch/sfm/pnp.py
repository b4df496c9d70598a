"""EPnP + RANSAC absolute pose from 3D-2D matches, batched over hypotheses.
Port of tpuslam/sfm/pnp.py.

Every hypothesis is a minimal 4-point EPnP solve (control points by PCA,
barycentric coordinates, the 4 least eigenvectors of M^T M, betas from the
one-vector case refined by 6 Gauss-Newton steps on the inter-control-point
distances, R and t by Kabsch); all of them run as one batch. Inliers are
counted with per-point chi2 gates and the best hypothesis is refined by
EPnP over its inliers.

With noisy points the EPnP solution depends on the control points, so on
the signs of the principal directions: those are fixed here (largest entry
positive), while the JAX package takes whatever its LAPACK returns. The two
agree to the noise of the estimate, not to float precision.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpuslam_torch.sfm.initializer import _pick, draw_picks

_PAIRS_I = [0, 0, 0, 1, 1, 2]
_PAIRS_J = [1, 2, 3, 2, 3, 3]


class PnPResult(NamedTuple):
    success: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def _kabsch(Pw: torch.Tensor, Pc: torch.Tensor, w: torch.Tensor):
    """Weighted absolute orientation, batched: R, t with Pc ~ R Pw + t.
    Pw, Pc (..., n, 3), w (..., n)."""
    wsum = torch.clamp(w.sum(-1), min=1e-9)[..., None]
    cw = torch.sum(Pw * w[..., None], dim=-2) / wsum
    cc = torch.sum(Pc * w[..., None], dim=-2) / wsum
    A = (Pw - cw[..., None, :]) * w[..., None]
    B = Pc - cc[..., None, :]
    U, _, Vh = torch.linalg.svd(A.transpose(-1, -2) @ B)
    V, Ut = Vh.transpose(-1, -2), U.transpose(-1, -2)
    d = torch.linalg.det(V @ Ut)
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1))
    R = V @ D @ Ut
    return R, cc - (R @ cw[..., None])[..., 0]


def _pair_dists(c: torch.Tensor) -> torch.Tensor:
    """(..., 4, 3) control points -> (..., 6) squared distances of the pairs."""
    diff = c[..., _PAIRS_I, :] - c[..., _PAIRS_J, :]
    return torch.sum(diff * diff, dim=-1)


def _epnp(Pw: torch.Tensor, uv: torch.Tensor, w: torch.Tensor, fx, fy, cx, cy):
    """EPnP for weighted point sets, batched over the leading dims of w
    (..., n) (0 excludes a point); Pw (n, 3), uv (n, 2). Returns (R, t)."""
    n = Pw.shape[0]
    wsum = torch.clamp(w.sum(-1), min=1e-9)[..., None]
    c0 = torch.sum(Pw * w[..., None], dim=-2) / wsum  # (..., 3)
    centered = (Pw - c0[..., None, :]) * torch.sqrt(w)[..., None]
    cov = centered.transpose(-1, -2) @ centered / wsum[..., None]
    eigval, eigvec = torch.linalg.eigh(cov)  # ascending
    # The control points depend on the eigenvectors' signs, which LAPACK
    # builds choose differently: fix them (largest entry positive), so the
    # card and the CPU agree.
    big = torch.gather(eigvec, -2, eigvec.abs().argmax(dim=-2, keepdim=True))
    eigvec = eigvec * torch.where(big < 0, -1.0, 1.0)
    scales = torch.sqrt(torch.clamp(eigval, min=1e-12))
    # Control points: the centroid and the principal directions scaled by
    # their standard deviation, largest first.
    ctrl_w = torch.stack([c0, c0 + scales[..., 2, None] * eigvec[..., :, 2],
                          c0 + scales[..., 1, None] * eigvec[..., :, 1],
                          c0 + scales[..., 0, None] * eigvec[..., :, 0]], dim=-2)  # (..., 4, 3)

    # Barycentric coordinates: [c1-c0, c2-c0, c3-c0] a = p - c0.
    Bm = (ctrl_w[..., 1:, :] - ctrl_w[..., :1, :]).transpose(-1, -2)
    Binv = torch.linalg.inv_ex(Bm + 1e-12 * torch.eye(3, device=Pw.device))[0]
    a123 = (Pw - ctrl_w[..., :1, :]) @ Binv.transpose(-1, -2)  # (..., n, 3)
    alphas = torch.cat([1.0 - a123.sum(-1, keepdim=True), a123], dim=-1)  # (..., n, 4)

    # M (2n, 12), columns interleaved (x_j, y_j, z_j) per control point j.
    u, v = uv[:, 0], uv[:, 1]
    Zr = torch.zeros_like(alphas)
    mu = torch.stack([alphas * fx, Zr, alphas * (cx - u)[:, None]], dim=-1).reshape(*alphas.shape[:-1], 12)
    mv = torch.stack([Zr, alphas * fy, alphas * (cy - v)[:, None]], dim=-1).reshape(*alphas.shape[:-1], 12)
    sw = torch.sqrt(w)[..., None]
    M = torch.cat([mu * sw, mv * sw], dim=-2)
    _, vecs = torch.linalg.eigh(M.transpose(-1, -2) @ M)
    V = vecs[..., :, :4]  # the 4 least (columns), v0 the least
    Vc = V.transpose(-1, -2).reshape(*V.shape[:-2], 4, 4, 3)  # (..., k, ctrl, xyz)

    rho = _pair_dists(ctrl_w)  # world control-point distances
    d0 = _pair_dists(Vc[..., 0, :, :])
    beta1 = torch.sqrt(torch.sum(rho * d0, -1) / torch.clamp(torch.sum(d0 * d0, -1), min=1e-12))
    betas = torch.cat([beta1[..., None], torch.zeros_like(V[..., 0, 1:])], dim=-1)  # (..., 4)

    # Gauss-Newton on the 6 distance constraints (PnPsolver::gauss_newton),
    # with the Jacobian written out: d dist_ij / d beta_k =
    # 2 (c_i - c_j) . (v_k[i] - v_k[j]).
    dV = Vc[..., :, _PAIRS_I, :] - Vc[..., :, _PAIRS_J, :]  # (..., 4, 6, 3)
    eye4 = 1e-9 * torch.eye(4, device=Pw.device)
    for _ in range(6):
        cc = torch.einsum("...k,...kcx->...cx", betas, Vc)
        diff = cc[..., _PAIRS_I, :] - cc[..., _PAIRS_J, :]  # (..., 6, 3)
        J = 2.0 * torch.einsum("...px,...kpx->...pk", diff, dV)  # (..., 6, 4)
        r = torch.sum(diff * diff, -1) - rho
        H = J.transpose(-1, -2) @ J + eye4
        step = torch.linalg.solve_ex(H, (J.transpose(-1, -2) @ r[..., None]))[0][..., 0]
        betas = betas - step

    cc = torch.einsum("...k,...kcx->...cx", betas, Vc)
    Pc = alphas @ cc  # (..., n, 3)
    # Depth sign: the points must lie in front of the camera.
    votes = torch.sum(torch.where(w > 0, torch.sign(Pc[..., 2]), 0.0), -1)
    Pc = Pc * torch.where(votes < 0, -1.0, 1.0)[..., None, None]
    return _kabsch(Pw, Pc, w)


def pnp_ransac(K: torch.Tensor, pts_w: torch.Tensor, uv: torch.Tensor, inv_sigma2: torch.Tensor,
               valid: torch.Tensor, *, generator=None, picks=None, n_hypotheses: int = 128,
               chi2_th: float = 5.991, min_inliers: int = 10) -> PnPResult:
    """Batched minimal-EPnP RANSAC. pts_w (N, 3), uv (N, 2) undistorted,
    per-point chi2 gates from inv_sigma2 (N,). The 4-point sets come from
    `picks` (n_hyp, 4) indices into the valid rows when given, else from
    `generator`. No host read."""
    dev = pts_w.device
    K = K.to(dev)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    n = pts_w.shape[0]
    valid_idx = torch.argsort((~valid).to(torch.int8), stable=True)
    if picks is None:
        picks = draw_picks(n_hypotheses, 4, valid, generator)
    sets = valid_idx[picks.to(dev).long()]  # (n_hyp, 4)

    def reproj_chi2(R, t):
        p = torch.einsum("...ij,nj->...ni", R, pts_w) + t[..., None, :]
        z = p[..., 2]
        z = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
        u = fx * p[..., 0] / z + cx
        v = fy * p[..., 1] / z + cy
        err = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
        return err * inv_sigma2, p[..., 2] > 0

    # Repeated indices within a set weigh once, as .at[idx4].set(1.0).
    w4 = torch.zeros((sets.shape[0], n), device=dev).scatter(1, sets, 1.0)
    Rs, ts = _epnp(pts_w, uv, w4, fx, fy, cx, cy)
    chi2, front = reproj_chi2(Rs, ts)
    counts = (valid & front & (chi2 <= chi2_th)).sum(-1, dtype=torch.int32)
    best = torch.argmax(counts)
    Rb, tb = _pick(Rs, best), _pick(ts, best)
    chi2, front = reproj_chi2(Rb, tb)
    inl = valid & front & (chi2 <= chi2_th)

    # Refine on the inlier set.
    Rr, tr = _epnp(pts_w, uv, inl.to(torch.float32) + 1e-9, fx, fy, cx, cy)
    chi2_r, front_r = reproj_chi2(Rr, tr)
    inl_r = valid & front_r & (chi2_r <= chi2_th)
    better = inl_r.sum() >= inl.sum()
    R = torch.where(better, Rr, Rb)
    t = torch.where(better, tr, tb)
    inliers = torch.where(better, inl_r, inl)
    n_inl = inliers.sum(dtype=torch.int32)
    return PnPResult(n_inl >= min_inliers, R, t, inliers, n_inl)
