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

The JAX package jits the whole RANSAC. Here it is four segments (the
hypotheses' weights, EPnP's control points and null-space system, its
betas and the pose's cross-covariance, the selection and the refit's
verdict) through a `run` (StepGraphs.run replays each as a CUDA graph),
and between them the two eigh and the SVD of each EPnP run eagerly:
cuSOLVER's calls check their status on the host, which a capture refuses.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpuslam_torch.pipeline.graphs import call_segment
from tpuslam_torch.sfm.initializer import _pick, draw_picks

_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _pair_diffs(c: torch.Tensor) -> torch.Tensor:
    """(..., 4, 3) control points -> (..., 6, 3) differences c_i - c_j of
    the pairs (basic indexing: a list index would copy it to the device,
    which a capture refuses)."""
    return torch.stack([c[..., i, :] - c[..., j, :] for i, j in _PAIRS], dim=-2)


class PnPResult(NamedTuple):
    success: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def _kabsch_cross(Pw: torch.Tensor, Pc: torch.Tensor, w: torch.Tensor):
    """Weighted absolute orientation up to its SVD, batched: the centroids
    (cw, cc) and the weighted cross-covariance H = A^T B. Pw, Pc (..., n,
    3), w (..., n)."""
    wsum = torch.clamp(w.sum(-1), min=1e-9)[..., None]
    cw = torch.sum(Pw * w[..., None], dim=-2) / wsum
    cc = torch.sum(Pc * w[..., None], dim=-2) / wsum
    A = (Pw - cw[..., None, :]) * w[..., None]
    B = Pc - cc[..., None, :]
    return cw, cc, A.transpose(-1, -2) @ B


def _kabsch_pose(U, Vh, cw, cc):
    """R, t with Pc ~ R Pw + t from the SVD U S Vh of _kabsch_cross's H."""
    V, Ut = Vh.transpose(-1, -2), U.transpose(-1, -2)
    d = torch.linalg.det(V @ Ut)
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1))
    R = V @ D @ Ut
    return R, cc - (R @ cw[..., None])[..., 0]


def _pair_dists(c: torch.Tensor) -> torch.Tensor:
    """(..., 4, 3) control points -> (..., 6) squared distances of the pairs."""
    diff = _pair_diffs(c)
    return torch.sum(diff * diff, dim=-1)


def _epnp_cov(Pw: torch.Tensor, w: torch.Tensor):
    """EPnP's first stage for weighted point sets, batched over the leading
    dims of w (..., n) (0 excludes a point); Pw (n, 3): the weighted
    centroid c0 and covariance, whose eigh gives the control points."""
    wsum = torch.clamp(w.sum(-1), min=1e-9)[..., None]
    c0 = torch.sum(Pw * w[..., None], dim=-2) / wsum  # (..., 3)
    centered = (Pw - c0[..., None, :]) * torch.sqrt(w)[..., None]
    return c0, centered.transpose(-1, -2) @ centered / wsum[..., None]


def _epnp_system(Pw: torch.Tensor, uv: torch.Tensor, w: torch.Tensor, c0, eigval, eigvec, K):
    """EPnP's second stage from the covariance's eigh (ascending): the
    control points ctrl_w (..., 4, 3), the barycentric coordinates alphas
    (..., n, 4) and M^T M (..., 12, 12), whose eigh gives the null space."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
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
    return ctrl_w, alphas, M.transpose(-1, -2) @ M


def _epnp_cross(Pw: torch.Tensor, w: torch.Tensor, ctrl_w, alphas, vecs):
    """EPnP's third stage from M^T M's eigh: the betas by Gauss-Newton, the
    camera-frame points, then _kabsch_cross's (cw, cc, H) for the pose."""
    V = vecs[..., :, :4]  # the 4 least (columns), v0 the least
    Vc = V.transpose(-1, -2).reshape(*V.shape[:-2], 4, 4, 3)  # (..., k, ctrl, xyz)

    rho = _pair_dists(ctrl_w)  # world control-point distances
    d0 = _pair_dists(Vc[..., 0, :, :])
    beta1 = torch.sqrt(torch.sum(rho * d0, -1) / torch.clamp(torch.sum(d0 * d0, -1), min=1e-12))
    betas = torch.cat([beta1[..., None], torch.zeros_like(V[..., 0, 1:])], dim=-1)  # (..., 4)

    # Gauss-Newton on the 6 distance constraints (PnPsolver::gauss_newton),
    # with the Jacobian written out: d dist_ij / d beta_k =
    # 2 (c_i - c_j) . (v_k[i] - v_k[j]).
    dV = _pair_diffs(Vc)  # (..., 4, 6, 3)
    eye4 = 1e-9 * torch.eye(4, device=Pw.device)
    for _ in range(6):
        cc = torch.einsum("...k,...kcx->...cx", betas, Vc)
        diff = _pair_diffs(cc)  # (..., 6, 3)
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
    return _kabsch_cross(Pw, Pc, w)


def _epnp(run, tag: str, Pw, uv, w, K, c0, cov):
    """EPnP from _epnp_cov's (c0, cov): its stages through `run`, the two
    eigh and the SVD (cuSOLVER on a card, which a CUDA graph cannot
    capture: they check their status on the host) eagerly between them.
    Returns (U, Vh, cw, cc) for _kabsch_pose."""
    eigval, eigvec = torch.linalg.eigh(cov)  # ascending
    ctrl_w, alphas, MtM = run(f"pnp_system{tag}", _epnp_system, {}, Pw=Pw, uv=uv, w=w, c0=c0,
                              eigval=eigval, eigvec=eigvec, K=K)
    _, vecs = torch.linalg.eigh(MtM)
    cw, cc, H = run(f"pnp_cross{tag}", _epnp_cross, {}, Pw=Pw, w=w, ctrl_w=ctrl_w, alphas=alphas,
                    vecs=vecs)
    U, _, Vh = torch.linalg.svd(H)
    return U, Vh, cw, cc


def _reproj_chi2(K, pts_w, uv, inv_sigma2, R, t):
    """Per-point chi2 of the reprojection under (R, t), batched over its
    leading dims, and the in-front mask."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    p = torch.einsum("...ij,nj->...ni", R, pts_w) + t[..., None, :]
    z = p[..., 2]
    z = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    u = fx * p[..., 0] / z + cx
    v = fy * p[..., 1] / z + cy
    err = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
    return err * inv_sigma2, p[..., 2] > 0


def _pnp_hypotheses(pts_w, valid, picks):
    """The segment before the hypotheses' EPnP: each set's weights (n_hyp,
    n) and _epnp_cov of them."""
    n = pts_w.shape[0]
    valid_idx = torch.argsort((~valid).to(torch.int8), stable=True)
    sets = valid_idx[picks.long()]  # (n_hyp, 4)
    # Repeated indices within a set weigh once, as .at[idx4].set(1.0).
    w4 = torch.zeros((sets.shape[0], n), device=pts_w.device).scatter(1, sets, 1.0)
    return (w4,) + _epnp_cov(pts_w, w4)


def _pnp_select(K, pts_w, uv, inv_sigma2, valid, U, Vh, cw, cc, *, chi2_th: float):
    """The segment after the hypotheses' EPnP: the best hypothesis by
    inlier count, its inliers, and _epnp_cov of the refit's weights.
    Returns (Rb, tb, inl, w, c0, cov)."""
    Rs, ts = _kabsch_pose(U, Vh, cw, cc)
    chi2, front = _reproj_chi2(K, pts_w, uv, inv_sigma2, Rs, ts)
    counts = (valid & front & (chi2 <= chi2_th)).sum(-1, dtype=torch.int32)
    best = torch.argmax(counts)
    Rb, tb = _pick(Rs, best), _pick(ts, best)
    chi2, front = _reproj_chi2(K, pts_w, uv, inv_sigma2, Rb, tb)
    inl = valid & front & (chi2 <= chi2_th)
    w = inl.to(torch.float32) + 1e-9
    return (Rb, tb, inl, w) + _epnp_cov(pts_w, w)


def _pnp_finish(K, pts_w, uv, inv_sigma2, valid, Rb, tb, inl, U, Vh, cw, cc, *, chi2_th: float,
                min_inliers: int):
    """The segment after the refit's EPnP: the refit if it keeps as many
    inliers, else the best hypothesis. Returns PnPResult's fields."""
    Rr, tr = _kabsch_pose(U, Vh, cw, cc)
    chi2_r, front_r = _reproj_chi2(K, pts_w, uv, inv_sigma2, Rr, tr)
    inl_r = valid & front_r & (chi2_r <= chi2_th)
    better = inl_r.sum() >= inl.sum()
    R = torch.where(better, Rr, Rb)
    t = torch.where(better, tr, tb)
    inliers = torch.where(better, inl_r, inl)
    n_inl = inliers.sum(dtype=torch.int32)
    return n_inl >= min_inliers, R, t, inliers, n_inl


def pnp_ransac(K: torch.Tensor, pts_w: torch.Tensor, uv: torch.Tensor, inv_sigma2: torch.Tensor,
               valid: torch.Tensor, *, generator=None, picks=None, n_hypotheses: int = 128,
               chi2_th: float = 5.991, min_inliers: int = 10, run=call_segment) -> PnPResult:
    """Batched minimal-EPnP RANSAC. pts_w (N, 3), uv (N, 2) undistorted,
    per-point chi2 gates from inv_sigma2 (N,). The 4-point sets come from
    `picks` (n_hyp, 4) indices into the valid rows when given, else from
    `generator`, drawn before any segment. No host read. Its segments run
    through `run` (StepGraphs.run replays them; K must then be on the
    points' device), the eigh and SVD calls eagerly between them."""
    dev = pts_w.device
    K = K.to(dev)
    if picks is None:
        picks = draw_picks(n_hypotheses, 4, valid, generator)
    args = dict(K=K, pts_w=pts_w, uv=uv, inv_sigma2=inv_sigma2, valid=valid)
    w4, c0, cov = run("pnp_hypotheses", _pnp_hypotheses, {}, pts_w=pts_w, valid=valid,
                      picks=picks.to(dev))
    U, Vh, cw, cc = _epnp(run, "", pts_w, uv, w4, K, c0, cov)
    Rb, tb, inl, w, c0, cov = run("pnp_select", _pnp_select, dict(chi2_th=chi2_th), U=U, Vh=Vh,
                                  cw=cw, cc=cc, **args)
    # Refine on the inlier set.
    U, Vh, cw, cc = _epnp(run, "_refit", pts_w, uv, w, K, c0, cov)
    return PnPResult(*run("pnp_finish", _pnp_finish, dict(chi2_th=chi2_th, min_inliers=min_inliers),
                          Rb=Rb, tb=tb, inl=inl, U=U, Vh=Vh, cw=cw, cc=cc, **args))
