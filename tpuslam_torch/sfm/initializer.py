"""Monocular two-view initialization: batched H/F RANSAC and reconstruction.
Port of tpuslam/sfm/initializer.py.

Both models over all hypotheses are one batch: normalized DLT homographies
and 8-point fundamentals from (n_hyp, 9, 9) eigendecompositions, scored
with the symmetric-transfer / epipolar chi2 scores, the model chosen by
RH = SH / (SH + SF) > 0.40, the winner refit on all its inliers, and the
motion recovered by vetting every candidate (R, t) decomposition at once.

The hypothesis sets come from `picks` (n_hyp, 8) indices into the valid
rows when given (a test passes the JAX key's draws), else from `generator`.
eigh and svd may return other signs or another order of candidates than
the JAX package; the chosen motion does not depend on them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpuslam_torch.geometry.triangulation import triangulate_dlt
from tpuslam_torch.utils.metrics import traced

CHI2_H = 5.991
CHI2_F = 3.841
SCORE_CAP = 5.991  # both scores accumulate (cap - chi2)


class TwoViewResult(NamedTuple):
    success: torch.Tensor  # () bool
    R: torch.Tensor        # (3, 3) world(frame1)->frame2
    t: torch.Tensor        # (3,) unit-norm translation
    points: torch.Tensor   # (N, 3) triangulated in frame-1 coords
    is_h: torch.Tensor     # () bool: which model won
    inliers: torch.Tensor  # (N,) bool: triangulated good points
    n_good: torch.Tensor   # () int32


def _pick(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-d device index, without reading it on the host."""
    return x.index_select(0, i.reshape(1).long())[0]


def draw_picks(n_hyp: int, size: int, valid: torch.Tensor, generator=None) -> torch.Tensor:
    """(n_hyp, size) uniform indices in [0, max(n_valid, size)), the range of
    the JAX package's jax.random.randint, drawn from `generator` (a CPU
    torch.Generator) and moved to valid's device without a host read."""
    hi = torch.clamp(valid.sum(), min=size).to(torch.float32)
    u = torch.rand((n_hyp, size), generator=generator)
    with traced("read.picks"):  # a synchronising copy from pageable host memory
        u = u.to(valid.device)
    return torch.minimum(torch.floor(u * hi), hi - 1).to(torch.int64)


def _safe(x: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.where(torch.abs(x) < eps, torch.full_like(x, eps), x)


def _normalize(xy: torch.Tensor, valid: torch.Tensor):
    """Mean-0 / mean-abs-dev-1 normalization (Initializer::Normalize)."""
    w = valid.to(torch.float32)
    n = torch.clamp(w.sum(), min=1.0)
    mean = torch.sum(xy * w[:, None], dim=0) / n
    md = torch.sum(torch.abs(xy - mean) * w[:, None], dim=0) / n
    s = 1.0 / torch.clamp(md, min=1e-8)
    xn = (xy - mean) * s
    z = torch.zeros_like(s[0])
    T = torch.stack([
        torch.stack([s[0], z, -mean[0] * s[0]]),
        torch.stack([z, s[1], -mean[1] * s[1]]),
        torch.stack([z, z, torch.ones_like(z)]),
    ])
    return xn, T


def _h_rows(p1: torch.Tensor, p2: torch.Tensor, w=None) -> torch.Tensor:
    """DLT homography rows (..., 2n, 9) of n correspondences (..., n, 2)."""
    u1, v1 = p1[..., 0], p1[..., 1]
    u2, v2 = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(u1)
    o = torch.ones_like(u1)
    r1 = torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], dim=-1)
    r2 = torch.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], dim=-1)
    if w is not None:
        r1, r2 = r1 * w[:, None], r2 * w[:, None]
    return torch.cat([r1, r2], dim=-2)


def _f_rows(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """8-point fundamental rows (..., n, 9)."""
    u1, v1 = p1[..., 0], p1[..., 1]
    u2, v2 = p2[..., 0], p2[..., 1]
    o = torch.ones_like(u1)
    return torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, o], dim=-1)


def _null_vector(A: torch.Tensor) -> torch.Tensor:
    """The eigenvector of A^T A with the least eigenvalue, as (..., 3, 3)."""
    _, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    return vecs[..., :, 0].reshape(*A.shape[:-2], 3, 3)


def _rank2(F: torch.Tensor) -> torch.Tensor:
    """Zero the least singular value."""
    U, S, Vh = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    return U @ torch.diag_embed(S) @ Vh


def _score_homography(H21, H12, xy1, xy2, valid, sigma2: float):
    """Symmetric transfer score (CheckHomography) for H (..., 3, 3).
    Returns (score (...,), inlier mask (..., N))."""
    def transfer(H, a, b):
        x, y = a[:, 0], a[:, 1]
        den = _safe(H[..., 2, 0, None] * x + H[..., 2, 1, None] * y + H[..., 2, 2, None], 1e-12)
        u = (H[..., 0, 0, None] * x + H[..., 0, 1, None] * y + H[..., 0, 2, None]) / den
        v = (H[..., 1, 0, None] * x + H[..., 1, 1, None] * y + H[..., 1, 2, None]) / den
        return ((b[:, 0] - u) ** 2 + (b[:, 1] - v) ** 2) / sigma2

    c1 = transfer(H12, xy2, xy1)
    c2 = transfer(H21, xy1, xy2)
    in1 = c1 <= CHI2_H
    in2 = c2 <= CHI2_H
    score = torch.sum(torch.where(valid & in1, SCORE_CAP - c1, 0.0)
                      + torch.where(valid & in2, SCORE_CAP - c2, 0.0), dim=-1)
    return score, valid & in1 & in2


def _score_fundamental(F21, xy1, xy2, valid, sigma2: float):
    """Epipolar-distance score (CheckFundamental) for F (..., 3, 3)."""
    x1 = torch.cat([xy1, torch.ones_like(xy1[:, :1])], dim=-1)
    x2 = torch.cat([xy2, torch.ones_like(xy2[:, :1])], dim=-1)
    l2 = x1 @ F21.transpose(-1, -2)  # epipolar lines in image 2
    num2 = torch.sum(l2 * x2, dim=-1)
    c1 = num2 * num2 / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12) / sigma2
    l1 = x2 @ F21  # lines in image 1
    num1 = torch.sum(l1 * x1, dim=-1)
    c2 = num1 * num1 / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12) / sigma2
    in1 = c1 <= CHI2_F
    in2 = c2 <= CHI2_F
    score = torch.sum(torch.where(valid & in1, SCORE_CAP - c1, 0.0)
                      + torch.where(valid & in2, SCORE_CAP - c2, 0.0), dim=-1)
    return score, valid & in1 & in2


def _check_rt(Rs, ts, K, xy1, xy2, valid, sigma2: float):
    """Vet C candidate motions (C, 3, 3) / (C, 3) at once (CheckRT):
    triangulate every valid match, count points in front of both cameras
    with reprojection chi2 < 4 sigma2, and take the parallax of the 50th
    best. Returns (n_good (C,), parallax_deg (C,), good (C, N), X (C, N, 3))."""
    C, n = Rs.shape[0], xy1.shape[0]
    dev = xy1.device
    P1 = K @ torch.cat([torch.eye(3, device=dev), torch.zeros((3, 1), device=dev)], dim=1)
    P2 = K @ torch.cat([Rs, ts[..., None]], dim=-1)  # (C, 3, 4)
    X, w = triangulate_dlt(P1.expand(C, n, 3, 4), P2[:, None].expand(C, n, 3, 4),
                           xy1.expand(C, n, 2), xy2.expand(C, n, 2))
    finite = torch.all(torch.isfinite(X), dim=-1) & (torch.abs(w) > 1e-9)

    o2 = -(Rs.transpose(-1, -2) @ ts[..., None])[..., 0]  # camera-2 centre in frame 1
    r2 = X - o2[:, None]
    cosp = torch.sum(X * r2, dim=-1) / torch.clamp(
        torch.linalg.norm(X, dim=-1) * torch.linalg.norm(r2, dim=-1), min=1e-12)

    z1 = X[..., 2]
    Xc2 = torch.einsum("cij,cnj->cni", Rs, X) + ts[:, None]
    z2 = Xc2[..., 2]
    depth_ok = (z1 > 0) & (z2 > 0) | (cosp >= 0.99998)

    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u1 = fx * X[..., 0] / _safe(z1, 1e-9) + cx
    v1 = fy * X[..., 1] / _safe(z1, 1e-9) + cy
    u2 = fx * Xc2[..., 0] / _safe(z2, 1e-9) + cx
    v2 = fy * Xc2[..., 1] / _safe(z2, 1e-9) + cy
    e1 = (u1 - xy1[:, 0]) ** 2 + (v1 - xy1[:, 1]) ** 2
    e2 = (u2 - xy2[:, 0]) ** 2 + (v2 - xy2[:, 1]) ** 2
    reproj_ok = (e1 < 4.0 * sigma2) & (e2 < 4.0 * sigma2)

    good = valid & finite & depth_ok & reproj_ok & (z1 > 0) & (z2 > 0)
    n_good = good.sum(dim=-1, dtype=torch.int32)
    sorted_cos = torch.sort(torch.where(good, cosp, 1.0), dim=-1).values  # best parallax first
    idx = torch.clamp(n_good - 1, min=0, max=49).long()
    par_cos = torch.gather(sorted_cos, -1, idx[:, None])[:, 0]
    parallax_deg = torch.rad2deg(torch.arccos(torch.clamp(par_cos, -1.0, 1.0)))
    return n_good, parallax_deg, good, X


def _decompose_E(E: torch.Tensor):
    """E -> 4 (R, t) candidates (DecomposeE)."""
    U, _, Vh = torch.linalg.svd(E)
    t = U[:, 2] / torch.clamp(torch.linalg.norm(U[:, 2]), min=1e-12)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], device=E.device)
    R1 = U @ W @ Vh
    R1 = torch.where(torch.linalg.det(R1) < 0, -R1, R1)
    R2 = U @ W.T @ Vh
    R2 = torch.where(torch.linalg.det(R2) < 0, -R2, R2)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _decompose_H(H: torch.Tensor, K: torch.Tensor):
    """Faugeras homography decomposition -> 8 (R, t) candidates
    (ReconstructH): A = K^-1 H K = U diag(d) V^T; 4 solutions for d' = d2
    and 4 for d' = -d2."""
    A = torch.linalg.inv_ex(K)[0] @ H @ K
    U, d, Vh = torch.linalg.svd(A)
    s = torch.linalg.det(U) * torch.linalg.det(Vh)
    d1, d2, d3 = d[0], d[1], d[2]
    dev = H.device

    denom = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / denom, min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / denom, min=0.0))
    x1 = aux1 * torch.tensor([1.0, 1.0, -1.0, -1.0], device=dev)
    x3 = aux3 * torch.tensor([1.0, -1.0, 1.0, -1.0], device=dev)
    e = torch.tensor([1.0, -1.0, -1.0, 1.0], device=dev)
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    zero, one = torch.zeros_like(x1), torch.ones_like(x1)

    def candidates(cos, sin, sign_y, sign_r, tp):
        """R = s U Rp V^T and t = U tp, normalized, for the 4 sign cases."""
        cos = cos.expand(4)
        Rp = torch.stack([
            torch.stack([cos, zero, -sign_r * sin], -1),
            torch.stack([zero, sign_y * one, zero], -1),
            torch.stack([sin, zero, sign_y * cos], -1),
        ], -2)
        R = s * (U @ Rp @ Vh)
        t = tp @ U.T
        return R, t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=1e-12)

    # d' = +d2: Rp = [[c, 0, -s], [0, 1, 0], [s, 0, c]], tp = (x1, 0, -x3)(d1 - d3).
    sin_t = e * root / torch.clamp((d1 + d3) * d2, min=1e-12)
    cos_t = (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=1e-12)
    Rp_, tp_ = candidates(cos_t, sin_t, 1.0, 1.0, torch.stack([x1, zero, -x3], -1) * (d1 - d3))
    # d' = -d2: Rp = [[c, 0, s], [0, -1, 0], [s, 0, -c]], tp = (x1, 0, x3)(d1 + d3).
    sin_p = e * root / torch.clamp((d1 - d3) * d2, min=1e-12)
    cos_p = (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=1e-12)
    Rn_, tn_ = candidates(cos_p, sin_p, -1.0, -1.0, torch.stack([x1, zero, x3], -1) * (d1 + d3))
    return torch.cat([Rp_, Rn_]), torch.cat([tp_, tn_])


def initialize_two_view(K: torch.Tensor, xy1: torch.Tensor, xy2: torch.Tensor,
                        valid: torch.Tensor, *, generator=None, picks=None,
                        n_hypotheses: int = 200, sigma: float = 1.0,
                        min_parallax_deg: float = 1.0, min_triangulated: int = 50) -> TwoViewResult:
    """Monocular bootstrap from matched undistorted pixel pairs xy1/xy2
    (N, 2) with validity (N,) (Initializer::Initialize). Everything stays on
    the device of the inputs; no host read."""
    dev = xy1.device
    K = K.to(dev)
    sigma2 = sigma * sigma
    xn1, T1 = _normalize(xy1, valid)
    xn2, T2 = _normalize(xy2, valid)
    T2inv = torch.linalg.inv_ex(T2)[0]

    # 8-point sets from the valid rows, valid first in index order.
    valid_idx = torch.argsort((~valid).to(torch.int8), stable=True)
    if picks is None:
        picks = draw_picks(n_hypotheses, 8, valid, generator)
    sets = valid_idx[picks.to(dev).long()]  # (n_hyp, 8)

    p1, p2 = xn1[sets], xn2[sets]
    H_all = T2inv @ _null_vector(_h_rows(p1, p2)) @ T1
    H_all = H_all / _safe(H_all[:, 2, 2], 1e-12)[:, None, None]
    F_all = T2.T @ _rank2(_null_vector(_f_rows(p1, p2))) @ T1

    SH_all, _ = _score_homography(H_all, torch.linalg.inv_ex(H_all)[0], xy1, xy2, valid, sigma2)
    SF_all, _ = _score_fundamental(F_all, xy1, xy2, valid, sigma2)
    bh, bf = torch.argmax(SH_all), torch.argmax(SF_all)
    SH, SF = _pick(SH_all, bh), _pick(SF_all, bf)
    H_best, F_best = _pick(H_all, bh), _pick(F_all, bf)
    use_h = SH / torch.clamp(SH + SF, min=1e-12) > 0.40

    # Refit the winners on all their inliers (weighted DLT), then rescore.
    _, h_inl = _score_homography(H_best, torch.linalg.inv_ex(H_best)[0], xy1, xy2, valid, sigma2)
    _, f_inl = _score_fundamental(F_best, xy1, xy2, valid, sigma2)
    wh = torch.sqrt(h_inl.to(torch.float32))
    H_best = T2inv @ _null_vector(_h_rows(xn1, xn2, wh)) @ T1
    H_best = H_best / _safe(H_best[2, 2], 1e-12)
    wf = torch.sqrt(f_inl.to(torch.float32))
    F_best = T2.T @ _rank2(_null_vector(_f_rows(xn1, xn2) * wf[:, None])) @ T1
    _, h_inl = _score_homography(H_best, torch.linalg.inv_ex(H_best)[0], xy1, xy2, valid, sigma2)
    _, f_inl = _score_fundamental(F_best, xy1, xy2, valid, sigma2)
    model_inl = torch.where(use_h, h_inl, f_inl)

    # F's 4 candidates padded to 8 with zero-baseline motions that
    # triangulate nothing (not repeats: the distinctness test below).
    Rs_f, ts_f = _decompose_E(K.T @ F_best @ K)
    Rs_f = torch.cat([Rs_f, torch.eye(3, device=dev).expand(4, 3, 3)])
    ts_f = torch.cat([ts_f, torch.zeros((4, 3), device=dev)])
    Rs_h, ts_h = _decompose_H(H_best, K)
    Rs = torch.where(use_h, Rs_h, Rs_f)
    ts = torch.where(use_h, ts_h, ts_f)

    n_good, par, good, X = _check_rt(Rs, ts, K, xy1, xy2, model_inl, sigma2)
    best = torch.argmax(n_good)
    n_best = _pick(n_good, best)
    n_second = torch.sort(n_good).values[-2]
    distinct = n_second.to(torch.float32) < 0.75 * n_best.to(torch.float32)
    n_inliers = model_inl.sum(dtype=torch.int32)
    enough = n_best >= torch.clamp((0.9 * n_inliers).to(torch.int32), min=min_triangulated)
    parallax_ok = _pick(par, best) > min_parallax_deg
    success = distinct & enough & parallax_ok & (n_inliers >= 8)
    return TwoViewResult(success=success, R=_pick(Rs, best), t=_pick(ts, best),
                         points=_pick(X, best), is_h=use_h, inliers=_pick(good, best),
                         n_good=n_best)
