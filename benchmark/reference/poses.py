"""Plain NumPy reference for trajectories: the alignment of an estimated
world to the truth's (a similarity for a monocular trajectory, rigid for a
metric one), the absolute trajectory error, and the relative pose errors
between consecutive poses. Poses are world->camera (R, t). Imports nothing
of the program.
"""

from __future__ import annotations

import numpy as np


def centres(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Camera centres -R^T t of (n, 3, 3), (n, 3) poses."""
    return -np.einsum("nji,nj->ni", R, t)


def _project_so3(M: np.ndarray) -> np.ndarray:
    U, _, Vt = np.linalg.svd(M)
    D = np.eye(3)
    D[2, 2] = np.sign(np.linalg.det(U @ Vt))
    return U @ D @ Vt


def align(R: np.ndarray, t: np.ndarray, R_gt: np.ndarray, t_gt: np.ndarray, fix_scale: bool) -> tuple:
    """(s, A, b) taking the estimate's world to the truth's, x_gt = s A x + b.
    The rotation comes from the cameras' orientations (the mean of
    R_gt^T R over the poses, projected onto SO(3)): a route along a line
    leaves the rotation about that line free in a fit of the centres alone.
    The scale (1 with fix_scale) and the offset then fit the centres by
    least squares."""
    A = _project_so3(np.einsum("nji,njk->ik", R_gt, R))
    C, Cg = centres(R, t) @ A.T, centres(R_gt, t_gt)
    c, cg = C - C.mean(0), Cg - Cg.mean(0)
    var = float(np.sum(c * c))
    s = 1.0 if fix_scale or var == 0 else float(np.sum(c * cg) / var)
    return s, A, Cg.mean(0) - s * C.mean(0)


def ate(R, t, R_gt, t_gt, fix_scale: bool) -> tuple:
    """(RMSE of the aligned centres against the truth, the alignment)."""
    s, A, b = align(R, t, R_gt, t_gt, fix_scale)
    d = s * centres(R, t) @ A.T + b - centres(R_gt, t_gt)
    return float(np.sqrt(np.mean(np.sum(d * d, axis=1)))), (s, A, b)


def relative_errors(R: np.ndarray, t: np.ndarray, R_gt: np.ndarray, t_gt: np.ndarray,
                    metric: bool) -> tuple:
    """Per consecutive pair (k, k+1): the camera's motion T_{k+1} T_k^-1 of
    the estimate against the truth's. Returns (translation error (n-1,) in
    metres, rotation error (n-1,) in degrees). A metric estimate is taken
    as it is; a monocular one has no scale, so each pair's translation is
    put at the true length first and only its direction is judged (a
    motion under 1e-9, rounding of a pose that did not move, has none)."""
    def rel(R, t):
        Rr = R[1:] @ np.swapaxes(R[:-1], 1, 2)
        return Rr, t[1:] - np.einsum("nij,nj->ni", Rr, t[:-1])

    Re, te = rel(np.asarray(R, np.float64), np.asarray(t, np.float64))
    Rg, tg = rel(np.asarray(R_gt, np.float64), np.asarray(t_gt, np.float64))
    if not metric:
        ne = np.linalg.norm(te, axis=1, keepdims=True)
        moved = ne > 1e-9
        te = np.where(moved, te / np.where(moved, ne, 1.0), 0.0) * np.linalg.norm(tg, axis=1, keepdims=True)
    dt = np.linalg.norm(te - tg, axis=1)
    dR = Re @ np.swapaxes(Rg, 1, 2)
    cos = np.clip((np.trace(dR, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    return dt, np.degrees(np.arccos(cos))


def rms(x) -> float:
    x = np.asarray(x, np.float64)
    return float(np.sqrt(np.mean(x * x))) if x.size else float("inf")
