"""Pose-only optimization: one SE3 vertex, batched unary reprojection edges.
Port of tpuslam/optim/pose.py (Optimizer::PoseOptimization's schedule: 4
rounds of 10 LM iterations, chi2 inlier reclassification between rounds,
Huber on for the first two rounds).

Every function takes arbitrary leading batch dims (R (..., 3, 3), pts
(..., N, 3)), so B camera streams optimize in one call. Jacobians are g2o's
left-multiplied twist xi = [omega, v] on T_cw.

`pose_optimization` runs the whole schedule as one CUDA kernel
(csrc/pose_lm.cu, one block per stream) for CUDA tensors and
`pose_optimization_plain` for tensors off the card (the CPU; meta tensors,
which the segment tests trace). `pose_optimization.launches` counts kernel
launches.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from tpuslam_torch import _build
from tpuslam_torch.geometry.camera import PinholeCamera
from tpuslam_torch.geometry.se3 import hat, se3_compose, se3_exp, so3_project
from tpuslam_torch.ops.launch_count import count_launch
from tpuslam_torch.optim.linalg import solve_spd
from tpuslam_torch.optim.robust import CHI2_MONO, CHI2_STEREO


class PoseObs(NamedTuple):
    """Observation set; uvr rows are (u, v, u_right), u_right < 0 = mono."""

    pts_w: torch.Tensor      # (..., N, 3) world points
    uvr: torch.Tensor        # (..., N, 3) observed (u, v, u_right)
    inv_sigma2: torch.Tensor # (..., N) information scale per keypoint octave
    valid: torch.Tensor      # (..., N) bool


def _to_cam(R, t, pts_w):
    return torch.einsum("...ij,...nj->...ni", R, pts_w) + t[..., None, :]


def _residual_jacobian(cam: PinholeCamera, R, t, obs: PoseObs):
    """Residuals (..., N, 3) and Jacobians (..., N, 3, 6); the u_right row is
    zero for mono edges. Residual = observed - projected."""
    p = _to_cam(R, t, obs.pts_w)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    inv_z = 1.0 / z_safe
    inv_z2 = inv_z * inv_z

    u = cam.fx * x * inv_z + cam.cx
    v = cam.fy * y * inv_z + cam.cy
    ur = u - cam.bf * inv_z

    stereo = obs.uvr[..., 2] >= 0.0
    zeros = torch.zeros_like(x)
    r = torch.stack(
        [obs.uvr[..., 0] - u, obs.uvr[..., 1] - v,
         torch.where(stereo, obs.uvr[..., 2] - ur, zeros)],
        dim=-1,
    )
    du_dp = torch.stack([cam.fx * inv_z, zeros, -cam.fx * x * inv_z2], dim=-1)
    dv_dp = torch.stack([zeros, cam.fy * inv_z, -cam.fy * y * inv_z2], dim=-1)
    dur_dp = du_dp + torch.stack([zeros, zeros, cam.bf * inv_z2], dim=-1)
    dproj_dp = torch.stack([du_dp, dv_dp, dur_dp], dim=-2)  # (..., N, 3, 3)
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(*p.shape[:-1], 3, 3)
    dp_dxi = torch.cat([-hat(p), eye], dim=-1)  # (..., N, 3, 6)
    J = -(dproj_dp @ dp_dxi)
    keep_row = stereo[..., None] | (torch.arange(3, device=p.device) < 2)
    J = J * keep_row[..., None]
    return r, J, stereo


def edge_chi2(cam: PinholeCamera, R, t, obs: PoseObs):
    """Each edge's chi2 at the pose (R, t), (..., N): the squared
    reprojection error (the u_right row for stereo edges only) times its
    information, depth clamped to 1e-6 below |1e-6|."""
    p = _to_cam(R, t, obs.pts_w)
    z = torch.where(torch.abs(p[..., 2]) < 1e-6, torch.full_like(p[..., 2], 1e-6), p[..., 2])
    u = cam.fx * p[..., 0] / z + cam.cx
    v = cam.fy * p[..., 1] / z + cam.cy
    ur = u - cam.bf / z
    du = obs.uvr[..., 0] - u
    dv = obs.uvr[..., 1] - v
    dur = torch.where(obs.uvr[..., 2] >= 0.0, obs.uvr[..., 2] - ur, torch.zeros_like(ur))
    return (du * du + dv * dv + dur * dur) * obs.inv_sigma2


def pose_optimization_plain(cam: PinholeCamera, R0, t0, obs: PoseObs,
                            rounds: int = 4, iters_per_round: int = 10):
    """Optimize T_cw from 3D-2D(3) correspondences; leading batch dims OK.
    Returns (R, t, inlier_mask, n_inliers). The plain PyTorch version of
    csrc/pose_lm.cu: hundreds of small operations an LM iteration."""
    batch_shape = R0.shape[:-2]
    dev = R0.device
    stereo_mask = obs.uvr[..., 2] >= 0.0
    chi2_th = torch.where(stereo_mask, CHI2_STEREO, CHI2_MONO)
    delta_sq = chi2_th
    info = obs.inv_sigma2
    eye6 = torch.eye(6, dtype=R0.dtype, device=dev)

    def rho_sum(chi2, active, use_huber):
        if use_huber:
            rho = torch.where(
                chi2 > delta_sq,
                2.0 * torch.sqrt(delta_sq * torch.clamp(chi2, min=1e-12)) - delta_sq,
                chi2,
            )
        else:
            rho = chi2
        return torch.sum(rho * active, dim=-1)

    def lm_round(R, t, active, use_huber):
        lam = torch.full(batch_shape, 1e-3, dtype=torch.float32, device=dev)
        for _ in range(iters_per_round):
            r, J, _ = _residual_jacobian(cam, R, t, obs)
            chi2 = torch.sum(r * r, dim=-1) * info
            if use_huber:
                w = torch.clamp(torch.sqrt(delta_sq / torch.clamp(chi2, min=1e-12)), max=1.0)
            else:
                w = torch.ones_like(chi2)
            w = w * info * active
            H = torch.einsum("...nij,...n,...nik->...jk", J, w, J)
            b = -torch.einsum("...nij,...n,...ni->...j", J, w, r)
            dx = solve_spd(H + lam[..., None, None] * eye6, b)
            R_new, t_new = se3_compose(*se3_exp(dx), R, t)
            ok = rho_sum(edge_chi2(cam, R_new, t_new, obs), active, use_huber) < rho_sum(chi2, active, use_huber)
            R = torch.where(ok[..., None, None], R_new, R)
            t = torch.where(ok[..., None], t_new, t)
            lam = torch.where(ok, lam * 0.5, lam * 4.0)
        return R, t

    R, t = R0, t0
    active = obs.valid.to(torch.float32)
    inliers = obs.valid
    for rnd in range(rounds):
        R, t = lm_round(R, t, active, use_huber=rnd < 2)
        inliers = obs.valid & (edge_chi2(cam, R, t, obs) <= chi2_th)
        active = inliers.to(torch.float32)
    R = so3_project(R)
    return R, t, inliers, torch.sum(inliers.to(torch.int32), dim=-1)


def _check_args(R0, t0, obs: PoseObs, rounds: int, iters_per_round: int) -> None:
    """Devices, dtypes, shapes and layouts, from the tensors' metadata alone."""
    named = {"R0": R0, "t0": t0, **obs._asdict()}
    for name, x in named.items():
        if x.device != R0.device:
            raise ValueError(f"pose_optimization: R0 on {R0.device}, {name} on {x.device}")
        want = torch.bool if name == "valid" else torch.float32
        if x.dtype != want:
            raise ValueError(f"pose_optimization: {name} must be {want}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"pose_optimization: {name} must be contiguous")
    batch = tuple(R0.shape[:-2])
    n = obs.pts_w.shape[-2] if obs.pts_w.dim() >= 2 else -1
    shapes = {"R0": (*batch, 3, 3), "t0": (*batch, 3), "pts_w": (*batch, n, 3),
              "uvr": (*batch, n, 3), "inv_sigma2": (*batch, n), "valid": (*batch, n)}
    for name, shape in shapes.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"pose_optimization: {name} is {tuple(named[name].shape)}, "
                             f"want {shape} for R0 {tuple(R0.shape)}")
    if rounds < 0 or iters_per_round < 0:
        raise ValueError(f"pose_optimization: {rounds} rounds of {iters_per_round} iterations")


def _pose_optimization_cuda(cam: PinholeCamera, R0, t0, obs: PoseObs, rounds: int,
                            iters_per_round: int):
    batch = R0.shape[:-2]
    n = obs.pts_w.shape[-2]
    dev = R0.device
    R = torch.empty((*batch, 3, 3), dtype=torch.float32, device=dev)
    t = torch.empty((*batch, 3), dtype=torch.float32, device=dev)
    inliers = torch.empty((*batch, n), dtype=torch.bool, device=dev)
    n_inliers = torch.empty(batch, dtype=torch.int64, device=dev)
    B = math.prod(batch)
    if B == 0:
        return R, t, inliers, n_inliers
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = _build.lib().tpuslam_pose_lm(
            R0.data_ptr(), t0.data_ptr(), obs.pts_w.data_ptr(), obs.uvr.data_ptr(),
            obs.inv_sigma2.data_ptr(), obs.valid.data_ptr(), R.data_ptr(), t.data_ptr(),
            inliers.data_ptr(), n_inliers.data_ptr(), B, n, cam.fx, cam.fy, cam.cx, cam.cy,
            cam.bf, CHI2_MONO, CHI2_STEREO, rounds, iters_per_round, stream)
    _build.check(status, "pose_optimization")
    count_launch(pose_optimization)
    return R, t, inliers, n_inliers


def pose_optimization(cam: PinholeCamera, R0, t0, obs: PoseObs,
                      rounds: int = 4, iters_per_round: int = 10):
    """Optimize T_cw from 3D-2D(3) correspondences; leading batch dims, the
    same on every input. Returns (R, t, inlier_mask, n_inliers).

    Every input is contiguous, on one device; valid is bool, the rest
    float32. A CUDA tensor goes through the kernel (csrc/pose_lm.cu: one
    launch, no host read, no allocation but the outputs, so it captures into
    a CUDA graph), any other through pose_optimization_plain.
    `pose_optimization.launches` counts kernel launches; a replay of a
    captured graph does not move it, so pipeline/graphs.py adds the graph's
    captured launches on each replay."""
    _check_args(R0, t0, obs, rounds, iters_per_round)
    if R0.device.type == "cuda":
        return _pose_optimization_cuda(cam, R0, t0, obs, rounds, iters_per_round)
    return pose_optimization_plain(cam, R0, t0, obs, rounds, iters_per_round)


pose_optimization.launches = 0
