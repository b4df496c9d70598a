"""Bundle adjustment: batched Levenberg-Marquardt with a Schur-complement
reduced camera system. Port of tpuslam/optim/ba.py.

`bundle_adjustment` solves the reduced system S dx = rhs by block-Jacobi
preconditioned conjugate gradients, applying S = Hpp - W Hll^-1 W^T
matrix-free with edge gathers and scatter-sums (pipeline/_index.py's
scatter_sum: a fixed order of addition, so the card repeats its sums).
The local-BA solver `dense_schur_bundle_adjustment` assembles S densely
over at most A adjustable keyframes and solves it directly.

Both run their iterations as Python loops with no host read: the
accept/reject of each LM step and the CG step sizes are `torch.where`s on
the device. Problems are fixed-capacity tensors; fixed or invalid poses and
points are masked out of the Jacobians and their blocks pinned to identity.

`bundle_adjustment`'s LM iteration is one pure segment, `lm_step` (the
JAX package's `lax.scan` body), run through a `run` hook: by default
eagerly (pipeline/graphs.py's call_segment), through a StepGraphs as one
CUDA graph replay per iteration. An edge list may be padded to a fixed
length (pipeline/_index.py's edge_bucket) with edges parked out of range
(kf = K, pt = P): gathers clamp them, every sum over edges is a
scatter_sum, which drops them, and the robust cost is summed per keyframe
first, so the padded solve equals the unpadded one bit for bit on the
CPU. (Summed so, the costs round otherwise than one torch.sum over the
edges would: an LM step at a near tie can be taken or rejected the other
way.)

`bundle_adjustment` also runs as one shard's body of a distributed solve
(parallel/dist_ba.py), the counterpart of the JAX package's `axis_name`:
its `reduce` hook sums each partial normal-equation term over the shards.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from tpuslam_torch.geometry.camera import PinholeCamera
from tpuslam_torch.geometry.se3 import hat, se3_compose, se3_exp, so3_project
from tpuslam_torch.optim.robust import CHI2_MONO, CHI2_STEREO
from tpuslam_torch.pipeline._index import SumPlan, scatter_sum, sum_plan
from tpuslam_torch.pipeline.graphs import call_segment


class BAProblem(NamedTuple):
    """Edge e observes point pt[e] from keyframe kf[e] at pixel uvr[e]
    (u, v, u_right; u_right < 0 is a mono edge). fixed_* blocks contribute
    residuals but are not updated."""

    R: torch.Tensor           # (K, 3, 3) world->camera rotations
    t: torch.Tensor           # (K, 3)
    X: torch.Tensor           # (P, 3) world points
    kf: torch.Tensor          # (E,) int
    pt: torch.Tensor          # (E,) int
    uvr: torch.Tensor         # (E, 3)
    inv_sigma2: torch.Tensor  # (E,)
    valid: torch.Tensor       # (E,) bool
    fixed_kf: torch.Tensor    # (K,) bool
    fixed_pt: torch.Tensor    # (P,) bool


def _edge_terms(cam: PinholeCamera, R, t, X, prob: BAProblem):
    """Residual (E, 3), J_pose (E, 3, 6), J_pt (E, 3, 3), stereo mask. An
    edge parked out of range gathers the last keyframe and point."""
    kf = prob.kf.long().clamp(max=R.shape[0] - 1)
    pt = prob.pt.long().clamp(max=X.shape[0] - 1)
    Rk = R[kf]
    p = (Rk @ X[pt][..., None])[..., 0] + t[kf]
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    inv_z2 = inv_z * inv_z
    u = cam.fx * x * inv_z + cam.cx
    v = cam.fy * y * inv_z + cam.cy
    ur = u - cam.bf * inv_z
    stereo = prob.uvr[:, 2] >= 0.0
    zeros = torch.zeros_like(x)
    r = torch.stack([prob.uvr[:, 0] - u, prob.uvr[:, 1] - v,
                     torch.where(stereo, prob.uvr[:, 2] - ur, zeros)], dim=-1)
    du_dp = torch.stack([cam.fx * inv_z, zeros, -cam.fx * x * inv_z2], dim=-1)
    dv_dp = torch.stack([zeros, cam.fy * inv_z, -cam.fy * y * inv_z2], dim=-1)
    dur_dp = torch.where(stereo[:, None], du_dp + torch.stack([zeros, zeros, cam.bf * inv_z2], dim=-1), 0.0)
    dproj_dp = torch.stack([du_dp, dv_dp, dur_dp], dim=-2)  # (E, 3, 3)
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(p.shape[0], 3, 3)
    dp_dxi = torch.cat([-hat(p), eye], dim=-1)
    return r, -(dproj_dp @ dp_dxi), -(dproj_dp @ Rk), stereo


def _batched_inv3(A: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Batched 3x3 inverse via the adjugate."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co00, co01, co02 = e * i - f * h, c * h - b * i, b * f - c * e
    co10, co11, co12 = f * g - d * i, a * i - c * g, c * d - a * f
    co20, co21, co22 = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * co00 + b * co10 + c * co20
    det = torch.where(torch.abs(det) < eps, torch.full_like(det, eps), det)
    adj = torch.stack([torch.stack([co00, co01, co02], -1),
                       torch.stack([co10, co11, co12], -1),
                       torch.stack([co20, co21, co22], -1)], -2)
    return adj / det[..., None, None]


def _chol3(A: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Batched closed-form 3x3 Cholesky (lower); pivots floored for stray
    non-PD blocks."""
    l00 = torch.sqrt(torch.clamp(A[..., 0, 0], min=eps))
    l10 = A[..., 1, 0] / l00
    l20 = A[..., 2, 0] / l00
    l11 = torch.sqrt(torch.clamp(A[..., 1, 1] - l10 * l10, min=eps))
    l21 = (A[..., 2, 1] - l20 * l10) / l11
    l22 = torch.sqrt(torch.clamp(A[..., 2, 2] - l20 * l20 - l21 * l21, min=eps))
    z = torch.zeros_like(l00)
    return torch.stack([torch.stack([l00, z, z], -1),
                        torch.stack([l10, l11, z], -1),
                        torch.stack([l20, l21, l22], -1)], -2)


def _blockdiag6(Hpp: torch.Tensor) -> torch.Tensor:
    """(A, 6, 6) blocks -> (A*6, A*6) dense block-diagonal."""
    A = Hpp.shape[0]
    out = torch.zeros((A, 6, A, 6), dtype=Hpp.dtype, device=Hpp.device)
    ar = torch.arange(A, device=Hpp.device)
    out[ar, :, ar, :] = Hpp
    return out.reshape(A * 6, A * 6)


def _robust(c, delta_sq, use_huber: bool):
    if not use_huber:
        return c
    return torch.where(c > delta_sq, 2.0 * torch.sqrt(delta_sq * torch.clamp(c, min=1e-12)) - delta_sq, c)


def _huber_weight(chi2, delta_sq, use_huber: bool):
    if not use_huber:
        return torch.ones_like(chi2)
    return torch.clamp(torch.sqrt(delta_sq / torch.clamp(chi2, min=1e-12)), max=1.0)


def _lm_accept(cam, prob, R, t, X, R_new, t_new, X_new, lam, active0, delta_sq, use_huber,
               reduce=None, by_kf: Optional[SumPlan] = None):
    """One LM accept/reject on the device: the step is taken where the robust
    cost falls; lambda halves on success and quadruples on failure. With a
    `reduce` hook both costs are summed over the shards in one reduction.
    With `by_kf` (sum_plan(prob.kf, K)) each cost is summed per keyframe in
    edge order, then over the keyframes: edges parked out of range drop
    out, and the padding leaves the sums as they are."""
    def edge_cost(R, t, X):
        r, _, _, _ = _edge_terms(cam, R, t, X, prob)
        return _robust(torch.sum(r * r, -1) * prob.inv_sigma2, delta_sq, use_huber) * active0

    def total(R, t, X):
        return torch.sum(edge_cost(R, t, X))

    if by_kf is not None:
        costs = torch.stack([edge_cost(R_new, t_new, X_new), edge_cost(R, t, X)], dim=-1)
        new, old = scatter_sum(R.shape[0], prob.kf, costs, by_kf).sum(0).unbind()
        ok = new < old
    elif reduce is None:
        ok = total(R_new, t_new, X_new) < total(R, t, X)
    else:
        new, old = reduce(torch.stack([total(R_new, t_new, X_new), total(R, t, X)]), "pose").unbind()
        ok = new < old
    return (torch.where(ok, R_new, R), torch.where(ok, t_new, t), torch.where(ok, X_new, X),
            torch.where(ok, lam * 0.5, lam * 4.0))


def _edge_chi2(cam, prob, R, t, X):
    r, _, _, _ = _edge_terms(cam, R, t, X, prob)
    return torch.sum(r * r, dim=-1) * prob.inv_sigma2


Reduce = Callable[[torch.Tensor, str], torch.Tensor]


class BAPlans(NamedTuple):
    """The scatter-sum plans of a problem's edges, fixed across its LM
    iterations."""

    by_pt: SumPlan  # sum_plan(prob.pt, P)
    by_kf: SumPlan  # sum_plan(prob.kf, K)


def ba_plans(prob: BAProblem) -> BAPlans:
    return BAPlans(sum_plan(prob.pt, prob.X.shape[0]), sum_plan(prob.kf, prob.R.shape[0]))


def lm_step(cam: PinholeCamera, prob: BAProblem, plans: BAPlans, R, t, X, lam, *, use_huber: bool,
            cg_iters: int, reduce: Optional[Reduce] = None):
    """One LM iteration of bundle_adjustment from (R, t, X, lam): the normal
    equations, `cg_iters` block-Jacobi PCG iterations on the reduced camera
    system, the back-substitution and the accept/reject, all on the device.
    Returns the new (R, t, X, lam). Without `reduce` a pure segment (no host
    read, inputs unmodified); an edge parked out of range (kf = K, pt = P)
    is gathered clamped and dropped by every scatter_sum."""
    K, P = R.shape[0], X.shape[0]
    dev = X.device
    kf, pt = prob.kf.long(), prob.pt.long()
    kfc, ptc = kf.clamp(max=K - 1), pt.clamp(max=P - 1)
    by_pt, by_kf = plans
    delta_sq = torch.where(prob.uvr[:, 2] >= 0.0, CHI2_STEREO, CHI2_MONO)
    info = prob.inv_sigma2
    eye3 = torch.eye(3, device=dev)
    eye6 = torch.eye(6, device=dev)
    active0 = prob.valid.to(torch.float32)
    kf_pinned, pt_pinned = prob.fixed_kf, prob.fixed_pt
    fixed_kf_e, fixed_pt_e = kf_pinned[kfc], pt_pinned[ptc]

    r, Jp, Jl, _ = _edge_terms(cam, R, t, X, prob)
    chi2 = torch.sum(r * r, dim=-1) * info
    w = _huber_weight(chi2, delta_sq, use_huber) * info * active0
    Jp = torch.where(fixed_kf_e[:, None, None], 0.0, Jp)
    Jl = torch.where(fixed_pt_e[:, None, None], 0.0, Jl)

    wJp = w[:, None, None] * Jp
    wJl = w[:, None, None] * Jl
    Hpp_e = wJp.transpose(-1, -2) @ Jp   # (E, 6, 6)
    Hll_e = wJl.transpose(-1, -2) @ Jl   # (E, 3, 3)
    W_e = wJp.transpose(-1, -2) @ Jl     # (E, 6, 3): the Hpl block
    bp_e = -torch.einsum("eij,ei->ej", wJp, r)
    bl_e = -torch.einsum("eij,ei->ej", wJl, r)

    Hll = scatter_sum(P, pt, Hll_e, by_pt)
    bl = scatter_sum(P, pt, bl_e, by_pt)
    if reduce is not None:
        acc_l = reduce(torch.cat([Hll.reshape(P, 9), bl], dim=-1), "point")
        Hll, bl = acc_l[:, :9].reshape(P, 3, 3), acc_l[:, 9:]
    # LM damping plus a trace-relative floor (see the JAX package: rank-2
    # single-observation point blocks), fixed/empty blocks pinned.
    tr3 = (Hll[:, 0, 0] + Hll[:, 1, 1] + Hll[:, 2, 2])[:, None, None]
    Hll = Hll + (lam + 1e-5 * tr3 + 1e-10) * eye3
    Hll = torch.where(pt_pinned[:, None, None], eye3, Hll)
    bl = torch.where(pt_pinned[:, None], 0.0, bl)
    W_e = torch.where((fixed_kf_e | fixed_pt_e)[:, None, None], 0.0, W_e)
    Hll_inv = _batched_inv3(Hll)

    z0 = (Hll_inv @ bl[..., None])[..., 0]
    coup_e = (W_e @ z0[ptc][..., None])[..., 0]
    packed = scatter_sum(K, kf, torch.cat([Hpp_e, bp_e[..., None], coup_e[..., None]], dim=-1), by_kf)
    if reduce is not None:
        packed = reduce(packed, "pose")
    Hpp, bp, coup = packed[..., :6], packed[..., 6], packed[..., 7]
    tr6 = torch.diagonal(Hpp, dim1=-2, dim2=-1).sum(-1)[:, None, None]
    Hpp = Hpp + (lam + 1e-5 * tr6 + 1e-10) * eye6
    Hpp = torch.where(kf_pinned[:, None, None], eye6, Hpp)
    bp = torch.where(kf_pinned[:, None], 0.0, bp)
    W_t = W_e.transpose(-1, -2)

    def S_matvec(vk):
        ysum = scatter_sum(P, pt, (W_t @ vk[kfc][..., None])[..., 0], by_pt)
        if reduce is not None:
            ysum = reduce(ysum, "point")
        z = (Hll_inv @ ysum[..., None])[..., 0]
        coupling = scatter_sum(K, kf, (W_e @ z[ptc][..., None])[..., 0], by_kf)
        if reduce is not None:
            coupling = reduce(coupling, "pose")
        return (Hpp @ vk[..., None])[..., 0] - coupling

    rhs = bp - torch.where(kf_pinned[:, None], 0.0, coup)
    Minv = torch.linalg.inv_ex(Hpp)[0]
    xk = torch.zeros((K, 6), device=dev)
    rk = rhs
    pk = (Minv @ rk[..., None])[..., 0]
    rz = torch.sum(rk * pk)
    for _ in range(cg_iters):
        Sp = S_matvec(pk)
        denom = torch.sum(pk * Sp)
        alpha = torch.where(torch.abs(denom) > 1e-12, rz / denom, 0.0)
        xk = xk + alpha * pk
        rk = rk - alpha * Sp
        zk = (Minv @ rk[..., None])[..., 0]
        rz_new = torch.sum(rk * zk)
        beta = torch.where(torch.abs(rz) > 1e-12, rz_new / rz, 0.0)
        pk = zk + beta * pk
        rz = rz_new
    dx_pose = xk

    # Back-substitute the points: dx_pt = Hll^-1 (bl - W^T dx_pose).
    hlp_dx = scatter_sum(P, pt, (W_t @ dx_pose[kfc][..., None])[..., 0], by_pt)
    if reduce is not None:
        hlp_dx = reduce(hlp_dx, "point")
    dx_pt = (Hll_inv @ (bl - hlp_dx)[..., None])[..., 0]
    dx_pose = torch.where(kf_pinned[:, None], 0.0, dx_pose)
    dx_pt = torch.where(pt_pinned[:, None], 0.0, dx_pt)

    R_new, t_new = se3_compose(*se3_exp(dx_pose), R, t)
    return _lm_accept(cam, prob, R, t, X, R_new, t_new, X + dx_pt, lam, active0, delta_sq, use_huber,
                      reduce, by_kf=by_kf if reduce is None else None)


def bundle_adjustment(cam: PinholeCamera, prob: BAProblem, iters: int = 10, use_huber: bool = True,
                      cg_iters: int = 40, lam0: float = 1e-4, reduce: Optional[Reduce] = None,
                      run=None):
    """`iters` LM steps (lm_step), each solving the reduced camera system by
    `cg_iters` block-Jacobi PCG iterations. Returns (R, t, X, edge_chi2).

    run: how each LM step runs (StepGraphs.run's signature: name, fn,
    static arguments, tensor inputs); None runs it eagerly (call_segment).

    reduce: None on one device. Otherwise the call is one shard of a
    distributed solve (run eagerly, `run` unused): prob holds this shard's
    edges (and, point-sharded,
    its block of points), the poses are replicated, and reduce(x, side)
    returns the sum of the shards' partial tensors x on this shard's
    device. Side "pose" is the robust cost, the packed (K, 6, 8) Hpp / bp
    / coupling and the coupling in S v (the JAX package's three psum
    sites); side "point" is Hll with bl, S v's point sums and the
    back-substitution's W^T dx, which the hook leaves alone when each shard
    owns its points and sums when the edges are split over replicated
    points. Every shard then walks the same pose iterates."""
    plans = ba_plans(prob)
    R, t, X = prob.R, prob.t, prob.X
    lam = torch.full((), lam0, dtype=torch.float32, device=prob.X.device)
    if reduce is not None:
        for _ in range(iters):
            R, t, X, lam = lm_step(cam, prob, plans, R, t, X, lam, use_huber=use_huber,
                                   cg_iters=cg_iters, reduce=reduce)
    else:
        run = call_segment if run is None else run
        static = dict(cam=cam, use_huber=use_huber, cg_iters=cg_iters)
        for _ in range(iters):
            R, t, X, lam = run("ba_lm", lm_step, static, prob=prob, plans=plans, R=R, t=t, X=X, lam=lam)
    # Exact rotations written back: map poses feed every later composition.
    R = so3_project(R)
    return R, t, X, _edge_chi2(cam, prob, R, t, X)


def dense_schur_bundle_adjustment(cam: PinholeCamera, prob: BAProblem, active: torch.Tensor,
                                  iters: int = 10, use_huber: bool = True, lam0: float = 1e-4):
    """LM bundle adjustment with an explicit dense reduced camera system over
    the (A,) keyframe slots of `active` (padded with -1); every keyframe not
    listed is held fixed, as is prob.fixed_kf. The pose side is summed per
    active slot with a scatter-sum (the parked slot A dropped), the coupling
    Sum_p B_p^T B_p with B[p, a] = L_p^T W_{a,p}^T (L_p L_p^T = Hll_p^-1) is
    one edge scatter and one matrix product, and the (A*6)^2 system is
    solved directly. Returns (R, t, X, edge_chi2)."""
    K, P = prob.R.shape[0], prob.X.shape[0]
    A = active.shape[0]
    dev = prob.X.device
    kf, pt = prob.kf.long(), prob.pt.long()
    delta_sq = torch.where(prob.uvr[:, 2] >= 0.0, CHI2_STEREO, CHI2_MONO)
    info = prob.inv_sigma2
    eye3 = torch.eye(3, device=dev)
    eye6 = torch.eye(6, device=dev)

    # Edge -> active slot, A (parked) for fixed and inactive keyframes.
    act_ok = active >= 0
    act = active.long()
    slot_of_kf = torch.full((K + 1,), A, dtype=torch.int64, device=dev)
    slot_of_kf[torch.where(act_ok, act, K)] = torch.where(
        act_ok, torch.arange(A, device=dev), A)
    slot_of_kf = torch.where(prob.fixed_kf, A, slot_of_kf[:K])
    a_e = slot_of_kf[kf]
    e_active = a_e < A
    active0 = prob.valid.to(torch.float32)
    pt_pinned = prob.fixed_pt
    pt_pinned_e = pt_pinned[pt]
    by_pt, by_slot = sum_plan(pt, P), sum_plan(a_e, A + 1)
    by_pair = sum_plan(pt * (A + 1) + a_e, P * (A + 1))

    R, t, X = prob.R, prob.t, prob.X
    lam = torch.full((), lam0, dtype=torch.float32, device=dev)
    for _ in range(iters):
        r, Jp, Jl, _ = _edge_terms(cam, R, t, X, prob)
        chi2 = torch.sum(r * r, dim=-1) * info
        w = _huber_weight(chi2, delta_sq, use_huber) * info * active0
        Jp = torch.where(e_active[:, None, None], Jp, 0.0)
        Jl = torch.where(pt_pinned_e[:, None, None], 0.0, Jl)

        wJp = w[:, None, None] * Jp
        wJl = w[:, None, None] * Jl
        Hpp_e = wJp.transpose(-1, -2) @ Jp
        Hll_e = wJl.transpose(-1, -2) @ Jl
        W_e = wJp.transpose(-1, -2) @ Jl  # (E, 6, 3)
        bp_e = -torch.einsum("eij,ei->ej", wJp, r)
        bl_e = -torch.einsum("eij,ei->ej", wJl, r)

        # Point side: one packed scatter (Hll 9 + bl 3 floats).
        acc_l = scatter_sum(P, pt, torch.cat([Hll_e.reshape(-1, 9), bl_e], dim=-1), by_pt)
        Hll = acc_l[:, :9].reshape(P, 3, 3)
        bl = acc_l[:, 9:]
        tr3 = (Hll[:, 0, 0] + Hll[:, 1, 1] + Hll[:, 2, 2])[:, None, None]
        Hll = Hll + (lam + 1e-5 * tr3 + 1e-10) * eye3
        Hll = torch.where(pt_pinned[:, None, None], eye3, Hll)
        bl = torch.where(pt_pinned[:, None], 0.0, bl)
        Hll_inv = _batched_inv3(Hll)
        L = _chol3(Hll_inv)

        # Pose side per active slot, the parked slot A dropped.
        z0 = (Hll_inv @ bl[..., None])[..., 0]
        coup_e = (W_e @ z0[pt][..., None])[..., 0]
        acc_p = scatter_sum(A + 1, a_e, torch.cat([Hpp_e.reshape(-1, 36), bp_e, coup_e], dim=-1),
                         by_slot)[:A]
        Hpp = acc_p[:, :36].reshape(A, 6, 6)
        bp, coup = acc_p[:, 36:42], acc_p[:, 42:]
        tr6 = torch.diagonal(Hpp, dim1=-2, dim2=-1).sum(-1)[:, None, None]
        Hpp = Hpp + (lam + 1e-5 * tr6 + 1e-10) * eye6
        Hpp = torch.where(act_ok[:, None, None], Hpp, eye6)
        bp = torch.where(act_ok[:, None], bp, 0.0)
        rhs = bp - torch.where(act_ok[:, None], coup, 0.0)

        # Coupling: B (P, A, 3, 6) by one edge scatter, Sc = B^T B.
        B_e = L[pt].transpose(-1, -2) @ W_e.transpose(-1, -2)  # (E, 3, 6)
        B = scatter_sum(P * (A + 1), pt * (A + 1) + a_e, B_e.reshape(-1, 18), by_pair)
        B = B.reshape(P, A + 1, 3, 6)[:, :A]
        Bm = B.permute(0, 2, 1, 3).reshape(P * 3, A * 6)
        S = _blockdiag6(Hpp) - Bm.T @ Bm

        dx_a = torch.linalg.solve_ex(S, rhs.reshape(A * 6, 1))[0].reshape(A, 6)
        dx_a = torch.where(act_ok[:, None], dx_a, 0.0)
        dx_pose = scatter_sum(K, torch.where(act_ok, act, K - 1), dx_a)

        hlp_dx = scatter_sum(P, pt, (W_e.transpose(-1, -2) @ dx_pose[kf][..., None])[..., 0], by_pt)
        dx_pt = (Hll_inv @ (bl - hlp_dx)[..., None])[..., 0]
        dx_pt = torch.where(pt_pinned[:, None], 0.0, dx_pt)

        R_new, t_new = se3_compose(*se3_exp(dx_pose), R, t)
        R, t, X, lam = _lm_accept(cam, prob, R, t, X, R_new, t_new, X + dx_pt, lam,
                                  active0, delta_sq, use_huber)
    R = so3_project(R)
    return R, t, X, _edge_chi2(cam, prob, R, t, X)
