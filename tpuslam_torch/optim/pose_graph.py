"""Sim3 pose-graph (essential graph) optimization. Port of
tpuslam/optim/pose_graph.py.

Gauss-Newton over 7-DoF Sim3 nodes (6 with the scale fixed) with the edge
residual e_ij = log(S_ji_meas * S_i * S_j^-1). Each edge's 7x7 Jacobians are
forward-mode derivatives at the zero tangent (torch.func.jvp along the 7
basis directions, all edges at once), as jax.jacfwd in the JAX package.
Graphs of at most `dense_max_nodes` nodes solve the dense (7K)^2 system;
larger ones run a block-Jacobi preconditioned conjugate gradient with H x
applied from the edge Jacobians.

Every float scatter-sum (b, H, the preconditioner's blocks and the CG's
H x) goes through pipeline/_index.py's scatter_sum, whose order of
addition is fixed: the card repeats its results.

The CG follows jax.scipy.sparse.linalg.cg exactly (x0 = 0, stop when
|r|^2 <= tol^2 |b|^2 with tol = 1e-6 and atol = 0, or after cg_iters), as a
fixed-length loop whose state stops changing once converged; every
CG_CHECK_EVERY iterations one device->host read ends the loop early when
it has converged, which leaves dx as it is.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tpuslam_torch.geometry.sim3 import sim3_compose, sim3_exp, sim3_inverse, sim3_log
from tpuslam_torch.pipeline._index import scatter_sum, sum_plan

CG_CHECK_EVERY = 10  # CG iterations between the convergence reads


class Sim3Edges(NamedTuple):
    """Relative-pose constraints i -> j: meas_* hold S_ji = S_j S_i^-1 at
    measurement time; weight scales the edge."""

    i: torch.Tensor       # (E,) int
    j: torch.Tensor       # (E,) int
    meas_s: torch.Tensor  # (E,)
    meas_R: torch.Tensor  # (E, 3, 3)
    meas_t: torch.Tensor  # (E, 3)
    valid: torch.Tensor   # (E,) bool
    weight: torch.Tensor  # (E,)


def make_relative(s_i, R_i, t_i, s_j, R_j, t_j):
    """S_ji = S_j * S_i^-1 for batched node poses."""
    return sim3_compose(s_j, R_j, t_j, *sim3_inverse(s_i, R_i, t_i))


def _edge_residual(xi_i, xi_j, s_i, R_i, t_i, s_j, R_j, t_j, ms, mR, mt):
    """e = log(S_ji_meas * (exp(xi_i) S_i) * (exp(xi_j) S_j)^-1), batched
    over edges."""
    s1, R1, t1 = sim3_compose(*sim3_exp(xi_i), s_i, R_i, t_i)
    s2, R2, t2 = sim3_compose(*sim3_exp(xi_j), s_j, R_j, t_j)
    se, Re, te = sim3_compose(*sim3_compose(ms, mR, mt, s1, R1, t1), *sim3_inverse(s2, R2, t2))
    return sim3_log(se, Re, te)


def _edge_jacobians(args):
    """(r (E, 7), J_i (E, 7, 7), J_j (E, 7, 7)) at the zero tangents: one
    forward-mode pass per basis direction, every edge at once (an edge's
    residual depends on its own tangents only)."""
    E = args[0].shape[0]
    dev = args[0].device
    zero = torch.zeros((E, 7), device=dev)
    basis = torch.eye(7, device=dev)[:, None, :].expand(7, E, 7)

    def col(fn):
        return torch.func.vmap(lambda v: torch.func.jvp(fn, (zero,), (v,))[1])(basis)

    J_i = col(lambda x: _edge_residual(x, zero, *args))  # (7 tangents, E, 7 rows)
    J_j = col(lambda x: _edge_residual(zero, x, *args))
    r = _edge_residual(zero, zero, *args)
    return r, J_i.permute(1, 2, 0), J_j.permute(1, 2, 0)


def _vdot(a, b):
    return torch.sum(a * b)


def _cg(matvec, b, precond, maxiter: int, tol: float, stats: dict):
    """jax.scipy.sparse.linalg.cg's preconditioned CG, as a masked loop."""
    atol2 = tol * tol * _vdot(b, b)
    x = torch.zeros_like(b)
    r = b - matvec(x)
    z = precond(r)
    p = z
    gamma = _vdot(r, z)
    n_active = torch.zeros((), dtype=torch.int32, device=b.device)
    for it in range(maxiter):
        active = _vdot(r, r) > atol2
        if it and it % CG_CHECK_EVERY == 0:
            stats["reads"] = stats.get("reads", 0) + 1
            if not bool(active):
                break
        Ap = matvec(p)
        alpha = gamma / _vdot(p, Ap)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        z_new = precond(r_new)
        gamma_new = _vdot(r_new, z_new)
        p_new = z_new + (gamma_new / gamma) * p
        x = torch.where(active, x_new, x)
        r = torch.where(active, r_new, r)
        p = torch.where(active, p_new, p)
        gamma = torch.where(active, gamma_new, gamma)
        n_active = n_active + active.to(torch.int32)
    stats.setdefault("cg_iters", []).append(n_active)
    return x


def optimize_pose_graph(s, R, t, node_valid, node_fixed, edges: Sim3Edges, iters: int = 20,
                        fix_scale: bool = False, lam: float = 1e-6, dense_max_nodes: int = 192,
                        cg_iters: int = 150, stats: Optional[dict] = None):
    """Optimize node Sim3 poses S_iw. node_fixed pins poses (the loop
    keyframe); with fix_scale the scale dimension is projected out. Returns
    (s, R, t, errs (iters,)): errs[k] is the weighted squared residual
    before step k. `stats`, when given, collects each GN step's count of
    CG iterations (device tensors) and the CG's device->host reads."""
    K = s.shape[0]
    dev = s.device
    stats = {} if stats is None else stats
    ei, ej = edges.i.long(), edges.j.long()
    w = edges.valid.to(torch.float32) * edges.weight
    pin_node = node_fixed | ~node_valid
    scale_dim = torch.arange(7, device=dev) == 6
    eye7 = torch.eye(7, device=dev)
    ends = torch.cat([ei, ej])
    by_node = sum_plan(ends, K)
    dense = K <= dense_max_nodes
    if dense:
        blocks = torch.cat([ei * K + ei, ej * K + ej, ei * K + ej, ej * K + ei])
        by_block = sum_plan(blocks, K * K)
    errs = []
    for _ in range(iters):
        r, Ji, Jj = _edge_jacobians((s[ei], R[ei], t[ei], s[ej], R[ej], t[ej],
                                     edges.meas_s, edges.meas_R, edges.meas_t))
        Ji = torch.where(node_fixed[ei][:, None, None], 0.0, Ji)
        Jj = torch.where(node_fixed[ej][:, None, None], 0.0, Jj)
        if fix_scale:
            Ji = torch.where(scale_dim, 0.0, Ji)
            Jj = torch.where(scale_dim, 0.0, Jj)
        wJi = w[:, None, None] * Ji
        wJj = w[:, None, None] * Jj
        b = scatter_sum(K, ends, torch.cat([-torch.einsum("eri,er->ei", wJi, r),
                                            -torch.einsum("eri,er->ei", wJj, r)]), by_node)
        if dense:
            Hb = scatter_sum(K * K, blocks, torch.cat([
                torch.einsum("eri,erj->eij", wJi, Ji), torch.einsum("eri,erj->eij", wJj, Jj),
                torch.einsum("eri,erj->eij", wJi, Jj), torch.einsum("eri,erj->eij", wJj, Ji)]),
                by_block)
            Hm = Hb.reshape(K, K, 7, 7).permute(0, 2, 1, 3).reshape(7 * K, 7 * K)
            pin = pin_node.repeat_interleave(7)
            if fix_scale:
                pin = pin | scale_dim.repeat(K)
            Hm = Hm + torch.diag(torch.where(pin, 1.0, lam))
            Hm = torch.where(pin[:, None] | pin[None, :], 0.0, Hm) + torch.diag(pin.to(torch.float32))
            dx = torch.linalg.solve(Hm, torch.where(pin, 0.0, b.reshape(7 * K))).reshape(K, 7)
        else:
            pin7 = pin_node[:, None].expand(K, 7)
            if fix_scale:
                pin7 = pin7 | scale_dim[None, :]

            def matvec(x):
                x = torch.where(pin7, 0.0, x)
                u = torch.einsum("erc,ec->er", Ji, x[ei]) + torch.einsum("erc,ec->er", Jj, x[ej])
                y = scatter_sum(K, ends, torch.cat([torch.einsum("erc,er->ec", wJi, u),
                                                    torch.einsum("erc,er->ec", wJj, u)]), by_node)
                return torch.where(pin7, x, y + lam * x)

            D = scatter_sum(K, ends, torch.cat([torch.einsum("eri,erj->eij", wJi, Ji),
                                                torch.einsum("eri,erj->eij", wJj, Jj)]), by_node)
            D = torch.where(pin7[:, :, None] | pin7[:, None, :], eye7, D + lam * eye7)
            Dinv = torch.linalg.inv(D)
            dx = _cg(matvec, torch.where(pin7, 0.0, b),
                     lambda x: torch.einsum("kij,kj->ki", Dinv, x),
                     cg_iters, 1e-6, stats)
            dx = torch.where(pin7, 0.0, dx)
        s, R, t = sim3_compose(*sim3_exp(dx), s, R, t)
        errs.append(torch.sum(w * torch.sum(r * r, dim=-1)))
    return s, R, t, torch.stack(errs)
