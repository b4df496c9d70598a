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
it has converged, which leaves dx as it is. The JAX package runs the CG
(a lax.while_loop inside the GN scan) as one program. Here a block of
CG_CHECK_EVERY masked iterations is one segment (`_cg_block`), run
through `run`: by default a StepGraphs of the call's own, which on a card
captures the block once per (K, E) and replays it between the reads, and
is released when the call returns. The GN step's setup (the Jacobians,
the preconditioner's blocks and their inverse) stays eager, once per GN
step. scatter_sum's segment_reduce captures without a host sync (on the
card, torch 2.11).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tpuslam_torch.geometry.sim3 import sim3_compose, sim3_exp, sim3_inverse, sim3_log
from tpuslam_torch.pipeline._index import SumPlan, scatter_sum, sum_plan
from tpuslam_torch.pipeline.graphs import StepGraphs

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


class _CGSystem(NamedTuple):
    """H x (the edge Jacobians, their weighted forms, the edges' ends and
    the sum plan over them, the pinned coordinates) and the
    preconditioner's inverse blocks: the CG's inputs of one GN step."""

    Ji: torch.Tensor     # (E, 7, 7)
    Jj: torch.Tensor
    wJi: torch.Tensor
    wJj: torch.Tensor
    ei: torch.Tensor     # (E,) int64
    ej: torch.Tensor
    ends: torch.Tensor   # (2E,) int64: ei then ej
    plan: SumPlan        # sum_plan(ends, K)
    pin7: torch.Tensor   # (K, 7) bool
    Dinv: torch.Tensor   # (K, 7, 7)


def _matvec(op: _CGSystem, x, lam: float):
    K = op.pin7.shape[0]
    x = torch.where(op.pin7, 0.0, x)
    u = torch.einsum("erc,ec->er", op.Ji, x[op.ei]) + torch.einsum("erc,ec->er", op.Jj, x[op.ej])
    y = scatter_sum(K, op.ends, torch.cat([torch.einsum("erc,er->ec", op.wJi, u),
                                            torch.einsum("erc,er->ec", op.wJj, u)]), op.plan)
    return torch.where(op.pin7, x, y + lam * x)


def _precond(op: _CGSystem, x):
    return torch.einsum("kij,kj->ki", op.Dinv, x)


def _cg_block(op: _CGSystem, x, r, p, gamma, n_active, atol2, *, n: int, lam: float):
    """n iterations of the masked CG loop from its state (x, r, p, gamma,
    the count of active iterations): a segment. Returns the new state and
    whether the next iteration is active (the convergence read's value)."""
    for _ in range(n):
        active = _vdot(r, r) > atol2
        Ap = _matvec(op, p, lam)
        alpha = gamma / _vdot(p, Ap)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        z_new = _precond(op, r_new)
        gamma_new = _vdot(r_new, z_new)
        p_new = z_new + (gamma_new / gamma) * p
        x = torch.where(active, x_new, x)
        r = torch.where(active, r_new, r)
        p = torch.where(active, p_new, p)
        gamma = torch.where(active, gamma_new, gamma)
        n_active = n_active + active.to(torch.int32)
    return x, r, p, gamma, n_active, _vdot(r, r) > atol2


def _cg(op: _CGSystem, b, lam: float, maxiter: int, tol: float, stats: dict, run):
    """jax.scipy.sparse.linalg.cg's preconditioned CG, as a masked loop:
    blocks of CG_CHECK_EVERY iterations through `run`, the convergence read
    between them."""
    atol2 = tol * tol * _vdot(b, b)
    x = torch.zeros_like(b)
    r = b - _matvec(op, x, lam)
    p = _precond(op, r)
    gamma = _vdot(r, p)
    n_active = torch.zeros((), dtype=torch.int32, device=b.device)
    done = 0
    while done < maxiter:
        n = min(CG_CHECK_EVERY, maxiter - done)
        x, r, p, gamma, n_active, active = run(
            "cg", _cg_block, dict(n=n, lam=lam), op=op, x=x, r=r, p=p, gamma=gamma,
            n_active=n_active, atol2=atol2)
        done += n
        if done < maxiter:
            stats["reads"] = stats.get("reads", 0) + 1
            if not bool(active):
                break
    stats.setdefault("cg_iters", []).append(n_active)
    return x


def optimize_pose_graph(s, R, t, node_valid, node_fixed, edges: Sim3Edges, iters: int = 20,
                        fix_scale: bool = False, lam: float = 1e-6, dense_max_nodes: int = 192,
                        cg_iters: int = 150, stats: Optional[dict] = None, run=None):
    """Optimize node Sim3 poses S_iw. node_fixed pins poses (the loop
    keyframe); with fix_scale the scale dimension is projected out. Returns
    (s, R, t, errs (iters,)): errs[k] is the weighted squared residual
    before step k. `stats`, when given, collects each GN step's count of
    CG iterations (device tensors), the CG's device->host reads, and the
    CG's graph captures, replays and capture records. `run` runs the CG's
    blocks (pipeline/graphs.py's call_segment runs them eagerly); None
    gives the call a StepGraphs of its own, released at its return."""
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
    graphs = StepGraphs(dev) if run is None and not dense else None
    if graphs is not None:
        run = graphs.run
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
            D = scatter_sum(K, ends, torch.cat([torch.einsum("eri,erj->eij", wJi, Ji),
                                                torch.einsum("eri,erj->eij", wJj, Jj)]), by_node)
            D = torch.where(pin7[:, :, None] | pin7[:, None, :], eye7, D + lam * eye7)
            op = _CGSystem(Ji, Jj, wJi, wJj, ei, ej, ends, by_node, pin7, torch.linalg.inv(D))
            dx = _cg(op, torch.where(pin7, 0.0, b), lam, cg_iters, 1e-6, stats, run)
            dx = torch.where(pin7, 0.0, dx)
        s, R, t = sim3_compose(*sim3_exp(dx), s, R, t)
        errs.append(torch.sum(w * torch.sum(r * r, dim=-1)))
    if graphs is not None and graphs.captures:
        stats["cg_graph"] = dict(captures=graphs.captures, replays=graphs.replays,
                                 captured=graphs.captured, pool_bytes=graphs.pool_bytes())
    return s, R, t, torch.stack(errs)
