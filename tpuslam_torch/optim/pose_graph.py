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
it has converged, which leaves dx as it is. The JAX package runs each GN
step (a `lax.scan` body, its CG a lax.while_loop) as one program. Here a
GN step is pure segments run through `run`: `gn_setup` (the Jacobians,
b, the preconditioner's blocks and their inverse, the CG's first state),
the CG in blocks of CG_CHECK_EVERY masked iterations (`_cg_block`) with
the reads between them, then `gn_update`; a dense step is one segment,
`gn_dense_step`, its solve `torch.linalg.solve_ex` (the same LAPACK call
as `torch.linalg.solve` on the CPU, with no host check of its status, so
a card captures it). By default `run` is a StepGraphs of the call's own,
which on a card captures each segment once per (K, E) and replays it,
released when the call returns. scatter_sum's segment_reduce captures
without a host sync (on the card, torch 2.11).

Every solve pads its edges to pipeline/_index.py's edge_bucket (at
least MIN_EDGES; `pad_edges`) with edges whose ends are parked at K, so a
card replays one graph per (K, bucket): their gathers are clamped, their
residuals and Jacobians set to 0 by torch.where, every scatter_sum drops
them, and the error history sums per node first. A caller's own padding
is the same: edges padded to a larger bucket give the same bits on the
CPU. (Padding is not free of rounding in general: the CPU's vectorized
sin, cos, exp and log differ in the last bit from their scalar forms,
which the elements past the last full vector of an odd length take; at a
bucket length every element takes the vector form.)
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tpuslam_torch.geometry.sim3 import sim3_compose, sim3_exp, sim3_inverse, sim3_log
from tpuslam_torch.pipeline._index import SumPlan, edge_bucket, scatter_sum, sum_plan
from tpuslam_torch.pipeline.graphs import StepGraphs

CG_CHECK_EVERY = 10  # CG iterations between the convergence reads
MIN_EDGES = 256  # the smallest edge bucket (an essential graph has hundreds of edges)


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
    ei: torch.Tensor     # (E,) int64, clamped to K - 1 (for the gathers)
    ej: torch.Tensor
    ends: torch.Tensor   # (2E,) int64: the ends i then j, unclamped
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


def _cg(op: _CGSystem, state, lam: float, maxiter: int, stats: dict, run):
    """jax.scipy.sparse.linalg.cg's preconditioned CG from its first state
    (x, r, p, gamma, the count of active iterations, atol^2), as a masked
    loop: blocks of CG_CHECK_EVERY iterations through `run`, the
    convergence read between them."""
    x, r, p, gamma, n_active, atol2 = state
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


class _GNPlans(NamedTuple):
    """A solve's scatter-sum plans, fixed across its GN steps: over the
    edges' ends (ei then ej, K targets) and, dense, over the (K, K) blocks."""

    by_node: SumPlan
    by_block: Optional[SumPlan]


def pad_edges(edges: Sim3Edges, K: int, size: int) -> Sim3Edges:
    """edges padded to `size` edges with edges parked out of range (i = j =
    K) that measure the identity, invalid and of weight 0."""
    n = size - edges.i.shape[0]
    dev = edges.i.device

    def p(a, fill):
        return torch.cat([a, torch.full((n, *a.shape[1:]), fill, dtype=a.dtype, device=dev)])

    return Sim3Edges(i=p(edges.i, K), j=p(edges.j, K), meas_s=p(edges.meas_s, 1.0),
                     meas_R=torch.cat([edges.meas_R, torch.eye(3, device=dev).expand(n, 3, 3)]),
                     meas_t=p(edges.meas_t, 0.0), valid=p(edges.valid, False), weight=p(edges.weight, 0.0))


def _gn_terms(s, R, t, edges: Sim3Edges, by_node: SumPlan, node_fixed, *, fix_scale: bool):
    """A GN step's edge terms at the current poses: (ends, clamped ends,
    Ji, Jj, wJi, wJj, b, the weighted squared error). An edge parked out
    of range gathers node K-1 and has r = J = 0."""
    K = s.shape[0]
    dev = s.device
    ei, ej = edges.i.long(), edges.j.long()
    live = (ei < K)[:, None]
    eic, ejc = ei.clamp(max=K - 1), ej.clamp(max=K - 1)
    w = edges.valid.to(torch.float32) * edges.weight
    scale_dim = torch.arange(7, device=dev) == 6
    r, Ji, Jj = _edge_jacobians((s[eic], R[eic], t[eic], s[ejc], R[ejc], t[ejc],
                                 edges.meas_s, edges.meas_R, edges.meas_t))
    r = torch.where(live, r, 0.0)
    Ji = torch.where((node_fixed[eic][:, None] | ~live)[..., None], 0.0, Ji)
    Jj = torch.where((node_fixed[ejc][:, None] | ~live)[..., None], 0.0, Jj)
    if fix_scale:
        Ji = torch.where(scale_dim, 0.0, Ji)
        Jj = torch.where(scale_dim, 0.0, Jj)
    wJi = w[:, None, None] * Ji
    wJj = w[:, None, None] * Jj
    ends = torch.cat([ei, ej])
    b = scatter_sum(K, ends, torch.cat([-torch.einsum("eri,er->ei", wJi, r),
                                        -torch.einsum("eri,er->ei", wJj, r)]), by_node)
    e2 = w * torch.sum(r * r, dim=-1)
    err = scatter_sum(K, ends, torch.cat([e2, torch.zeros_like(e2)]), by_node).sum()
    return ends, eic, ejc, Ji, Jj, wJi, wJj, b, err


def _pin7(pin_node, fix_scale: bool):
    pin7 = pin_node[:, None].expand(pin_node.shape[0], 7)
    if fix_scale:
        pin7 = pin7 | (torch.arange(7, device=pin_node.device) == 6)[None, :]
    return pin7


def gn_setup(s, R, t, edges: Sim3Edges, plans: _GNPlans, node_fixed, pin_node, *, fix_scale: bool,
             lam: float):
    """The CG branch's GN step up to the CG: the Jacobians, b, the
    preconditioner's blocks D + lam I and their inverse (inv_ex: no host
    check), and the CG's first state. A segment: returns (the CG's system,
    its first state (x, r, p, gamma, n_active, atol^2), the pinned
    coordinates, the error before the step)."""
    K = s.shape[0]
    eye7 = torch.eye(7, device=s.device)
    ends, eic, ejc, Ji, Jj, wJi, wJj, b, err = _gn_terms(s, R, t, edges, plans.by_node, node_fixed,
                                                       fix_scale=fix_scale)
    pin7 = _pin7(pin_node, fix_scale)
    D = scatter_sum(K, ends, torch.cat([torch.einsum("eri,erj->eij", wJi, Ji),
                                        torch.einsum("eri,erj->eij", wJj, Jj)]), plans.by_node)
    D = torch.where(pin7[:, :, None] | pin7[:, None, :], eye7, D + lam * eye7)
    op = _CGSystem(Ji, Jj, wJi, wJj, eic, ejc, ends, plans.by_node, pin7, torch.linalg.inv_ex(D)[0])
    bK = torch.where(pin7, 0.0, b)
    atol2 = 1e-6 * 1e-6 * _vdot(bK, bK)
    x = torch.zeros_like(bK)
    r0 = bK - _matvec(op, x, lam)
    p = _precond(op, r0)
    gamma = _vdot(r0, p)
    n_active = torch.zeros((), dtype=torch.int32, device=s.device)
    return op, (x, r0, p, gamma, n_active, atol2), pin7, err


def gn_update(s, R, t, dx, pin7):
    """The GN step's update: dx with the pinned coordinates zeroed, then
    S <- exp(dx) S. A segment."""
    return sim3_compose(*sim3_exp(torch.where(pin7, 0.0, dx)), s, R, t)


def gn_dense_step(s, R, t, edges: Sim3Edges, plans: _GNPlans, node_fixed, pin_node, *, fix_scale: bool,
                  lam: float):
    """One GN step over the dense (7K)^2 system, a segment: the blocks
    scatter-summed into H, pinned rows and columns replaced by the
    identity, solved by solve_ex, then S <- exp(dx) S. Returns (s, R, t,
    the error before the step)."""
    K = s.shape[0]
    _, _, _, Ji, Jj, wJi, wJj, b, err = _gn_terms(s, R, t, edges, plans.by_node, node_fixed,
                                                  fix_scale=fix_scale)
    ei, ej = edges.i.long(), edges.j.long()
    blocks = torch.cat([ei * K + ei, ej * K + ej, ei * K + ej, ej * K + ei])
    Hb = scatter_sum(K * K, blocks, torch.cat([
        torch.einsum("eri,erj->eij", wJi, Ji), torch.einsum("eri,erj->eij", wJj, Jj),
        torch.einsum("eri,erj->eij", wJi, Jj), torch.einsum("eri,erj->eij", wJj, Ji)]), plans.by_block)
    Hm = Hb.reshape(K, K, 7, 7).permute(0, 2, 1, 3).reshape(7 * K, 7 * K)
    pin = _pin7(pin_node, fix_scale).reshape(7 * K)
    Hm = Hm + torch.diag(torch.where(pin, 1.0, lam))
    Hm = torch.where(pin[:, None] | pin[None, :], 0.0, Hm) + torch.diag(pin.to(torch.float32))
    dx = torch.linalg.solve_ex(Hm, torch.where(pin, 0.0, b.reshape(7 * K)))[0].reshape(K, 7)
    return (*sim3_compose(*sim3_exp(dx), s, R, t), err)


def optimize_pose_graph(s, R, t, node_valid, node_fixed, edges: Sim3Edges, iters: int = 20,
                        fix_scale: bool = False, lam: float = 1e-6, dense_max_nodes: int = 192,
                        cg_iters: int = 150, stats: Optional[dict] = None, run=None):
    """Optimize node Sim3 poses S_iw. node_fixed pins poses (the loop
    keyframe); with fix_scale the scale dimension is projected out. The
    edges are padded to edge_bucket(E, MIN_EDGES); edges whose ends are K
    (pad_edges) are padding. Returns (s, R, t, errs
    (iters,)): errs[k] is the weighted squared residual before step k.
    `stats`, when given, collects each GN step's count of CG iterations
    (device tensors), the CG's device->host reads, and, with a StepGraphs
    of the call's own, its graph captures, replays and capture records.
    `run` runs the GN step's segments (pipeline/graphs.py's call_segment
    runs them eagerly); None gives the call a StepGraphs of its own,
    released at its return."""
    K = s.shape[0]
    stats = {} if stats is None else stats
    size = edge_bucket(edges.i.shape[0], MIN_EDGES)
    if size > edges.i.shape[0]:
        edges = pad_edges(edges, K, size)
    ei, ej = edges.i.long(), edges.j.long()
    pin_node = node_fixed | ~node_valid
    dense = K <= dense_max_nodes
    plans = _GNPlans(sum_plan(torch.cat([ei, ej]), K),
                     sum_plan(torch.cat([ei * K + ei, ej * K + ej, ei * K + ej, ej * K + ei]), K * K)
                     if dense else None)
    graphs = StepGraphs(s.device) if run is None else None
    if graphs is not None:
        run = graphs.run
    static = dict(fix_scale=fix_scale, lam=lam)
    inputs = dict(edges=edges, plans=plans, node_fixed=node_fixed, pin_node=pin_node)
    errs = []
    for _ in range(iters):
        if dense:
            s, R, t, err = run("pg_dense", gn_dense_step, static, s=s, R=R, t=t, **inputs)
        else:
            op, state, pin7, err = run("pg_setup", gn_setup, static, s=s, R=R, t=t, **inputs)
            dx = _cg(op, state, lam, cg_iters, stats, run)
            s, R, t = run("pg_update", gn_update, {}, s=s, R=R, t=t, dx=dx, pin7=pin7)
        errs.append(err)
    if graphs is not None and graphs.captures:
        stats["cg_graph"] = dict(captures=graphs.captures, replays=graphs.replays,
                                 captured=graphs.captured, pool_bytes=graphs.pool_bytes())
    return s, R, t, torch.stack(errs)
