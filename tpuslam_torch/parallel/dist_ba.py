"""Distributed bundle adjustment over a mesh of devices. Port of
tpuslam/parallel/dist_ba.py.

Two decompositions, as in the JAX package:

1. **Observation-parallel** (`distributed_bundle_adjustment`): the edge
   arrays are split into one contiguous block per shard; poses and points
   are replicated. Every sum into the (K, 6, 6) pose and (P, 3, 3) point
   systems is a partial sum per shard, reduced over the shards (the JAX
   package gets these reductions from GSPMD).
2. **Point-sharded** (`point_sharded_bundle_adjustment`): the points are
   split into contiguous blocks, one per shard, and every edge goes to the
   shard that owns its point. All point-side work stays in the shard; only
   the pose-side terms (K x 6, small next to P) are reduced, at the JAX
   package's three psum sites.

Execution model: one process; the mesh is a list of torch devices (the
first n CUDA cards, or `cpu` repeated; a device may repeat, so two shards
can share one card). Each shard runs optim.ba.bundle_adjustment in its own
thread on its own device, on the stream the caller had current there, and
its `reduce` hook is a ShardReducer: the shards' partial tensors meet in a
barrier, the first shard adds them in shard order on its device, and each
shard takes a copy of the sum. Every shard therefore walks the same bits,
whatever the threads' timing. A shard that raises breaks the barrier, the
others stop at their next reduction, and the call re-raises its error.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from tpuslam_torch.geometry.camera import PinholeCamera
from tpuslam_torch.optim.ba import BAProblem, bundle_adjustment
from tpuslam_torch.optim.linalg import load_cuda_linalg


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> List[torch.device]:
    """The first n_devices devices of `device`'s type: CUDA cards (every
    visible one when n_devices is None; fewer visible than asked raises
    ValueError), or the CPU repeated n_devices times (once by default)."""
    kind = torch.device(device).type
    if kind == "cpu":
        return [torch.device("cpu")] * (n_devices or 1)
    visible = torch.cuda.device_count()
    n = visible if n_devices is None else n_devices
    if n < 1 or n > visible:
        raise ValueError(f"a mesh of {n} CUDA devices, but {visible} are visible")
    return [torch.device("cuda", i) for i in range(n)]


class ShardReducer:
    """The barrier that sums the shards' partial tensors. allreduce(shard,
    x) returns, on the shard's device, the sum of every shard's x added in
    shard order on the first shard's device. `reductions` and `bytes`
    count the reductions and the bytes of one partial tensor each (the
    payload one collective would carry)."""

    def __init__(self, mesh: Sequence):
        self.mesh = [torch.device(d) for d in mesh]
        self._barrier = threading.Barrier(len(self.mesh))
        self._parts: list = [None] * len(self.mesh)
        self._sum: Optional[torch.Tensor] = None
        self.reductions = 0
        self.bytes = 0

    def allreduce(self, shard: int, x: torch.Tensor) -> torch.Tensor:
        self._parts[shard] = x
        self._barrier.wait()  # every partial deposited
        if shard == 0:
            acc = x
            for p in self._parts[1:]:
                acc = acc + p.to(acc.device)
            self._sum = acc
            self.reductions += 1
            self.bytes += x.numel() * x.element_size()
        self._barrier.wait()  # the sum published; nobody deposits again before this
        return self._sum.to(self.mesh[shard])

    def hook(self, shard: int, sides: tuple) -> Callable[[torch.Tensor, str], torch.Tensor]:
        """bundle_adjustment's `reduce` for `shard`: the sides in `sides`
        are summed over the shards, the others returned as they are."""
        def reduce(x: torch.Tensor, side: str) -> torch.Tensor:
            return self.allreduce(shard, x) if side in sides else x
        return reduce

    def abort(self):
        self._barrier.abort()


def run_shards(mesh: Sequence, body: Callable[[int], object], reducer: ShardReducer) -> list:
    """body(shard) for every shard, each in its own thread, on its device
    and (on a card) on the stream that was current in the caller for that
    device, torch's CUDA linear algebra loaded first from the caller's
    thread. Returns the results in shard order. A shard's error aborts the
    reducer's barrier, and is re-raised once every thread has ended."""
    mesh = [torch.device(d) for d in mesh]
    for d in set(mesh):
        load_cuda_linalg(d)
    streams = [torch.cuda.current_stream(d) if d.type == "cuda" else None for d in mesh]
    out: list = [None] * len(mesh)
    errors: list = [None] * len(mesh)

    def run(s: int):
        try:
            with contextlib.ExitStack() as ctx:
                if streams[s] is not None:
                    ctx.enter_context(torch.cuda.device(mesh[s]))
                    ctx.enter_context(torch.cuda.stream(streams[s]))
                out[s] = body(s)
        except BaseException as e:  # noqa: BLE001 - re-raised in the caller
            errors[s] = e
            reducer.abort()

    threads = [threading.Thread(target=run, args=(s,), name=f"ba-shard-{s}") for s in range(len(mesh))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    first = [e for e in errors if e is not None and not isinstance(e, threading.BrokenBarrierError)]
    if first or any(e is not None for e in errors):
        raise (first or [e for e in errors if e is not None])[0]
    return out


def _fill_stats(stats: Optional[dict], reducer: ShardReducer, iters: int):
    if stats is not None:
        stats.update(reductions=reducer.reductions, bytes=reducer.bytes,
                     bytes_per_iteration=reducer.bytes / max(iters, 1))


def _pad_edges(prob: BAProblem, multiple: int) -> BAProblem:
    """Pad the edge arrays to a multiple of the shard count (padding edges
    invalid)."""
    rem = (-prob.kf.shape[0]) % multiple
    if rem == 0:
        return prob

    def pad(a: torch.Tensor, fill):
        return torch.cat([a, torch.full((rem, *a.shape[1:]), fill, dtype=a.dtype, device=a.device)])

    return prob._replace(kf=pad(prob.kf, 0), pt=pad(prob.pt, 0), uvr=pad(prob.uvr, -1.0),
                         inv_sigma2=pad(prob.inv_sigma2, 0.0), valid=pad(prob.valid, False))


def shard_ba_problem(prob: BAProblem, mesh: Sequence) -> List[BAProblem]:
    """One problem per shard on its device: a contiguous block of the
    (padded) edges, the poses and points replicated."""
    mesh = [torch.device(d) for d in mesh]
    prob = _pad_edges(prob, len(mesh))
    per = prob.kf.shape[0] // len(mesh)
    out = []
    for s, d in enumerate(mesh):
        e = slice(s * per, (s + 1) * per)
        out.append(BAProblem(
            R=prob.R.to(d), t=prob.t.to(d), X=prob.X.to(d), kf=prob.kf[e].to(d), pt=prob.pt[e].to(d),
            uvr=prob.uvr[e].to(d), inv_sigma2=prob.inv_sigma2[e].to(d), valid=prob.valid[e].to(d),
            fixed_kf=prob.fixed_kf.to(d), fixed_pt=prob.fixed_pt.to(d)))
    return out


def distributed_bundle_adjustment(cam: PinholeCamera, prob: BAProblem, mesh: Sequence, iters: int = 10,
                                  use_huber: bool = True, cg_iters: int = 40,
                                  stats: Optional[dict] = None):
    """BA with the edges split over `mesh`, poses and points replicated and
    every normal-equation sum reduced over the shards. The single-device
    solver's result up to the order of its sums. Returns (R, t, X,
    edge_chi2) on prob's device; `stats` (a dict) receives the reducer's
    counts."""
    mesh = [torch.device(d) for d in mesh]
    E = prob.kf.shape[0]
    shards = shard_ba_problem(prob, mesh)
    red = ShardReducer(mesh)
    outs = run_shards(mesh, lambda s: bundle_adjustment(
        cam, shards[s], iters=iters, use_huber=use_huber, cg_iters=cg_iters,
        reduce=red.hook(s, ("pose", "point"))), red)
    dev = prob.X.device
    R, t, X = (x.to(dev) for x in outs[0][:3])
    chi2 = torch.cat([o[3].to(dev) for o in outs])[:E]
    _fill_stats(stats, red, iters)
    return R, t, X, chi2


def route_edges_to_point_shards(prob: BAProblem, n_shards: int):
    """Reorder and pad the edges so that shard s holds exactly the edges of
    point block s (the points split into n_shards contiguous blocks),
    computed on the host as the JAX package does. Returns (routed, perm):
    routed's edge arrays are [shard 0's edges, padding, shard 1's, ...]
    with E_pad = n_shards x the largest shard's count, on prob's device;
    perm (E_pad,) int64 maps each routed position to its original edge
    (-1 for padding, whose point is its block's first and whose edge is
    invalid)."""
    Pn = prob.X.shape[0]
    if Pn % n_shards:
        raise ValueError("pad the point capacity to a multiple of the shard count")
    blk = Pn // n_shards
    pt = prob.pt.cpu().numpy()
    owner = pt // blk
    order = np.argsort(owner, kind="stable")
    counts = np.bincount(owner, minlength=n_shards)
    per = int(counts.max()) if counts.size else 0
    perm = np.full(n_shards * per, -1, np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for s in range(n_shards):
        perm[s * per:s * per + counts[s]] = order[starts[s]:starts[s] + counts[s]]
    keep = perm >= 0
    dev = prob.X.device

    def take(a: torch.Tensor, fill=0):
        a = a.cpu().numpy()
        out = np.full((len(perm),) + a.shape[1:], fill, a.dtype)
        out[keep] = a[perm[keep]]
        return torch.from_numpy(out).to(dev)

    pt_routed = np.where(keep, pt[np.maximum(perm, 0)], np.repeat(np.arange(n_shards) * blk, per))
    routed = prob._replace(kf=take(prob.kf), pt=torch.from_numpy(pt_routed.astype(np.int32)).to(dev),
                           uvr=take(prob.uvr), inv_sigma2=take(prob.inv_sigma2),
                           valid=take(prob.valid, False))
    return routed, perm


def point_sharded_bundle_adjustment(cam: PinholeCamera, prob: BAProblem, mesh: Sequence, iters: int = 10,
                                    use_huber: bool = True, cg_iters: int = 40,
                                    stats: Optional[dict] = None):
    """BA with point blocks and their edges split over `mesh`, the poses
    replicated and only the pose-side terms reduced. The single-device
    solver's stationary points. Returns (R, t, X, edge_chi2) on prob's
    device, edge_chi2 in the original edge order; `stats` (a dict)
    receives the reducer's counts."""
    mesh = [torch.device(d) for d in mesh]
    n = len(mesh)
    P0 = prob.X.shape[0]
    pad_p = (-P0) % n
    if pad_p:
        prob = prob._replace(
            X=torch.cat([prob.X, prob.X.new_zeros((pad_p, 3))]),
            fixed_pt=torch.cat([prob.fixed_pt, prob.fixed_pt.new_ones(pad_p)]))
    blk = prob.X.shape[0] // n
    routed, perm = route_edges_to_point_shards(prob, n)
    per = routed.kf.shape[0] // n

    def shard(s: int) -> BAProblem:
        d, e, p = mesh[s], slice(s * per, (s + 1) * per), slice(s * blk, (s + 1) * blk)
        return BAProblem(
            R=prob.R.to(d), t=prob.t.to(d), X=prob.X[p].to(d), kf=routed.kf[e].to(d),
            pt=(routed.pt[e] - s * blk).to(d), uvr=routed.uvr[e].to(d),
            inv_sigma2=routed.inv_sigma2[e].to(d), valid=routed.valid[e].to(d),
            fixed_kf=prob.fixed_kf.to(d), fixed_pt=prob.fixed_pt[p].to(d))

    shards = [shard(s) for s in range(n)]
    red = ShardReducer(mesh)
    outs = run_shards(mesh, lambda s: bundle_adjustment(
        cam, shards[s], iters=iters, use_huber=use_huber, cg_iters=cg_iters,
        reduce=red.hook(s, ("pose",))), red)
    dev = prob.X.device
    R, t = outs[0][0].to(dev), outs[0][1].to(dev)
    X = torch.cat([o[2].to(dev) for o in outs])[:P0]
    chi2_routed = torch.cat([o[3].to(dev) for o in outs])
    keep = np.nonzero(perm >= 0)[0]
    chi2 = chi2_routed.new_zeros(prob.kf.shape[0])
    chi2[torch.from_numpy(perm[keep]).to(dev)] = chi2_routed[torch.from_numpy(keep).to(dev)]
    _fill_stats(stats, red, iters)
    return R, t, X, chi2
