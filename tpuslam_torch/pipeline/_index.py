"""Index helpers that reproduce the JAX package's scatter and nonzero rules.

- `.at[idx].set(src)` with repeated indices: XLA:CPU applies the updates in
  order, so the last write wins. `index_put_` with repeated indices is not
  deterministic on the card, so `scatter_last` writes the rule out.
- `.at[idx].set(src)` with an index one past the end: JAX drops the write,
  torch raises. `scatter_last_dropping` scatters into a buffer one slot
  longer and slices that slot off.
- `jnp.nonzero(mask, size=L, fill_value=f)`: `nonzero_static` builds the
  same fixed-size list from a stable argsort, with no device->host sync.
- `.at[idx].add(src)` with float values: `index_add_` on the card adds with
  atomics, in an order that changes from run to run, so the sums (and every
  decision taken on them) do not repeat. `scatter_sum` adds each target's
  values in a fixed order, the order of idx, on the CPU and the card alike.

Every helper indexes the dim just after idx's leading dims: dst is
(..., N) or (..., N, C) and idx (..., Nq), with the same leading dims.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


def scatter_last(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """dst[..., idx[..., q]] = src[..., q] for q in order: where an index
    repeats, the last write wins. Returns a new tensor."""
    idx = idx.long()
    d = idx.dim() - 1
    q = torch.arange(idx.shape[-1], device=idx.device).expand(idx.shape)
    last = torch.full(dst.shape[: d + 1], -1, dtype=torch.int64, device=idx.device)
    last = last.scatter_reduce(d, idx, q, reduce="amax")
    pick = last.clamp(min=0)
    if dst.dim() == idx.dim() + 1:
        val = torch.gather(src, d, pick[..., None].expand(*pick.shape, src.shape[-1]))
        return torch.where((last >= 0)[..., None], val, dst)
    return torch.where(last >= 0, torch.gather(src, d, pick), dst)


def scatter_last_dropping(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """scatter_last where idx may equal N = dst.shape[d]: those writes are
    dropped, as JAX drops an out-of-bounds scatter."""
    d = idx.dim() - 1
    pad = torch.zeros_like(dst.narrow(d, 0, 1))
    out = scatter_last(torch.cat([dst, pad], dim=d), idx, src)
    return out.narrow(d, 0, dst.shape[d])


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., N) or (..., N, C) at idx (..., M) -> (..., M) or (..., M, C)."""
    idx = idx.long()
    d = idx.dim() - 1
    if x.dim() == idx.dim():
        return torch.gather(x, d, idx)
    return torch.gather(x, d, idx[..., None].expand(*idx.shape, x.shape[-1]))


def nonzero_static(mask: torch.Tensor, size: int, fill_value: int) -> torch.Tensor:
    """jnp.nonzero(mask, size=size, fill_value=fill_value)[0] for a 1-D
    mask: the first `size` true positions in ascending order, padded with
    fill_value, as int64. Sync-free: a stable argsort puts the true
    positions first in index order."""
    n = mask.shape[0]
    order = torch.argsort((~mask).to(torch.int8), stable=True)
    if size > n:
        order = torch.cat([order, order.new_zeros(size - n)])
    order = order[:size]
    count = mask.sum()
    pos = torch.arange(size, device=mask.device)
    return torch.where(pos < count, order, torch.full_like(order, fill_value))


def sf_pow(sf: float, lvl: torch.Tensor) -> torch.Tensor:
    """float32(sf) ** level, as the JAX package's weakly typed power."""
    return torch.full_like(lvl, sf, dtype=torch.float32).pow(lvl.to(torch.float32))


class SumPlan(NamedTuple):
    """The sort of a scatter-sum's indices: perm puts the values in target
    order (stable, so each target keeps idx's order) and offsets[i] is
    where target i's run starts. Indices outside [0, n) fall outside every
    run and are dropped, as JAX drops an out-of-bounds scatter."""

    perm: torch.Tensor     # (E,) int64
    offsets: torch.Tensor  # (n + 1,) int64


def sum_plan(idx: torch.Tensor, n: int) -> SumPlan:
    idx = idx.long()
    perm = torch.argsort(idx, stable=True)
    bounds = torch.arange(n + 1, device=idx.device)
    return SumPlan(perm, torch.searchsorted(idx[perm], bounds))


def scatter_sum(n: int, idx: torch.Tensor, src: torch.Tensor,
                plan: Optional[SumPlan] = None) -> torch.Tensor:
    """zeros((n, ...)).at[idx].add(src), with each target's values added in
    idx's order, one after the other: deterministic on the card, and equal
    to index_add_ on the CPU. A plan (sum_plan(idx, n)) is reused by the
    solvers whose indices stay fixed across iterations."""
    if plan is None:
        plan = sum_plan(idx, n)
    return torch.segment_reduce(src[plan.perm], "sum", offsets=plan.offsets, axis=0,
                                unsafe=True, initial=0)


def edge_bucket(n: int, least: int = 4096) -> int:
    """The padded length of a list of n edges: the next power of two, at
    least `least`. A solver padded to it is captured once per bucket."""
    return max(least, 1 << max(n - 1, 0).bit_length())
