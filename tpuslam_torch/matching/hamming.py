"""256-bit binary descriptor Hamming distance. Port of
tpuslam/matching/hamming.py.

Descriptors are (..., 8) int32 bit patterns of the uint32 words. torch has
no popcount: a pair's distance widens each word to int64 (no sign, no
overflow) and counts it with the SWAR bit trick; the all-pairs matrix is a
product of 0/1 bit planes.
"""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of non-negative int64 values below 2^32."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _words(d: torch.Tensor) -> torch.Tensor:
    return d.to(torch.int64) & _MASK32


def hamming_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise Hamming distance between (..., 8) descriptors -> int32."""
    return _popcount32(_words(a) ^ _words(b)).sum(dim=-1).to(torch.int32)


def _bit_planes(d: torch.Tensor) -> torch.Tensor:
    """(..., 8) descriptor words -> (..., 256) float32 bits (0 or 1)."""
    shifts = torch.arange(32, dtype=torch.int32, device=d.device)
    return ((d[..., :, None] >> shifts) & 1).reshape(*d.shape[:-1], -1).to(torch.float32)


def hamming_matrix(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """All-pairs distances: q (..., Nq, 8) x c (..., Nc, 8) -> (..., Nq, Nc)
    int32, from the bit planes: |a xor b| = |a| + |b| - 2 a.b, one matrix
    product. Exact: the products are 0 or 1 (exact in TF32 and bf16 too)
    and the float32 sums stay below 2^24."""
    qb, cb = _bit_planes(q), _bit_planes(c)
    dot = qb @ cb.transpose(-1, -2)
    return (qb.sum(-1)[..., :, None] + cb.sum(-1)[..., None, :] - 2.0 * dot).to(torch.int32)
