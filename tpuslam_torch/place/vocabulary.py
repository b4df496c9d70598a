"""Hierarchical binary vocabulary: the k-branch L-level tree of 256-bit
descriptors as one center table per level, descended greedily for all
descriptors at once. Port of tpuslam/place/vocabulary.py.

Centers are int32 bit patterns of the uint32 words of the JAX package's
files (the port's descriptor layout, convert.py). `train_vocabulary` is the
JAX package's numpy trainer, copied as it is.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from tpuslam_torch.matching.hamming import hamming_distance

DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "tpuslam", "data",
)
DEFAULT_VOCAB_PATH = os.path.join(DATA_DIR, "default_vocab.npz")       # k=10, L=5
DEFAULT_VOCAB_1M_PATH = os.path.join(DATA_DIR, "default_vocab_1m.npz")  # k=10, L=6


class Vocabulary(NamedTuple):
    """centers[l]: (k^(l+1), 8) int32 for level l; word_weight: (k^L,)
    float32 IDF weights. centers_valid marks the child slots that exist
    (None: a complete tree); trees converted from DBoW2's ORBvoc format
    have missing slots, and those never win the descent."""

    centers: tuple
    word_weight: torch.Tensor
    k: int
    levels: int
    centers_valid: Optional[tuple] = None

    @property
    def n_words(self) -> int:
        return self.k ** self.levels

    def save(self, path: str):
        """The JAX package's npz layout (uint32 centers)."""
        data = {f"centers_{i}": c.cpu().numpy().view(np.uint32) for i, c in enumerate(self.centers)}
        data["word_weight"] = self.word_weight.cpu().numpy()
        data["k"] = self.k
        data["levels"] = self.levels
        if self.centers_valid is not None:
            for i, v in enumerate(self.centers_valid):
                data[f"centers_valid_{i}"] = v.cpu().numpy()
        np.savez_compressed(path, **data)

    def to(self, device) -> "Vocabulary":
        return Vocabulary(tuple(c.to(device) for c in self.centers), self.word_weight.to(device),
                          self.k, self.levels,
                          None if self.centers_valid is None else tuple(v.to(device) for v in self.centers_valid))

    @staticmethod
    def load(path: str, device="cuda") -> "Vocabulary":
        return vocabulary_from_arrays(dict(np.load(path)), device)


def vocabulary_from_arrays(z: dict, device="cuda") -> Vocabulary:
    """A Vocabulary from the npz file's arrays (uint32 or int32 centers)."""
    levels = int(z["levels"])

    def words(a):
        a = np.array(a)  # a writable copy
        return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a.astype(np.int32)).to(device)

    valid = None
    if "centers_valid_0" in z:
        valid = tuple(torch.from_numpy(np.array(z[f"centers_valid_{i}"], bool)).to(device)
                      for i in range(levels))
    return Vocabulary(
        centers=tuple(words(z[f"centers_{i}"]) for i in range(levels)),
        word_weight=torch.from_numpy(np.array(z["word_weight"], np.float32)).to(device),
        k=int(z["k"]), levels=levels, centers_valid=valid)


_POP8 = np.array([bin(i).count("1") for i in range(256)], np.uint16)


def _popcount_matrix(a: np.ndarray, b: np.ndarray, chunk: int = 1 << 15) -> np.ndarray:
    """(Na, 8) x (Nb, 8) uint32 -> (Na, Nb) Hamming distances, chunked
    byte-LUT popcount (training)."""
    a = np.ascontiguousarray(a, np.uint32)
    b = np.ascontiguousarray(b, np.uint32)
    bb = b.view(np.uint8).reshape(len(b), 32)
    out = np.empty((len(a), len(b)), np.uint16)
    for s in range(0, len(a), chunk):
        x = a[s : s + chunk].view(np.uint8).reshape(-1, 1, 32) ^ bb[None]
        out[s : s + chunk] = _POP8[x].sum(axis=-1, dtype=np.uint16)
    return out


def _majority_center(desc: np.ndarray) -> np.ndarray:
    """Bitwise majority of (N, 8) uint32 descriptors (FORB::meanValue)."""
    if len(desc) == 0:
        return np.zeros(8, np.uint32)
    bits = np.unpackbits(desc.view(np.uint8), axis=-1)  # (N, 256)
    maj = (bits.sum(axis=0) * 2 >= len(desc)).astype(np.uint8)
    return np.packbits(maj).view(np.uint32)


def train_vocabulary(descriptors: np.ndarray, k: int = 10, levels: int = 4, iters: int = 8,
                     seed: int = 0, sample_cap: int = 50_000, device="cuda") -> Vocabulary:
    """A k^levels-word vocabulary by per-node k-majority clustering of (N,
    8) uint32 descriptors, with IDF word weights over the corpus: the JAX
    package's trainer, step for step (one stable argsort per level for the
    node groups, nodes over `sample_cap` clustered on a subsample, empty
    nodes inheriting their parent's center)."""
    rng = np.random.default_rng(seed)
    desc = np.asarray(descriptors, np.uint32)
    assignments = np.zeros(len(desc), np.int64)
    centers_per_level = []
    for lvl in range(levels):
        n_parents = k ** lvl
        centers = np.zeros((k ** (lvl + 1), 8), np.uint32)
        new_assign = np.zeros_like(assignments)
        order = np.argsort(assignments, kind="stable")
        bounds = np.searchsorted(assignments[order], np.arange(n_parents + 1))
        for p in range(n_parents):
            sel = order[bounds[p] : bounds[p + 1]]
            if len(sel) == 0:
                parent_center = centers_per_level[lvl - 1][p] if lvl > 0 else np.zeros(8, np.uint32)
                centers[p * k : (p + 1) * k] = parent_center
                continue
            d = desc[sel]
            dk = d
            if len(d) > sample_cap:
                dk = d[rng.choice(len(d), sample_cap, replace=False)]
            n_init = min(k, len(dk))
            picks = rng.choice(len(dk), n_init, replace=False)
            c = dk[picks].copy()
            for _ in range(iters):
                a = _popcount_matrix(dk, c).argmin(axis=1)
                newc = np.stack([_majority_center(dk[a == j]) if np.any(a == j) else c[j]
                                 for j in range(n_init)])
                if np.array_equal(newc, c):
                    break
                c = newc
            full = np.zeros((k, 8), np.uint32)
            full[:n_init] = c
            if n_init < k:
                full[n_init:] = c[0]
            centers[p * k : (p + 1) * k] = full
            new_assign[sel] = p * k + _popcount_matrix(d, full).argmin(axis=1)
        centers_per_level.append(centers)
        assignments = new_assign

    W = k ** levels
    counts = np.bincount(assignments, minlength=W).astype(np.float64)
    idf = np.log(len(desc) / np.maximum(counts, 1.0))
    idf[counts == 0] = 0.0
    return Vocabulary(
        centers=tuple(torch.from_numpy(c.view(np.int32)).to(device) for c in centers_per_level),
        word_weight=torch.from_numpy(idf.astype(np.float32)).to(device), k=k, levels=levels)


def transform_words(voc: Vocabulary, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Descriptors (N, 8) -> word ids (N,) int32, -1 for invalid rows: the
    greedy nearest-child descent, one gathered Hamming reduction (exact
    SWAR popcount) over each descriptor's k children per level; ties go to
    the lowest child, as jnp.argmin."""
    n = desc.shape[0]
    dev = desc.device
    node = torch.zeros((n,), dtype=torch.int64, device=dev)
    ar = torch.arange(voc.k, device=dev)
    for lvl in range(voc.levels):
        child_ids = node[:, None] * voc.k + ar[None, :]  # (N, k)
        d = hamming_distance(voc.centers[lvl][child_ids], desc[:, None, :])
        if voc.centers_valid is not None:
            d = torch.where(voc.centers_valid[lvl][child_ids], d, 1 << 14)
        node = torch.gather(child_ids, 1, torch.argmin(d, dim=1, keepdim=True))[:, 0]
    return torch.where(valid, node, -1).to(torch.int32)


def bow_vector(voc: Vocabulary, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Dense L1-normalized TF-IDF BoW vector (W,) of one descriptor set."""
    words = transform_words(voc, desc, valid)
    W = voc.n_words
    safe = torch.where(words >= 0, words, W).long()
    # Counts of ones: exact in any order of addition.
    v = torch.zeros((W + 1,), device=desc.device).index_add(0, safe, valid.to(torch.float32))[:W]
    v = v * voc.word_weight
    return v / torch.clamp(torch.sum(torch.abs(v)), min=1e-9)


def sparse_bow_vector(voc: Vocabulary, desc: torch.Tensor, valid: torch.Tensor):
    """Sparse L1-normalized TF-IDF BoW: SparseBow(words (N,), weight (N,))
    with -1 / 0 padding, N the keypoint capacity. The distinct words come
    from a sort and its boundaries, the term frequencies from counting each
    run; no dynamic shape and no host read."""
    from tpuslam_torch.place.database import SparseBow

    N = desc.shape[0]
    dev = desc.device
    words = transform_words(voc, desc, valid)
    BIG = 1 << 30
    ws = torch.sort(torch.where(valid & (words >= 0), words, BIG)).values
    live = ws < BIG
    first = torch.cat([live[:1], live[1:] & (ws[1:] != ws[:-1])])
    gid = torch.cumsum(first.to(torch.int32), 0) - 1
    gid = torch.where(live, gid, N).long()
    tf = torch.zeros((N + 1,), device=dev).index_add(0, gid, torch.ones((N,), device=dev))[:N]
    # Every write to a slot carries the same word: any order gives one result.
    uw = torch.full((N + 1,), -1, dtype=torch.int32, device=dev).scatter(0, gid, ws)[:N]
    weight = tf * voc.word_weight[torch.clamp(uw, min=0).long()] * (uw >= 0)
    weight = weight / torch.clamp(torch.sum(weight), min=1e-9)
    return SparseBow(words=uw, weight=weight)
