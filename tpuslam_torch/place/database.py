"""Keyframe BoW database: loop and relocalization candidates from one
masked reduction over all keyframes. Port of tpuslam/place/database.py.

`KeyFrameDatabase` holds dense (K, W) vectors (small vocabularies);
`SparseKeyFrameDatabase` holds per-keyframe word lists (K, L), exact at
O(K L) memory whatever W is (a 1M-word tree). Both give the reference's
candidate logic: the 0.8 x max shared-word filter, the min-score gate, the
covisibility-group accumulation and the 0.75 x best retention.
"""

from __future__ import annotations

import copy
import threading
from typing import NamedTuple

import torch

# Held while a database swaps in its tables or a reader copies them out
# (one lock for all databases: the swaps are a few assignments).
_SWAP = threading.Lock()


def l1_score(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """DBoW2's L1 similarity of L1-normalized vectors: sum min(v, w)."""
    return torch.sum(torch.minimum(v, w), dim=-1)


def _candidates_from_scores(eligible, common, scores, covis_weights, min_score, max_candidates):
    """Word filter -> min-score gate -> covisibility-group accumulation ->
    0.75 retention, over per-keyframe raw scores. min_score may be a
    float or a 0-d tensor. Returns (idx (max_candidates,), ok): the best
    first, ties by slot (a stable sort, as jnp.argsort)."""
    common = torch.where(eligible, common, 0)
    word_ok = common > 0.8 * common.max()
    scores = torch.where(eligible & word_ok & (scores >= min_score), scores, 0.0)
    covis = (covis_weights > 0).to(torch.float32)
    group = covis * (scores > 0)[None, :]
    acc = scores + torch.sum(group * scores[None, :], dim=-1)
    acc = torch.where(scores > 0, acc, 0.0)
    keep = acc > 0.75 * acc.max()
    final = torch.where(keep, scores, 0.0)
    idx = torch.argsort(-final, stable=True)[:max_candidates]
    return idx, final[idx] > 0.0


class KeyFrameDatabase:
    """Dense BoW store aligned with the map's keyframe slots."""

    def __init__(self, n_words: int, max_keyframes: int, device="cuda"):
        self.bow = torch.zeros((max_keyframes, n_words), device=device)
        self.has = torch.zeros((max_keyframes,), dtype=torch.bool, device=device)

    def add(self, kf_idx: int, bow_vec: torch.Tensor):
        self.bow[kf_idx] = bow_vec
        self.has[kf_idx].fill_(True)  # no host->device copy: no sync

    def erase(self, kf_idx: int):
        self.has[kf_idx].fill_(False)

    def query(self, bow_vec, exclude, covis_weights, min_score, max_candidates: int = 8):
        """Candidates for a query vector. exclude (K,) bool, covis_weights
        (K, K). Returns (cand_idx, cand_ok), each (max_candidates,)."""
        common = torch.sum((self.bow > 0) & (bow_vec > 0)[None, :], dim=-1)
        scores = l1_score(self.bow, bow_vec[None, :])
        return _candidates_from_scores(self.has & ~exclude, common, scores, covis_weights,
                                       min_score, max_candidates)


class SparseBow(NamedTuple):
    """L1-normalized TF-IDF BoW in sparse form: word ids (-1 padding) and
    their weights (0 padding), from vocabulary.sparse_bow_vector."""

    words: torch.Tensor   # (L,) int32
    weight: torch.Tensor  # (L,) float32

    def densify(self, n_words: int) -> torch.Tensor:
        """Scatter into a dense (W,) vector (word ids are unique)."""
        tgt = torch.where(self.words >= 0, self.words, n_words).long()
        out = torch.zeros((n_words + 1,), dtype=self.weight.dtype, device=self.weight.device)
        return out.scatter(0, tgt, self.weight)[:n_words]


def l1_score_sparse(a: SparseBow, b_dense: torch.Tensor) -> torch.Tensor:
    """L1 similarity of a sparse vector against a dense one: min(v, w) is
    nonzero only on a's support. a and b_dense may carry leading batch
    dims, which broadcast."""
    idx = torch.clamp(a.words, min=0).long()
    lead = torch.broadcast_shapes(idx.shape[:-1], b_dense.shape[:-1])
    bw = torch.gather(b_dense.expand(*lead, b_dense.shape[-1]), -1, idx.expand(*lead, idx.shape[-1]))
    return torch.sum(torch.minimum(a.weight, bw * (a.words >= 0)), dim=-1)


class SparseKeyFrameDatabase:
    """Word-list BoW store aligned with the map's keyframe slots; the exact
    equivalent of KeyFrameDatabase at O(K L) memory.

    A background mapping thread adds rows while the tracking thread queries
    for relocalization, so the tables are never written in place: add and
    erase swap in new tensors together, and `snapshot` gives a reader the
    tables of one moment."""

    def __init__(self, n_words: int, max_keyframes: int, words_per_kf: int, device="cuda"):
        self.n_words = n_words
        self.words = torch.full((max_keyframes, words_per_kf), -1, dtype=torch.int32, device=device)
        self.weight = torch.zeros((max_keyframes, words_per_kf), device=device)
        self.has = torch.zeros((max_keyframes,), dtype=torch.bool, device=device)

    def add(self, kf_idx: int, bow: SparseBow):
        assert bow.words.shape[0] == self.words.shape[1], "SparseBow capacity mismatch"
        words, weight, has = self.words.clone(), self.weight.clone(), self.has.clone()
        words[kf_idx] = bow.words
        weight[kf_idx] = bow.weight
        has[kf_idx].fill_(True)  # no host->device copy: no sync
        with _SWAP:
            self.words, self.weight, self.has = words, weight, has

    def erase(self, kf_idx: int):
        has = self.has.clone()
        has[kf_idx].fill_(False)
        with _SWAP:
            self.has = has

    def snapshot(self) -> "SparseKeyFrameDatabase":
        """A copy sharing this moment's tables (none is written again)."""
        with _SWAP:
            return copy.copy(self)

    def query(self, bow: SparseBow, exclude, covis_weights, min_score, max_candidates: int = 8):
        """KeyFrameDatabase.query's candidates, from one dense scatter of the
        query and a (K, L) gather."""
        q = bow.densify(self.n_words)
        kw = q[torch.clamp(self.words, min=0).long()] * (self.words >= 0)
        common = torch.sum((self.weight > 0) & (kw > 0), dim=-1)
        scores = torch.sum(torch.minimum(self.weight, kw), dim=-1)
        return _candidates_from_scores(self.has & ~exclude, common, scores, covis_weights,
                                       min_score, max_candidates)
