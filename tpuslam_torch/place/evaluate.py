"""Place-recognition quality of a vocabulary: the port's own copy of what
tools/eval_place_recognition.py measures.

Protocol: enrol view A of each held-out place (tpuslam/data/place_eval.npz)
in a SparseKeyFrameDatabase, query view B of every place through the full
candidate logic (no exclusion, no covisibility, min score 0, 5 candidates),
and report recall@1, recall@5 and the mean margin between the true place's
L1 score and the best wrong one among the first 3 candidates (0 if none).
"""

from __future__ import annotations

import numpy as np
import torch

from tpuslam_torch.place.database import SparseBow, SparseKeyFrameDatabase, l1_score_sparse
from tpuslam_torch.place.vocabulary import DATA_DIR, Vocabulary, sparse_bow_vector

PLACE_EVAL_PATH = f"{DATA_DIR}/place_eval.npz"


def evaluate(voc: Vocabulary, eval_path: str = PLACE_EVAL_PATH, max_places=None) -> dict:
    """Recall and margin on the vocabulary's device; one device->host read
    per query."""
    dev = voc.word_weight.device
    z = np.load(eval_path)
    va, vb, ca, cb = z["view_a"], z["view_b"], z["count_a"], z["count_b"]
    n = len(va) if max_places is None else min(max_places, len(va))
    F = va.shape[1]
    W = voc.n_words
    ar = torch.arange(F, device=dev)

    def bow(desc, count) -> SparseBow:
        d = torch.from_numpy(np.ascontiguousarray(desc).view(np.int32)).to(dev)
        return sparse_bow_vector(voc, d, ar < int(count))

    db = SparseKeyFrameDatabase(W, n, F, device=dev)
    for i in range(n):
        db.add(i, bow(va[i], ca[i]))
    covis = torch.zeros((n, n), device=dev)
    exclude = torch.zeros((n,), dtype=torch.bool, device=dev)
    hits1 = hits5 = 0
    margins = []
    for i in range(n):
        q = bow(vb[i], cb[i])
        idx, ok = db.query(q, exclude, covis, min_score=0.0, max_candidates=5)
        # Scores of the true place and the first 3 candidates, each the
        # query's words against that keyframe's densified vector.
        rows = torch.cat([torch.tensor([i], device=dev), idx[:3]])
        dense = torch.stack([SparseBow(db.words[r], db.weight[r]).densify(W) for r in rows])
        scores = l1_score_sparse(SparseBow(q.words[None], q.weight[None]), dense)
        got = torch.cat([idx.to(torch.float32), ok.to(torch.float32), scores]).cpu().numpy()
        idx_h, ok_h, sc = got[:5].astype(np.int64), got[5:10] > 0.5, got[10:]
        cands = idx_h[ok_h]
        hits1 += int(len(cands) > 0 and cands[0] == i)
        hits5 += int(i in set(cands.tolist()))
        wrong = [float(s) for j, s in zip(cands[:3], sc[1:]) if j != i]
        margins.append(float(sc[0]) - max([0.0] + wrong))
    return {"n_places": n, "recall_at_1": hits1 / n, "recall_at_5": hits5 / n,
            "mean_margin": float(np.mean(margins)), "n_words": W}
