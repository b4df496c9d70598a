"""Place recognition: the binary vocabulary tree and the keyframe BoW
database. Port of tpuslam/place."""

from tpuslam_torch.place.vocabulary import (
    Vocabulary,
    sparse_bow_vector,
    train_vocabulary,
)
from tpuslam_torch.place.database import (
    KeyFrameDatabase,
    SparseBow,
    SparseKeyFrameDatabase,
    l1_score,
    l1_score_sparse,
)
