"""Map checkpoint and resume. Port of tpuslam/io/checkpoint.py.

The reference never implemented SaveMap/LoadMap (a TODO in its
include/System.h). Every MapState field is an array, so a checkpoint is one
compressed npz, in the JAX package's format: each field as the JAX package
holds it (descriptors as uint32 words, the watermarks n_kf and n_pt as 0-d
arrays, through convert.map_to_numpy). A map written by either package
loads into the other bit for bit. With the tracker's localization mode it
gives the map-once / localize-later workflow.
"""

from __future__ import annotations

import numpy as np

from tpuslam_torch.convert import map_to_numpy, map_to_torch
from tpuslam_torch.mapstate.core import MapState

_SCALARS = ("n_kf", "n_pt")


def save_map(m: MapState, path: str) -> None:
    """Write every field of `m` to one np.savez_compressed file."""
    np.savez_compressed(path, **map_to_numpy(m)._asdict())


def load_map(path: str, device="cuda") -> MapState:
    """The MapState of a checkpoint on `device`. Fields that older files
    lack take the JAX package's defaults: the culled-keyframe spanning tree
    (kf_parent, kf_rel_R, kf_rel_t) as "no parent"."""
    with np.load(path) as z:
        K = z["kf_R"].shape[0]
        defaults = {
            "kf_parent": np.full((K,), -1, np.int32),
            "kf_rel_R": np.broadcast_to(np.eye(3, dtype=np.float32), (K, 3, 3)),
            "kf_rel_t": np.zeros((K, 3), np.float32),
        }
        fields = {name: z[name] if name in z.files else defaults[name] for name in MapState._fields}
    for name in _SCALARS:  # 0-d int32, whatever integer type the file holds
        fields[name] = np.asarray(fields[name].item(), np.int32)
    return map_to_torch(MapState(**fields), device)
