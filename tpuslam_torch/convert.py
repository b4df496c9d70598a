"""Carry state between the JAX package and the port, through numpy.

Descriptors are 256-bit strings of eight 32-bit words: uint32 in the JAX
package, the same bits as int32 in the port (torch has no uint32 shifts).
Every uint32 array crossing into the port becomes int32 bit patterns, and
`desc_to_numpy` turns them back into uint32. Images, poses and other arrays
cross with `array_to_tensor` as they are. Nothing here imports jax: a JAX
array crosses through np.asarray.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuslam_torch.geometry.camera import PinholeCamera
from tpuslam_torch.mapstate.core import FrameFeatures, MapState
from tpuslam_torch.ops.orb import ORBFeatures
from tpuslam_torch.optim.ba import BAProblem
from tpuslam_torch.optim.pose import PoseObs
from tpuslam_torch.place.vocabulary import Vocabulary, vocabulary_from_arrays


def array_to_tensor(x, device="cuda") -> torch.Tensor:
    """Any array np.asarray takes -> tensor on `device`; uint32 words become
    int32 bit patterns, every other dtype is kept."""
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def desc_to_numpy(desc: torch.Tensor) -> np.ndarray:
    """int32 descriptor words -> the JAX package's uint32 words."""
    if desc.dtype != torch.int32:
        raise ValueError(f"descriptor words must be int32, got {desc.dtype}")
    return desc.detach().cpu().numpy().view(np.uint32)


def camera_from(cam) -> PinholeCamera:
    """The JAX package's PinholeCamera (same fields) -> the port's."""
    return PinholeCamera(**cam._asdict())


def features_to_torch(f, device="cuda") -> ORBFeatures:
    """The JAX package's ORBFeatures -> the port's."""
    return ORBFeatures(*(array_to_tensor(x, device) for x in f))


def features_to_numpy(f: ORBFeatures) -> ORBFeatures:
    """The port's ORBFeatures -> the same fields as numpy, uint32 desc."""
    return ORBFeatures(*(_to_numpy(n, x) for n, x in zip(ORBFeatures._fields, f)))


def pose_obs_to_torch(obs, device="cuda") -> PoseObs:
    """The JAX package's PoseObs -> the port's."""
    return PoseObs(*(array_to_tensor(x, device) for x in obs))


def _to_numpy(name: str, x: torch.Tensor) -> np.ndarray:
    return desc_to_numpy(x) if name.endswith("desc") else x.detach().cpu().numpy()


def frame_features_to_torch(f, device="cuda") -> FrameFeatures:
    """The JAX package's FrameFeatures -> the port's."""
    return FrameFeatures(*(array_to_tensor(x, device) for x in f))


def frame_features_to_numpy(f: FrameFeatures) -> FrameFeatures:
    """The port's FrameFeatures -> the same fields as numpy, uint32 desc."""
    return FrameFeatures(*(_to_numpy(n, x) for n, x in zip(FrameFeatures._fields, f)))


def map_to_torch(m, device="cuda") -> MapState:
    """The JAX package's MapState (or one of numpy arrays) -> the port's:
    every field, the uint32 descriptor words as int32 bit patterns, the
    0-d watermarks as 0-d int32."""
    return MapState(*(array_to_tensor(x, device) for x in m))


def map_to_numpy(m: MapState) -> MapState:
    """The port's MapState -> the same fields as numpy arrays, descriptors
    as the JAX package's uint32 words. jnp.asarray of each field gives the
    JAX package's MapState: `jax_core.MapState(*map(jnp.asarray, ...))`."""
    return MapState(*(_to_numpy(n, x) for n, x in zip(MapState._fields, m)))


def ba_problem_to_torch(prob, device="cuda") -> BAProblem:
    """The JAX package's BAProblem (or one of numpy arrays) -> the port's."""
    return BAProblem(*(array_to_tensor(x, device) for x in prob))


def vocabulary_from_numpy(voc, device="cuda") -> Vocabulary:
    """The JAX package's Vocabulary, or the arrays of its npz file (a dict
    or an np.load result), -> the port's: uint32 centers as int32 bit
    patterns, centers_valid kept where the tree has it."""
    if hasattr(voc, "centers"):
        z = {f"centers_{i}": np.asarray(c) for i, c in enumerate(voc.centers)}
        z.update(word_weight=np.asarray(voc.word_weight), k=voc.k, levels=voc.levels)
        if voc.centers_valid is not None:
            z.update({f"centers_valid_{i}": np.asarray(v) for i, v in enumerate(voc.centers_valid)})
        voc = z
    return vocabulary_from_arrays(dict(voc), device)
