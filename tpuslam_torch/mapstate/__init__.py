"""The functional map: fixed-capacity SoA tensors updated by functions that
return a new state. Port of tpuslam/mapstate."""

from tpuslam_torch.mapstate.core import (
    FrameFeatures,
    MapState,
    compute_point_descriptors,
    covisibility_weights,
    insert_keyframe,
    insert_points,
    make_empty_map,
    update_point_normals,
)
