"""Parallel paths: sharded bundle adjustment, the sharded map and mapping in
a separate process. Port of tpuslam/parallel/.

A mesh is a list of torch devices: the first n CUDA cards, or `cpu`
repeated (any device may repeat, so shards can share one card). Each shard
of a solve runs in its own thread on its own device; the partial sums meet
in a barrier that adds them in shard order (dist_ba.ShardReducer).
"""

from tpuslam_torch.parallel.dist_ba import (
    distributed_bundle_adjustment,
    make_mesh,
    point_sharded_bundle_adjustment,
    shard_ba_problem,
)
