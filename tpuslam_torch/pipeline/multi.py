"""MultiTracker: B independent SLAM sessions on one card with a batched
front end. Port of tpuslam/pipeline/multi.py.

Each frame's ORB extraction, the fixed cost, runs once over every stream's
images (2B for stereo): one FAST+NMS launch and one descriptor gather for
the whole batch. Each stream then matches its stereo pair over the batch's
atlas (one more gather) and runs its own Tracker: separate maps and
trajectories, and one stream going LOST does not disturb the others.
Monocular streams still initializing extract on their own at twice the
feature budget; only the steady state batches. The batched front end is
one segment (steps.batched_mono_features or batched_stereo_features, the
stream indices static) through the MultiTracker's StepGraphs
(pipeline/graphs.py): one CUDA graph replayed per frame on a card, its
own memory pool; each stream's tracking step replays its Tracker's graphs.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch

from tpuslam_torch.pipeline import steps
from tpuslam_torch.pipeline.graphs import StepGraphs
from tpuslam_torch.pipeline.tracker import Tracker, TrackerConfig, TrackingState


class MultiTracker:
    """B monocular or stereo sessions. `configs`: one TrackerConfig per
    stream, all with one ORBConfig (that is what makes one batched launch
    possible). The trackers run on `device` ("cuda" unless the caller asks
    for the CPU)."""

    def __init__(self, configs: Sequence[TrackerConfig], device="cuda"):
        if len(configs) < 1:
            raise ValueError("MultiTracker needs at least one stream")
        self.orb = configs[0].orb
        for c in configs[1:]:
            if c.orb != self.orb:
                raise ValueError("all streams must share one ORBConfig")
        self.device = torch.device(device)
        self.trackers: List[Tracker] = [Tracker(c, device=device) for c in configs]
        self.graphs = StepGraphs(self.device)  # the batched front end's

    @classmethod
    def uniform(cls, config: TrackerConfig, n_streams: int, device="cuda") -> "MultiTracker":
        return cls([dataclasses.replace(config) for _ in range(n_streams)], device=device)

    @property
    def n_streams(self) -> int:
        return len(self.trackers)

    def _input(self, imgs) -> torch.Tensor:
        imgs = torch.as_tensor(imgs, dtype=torch.float32).to(self.device)
        if imgs.shape[0] != self.n_streams:
            raise ValueError(f"{imgs.shape[0]} images for {self.n_streams} streams")
        return imgs

    def track_monocular(self, imgs, frame_id: int):
        """(B, H, W) grayscale images, one per stream. Returns one T_cw (R,
        t) or None per stream."""
        imgs = self._input(imgs)
        steady = tuple(b for b, t in enumerate(self.trackers)
                       if t.state in (TrackingState.OK, TrackingState.LOST))
        feats = dict(zip(steady, self.graphs.run(
            "front", steps.batched_mono_features,
            dict(orb=self.orb, streams=steady, cams=tuple(self.trackers[b].cfg.cam for b in steady)),
            imgs=imgs) if steady else ()))
        out = []
        for b, tracker in enumerate(self.trackers):
            if b in feats:
                out.append(tracker.track_monocular_features(feats[b], frame_id))
            else:
                out.append(tracker.track_monocular(imgs[b], frame_id))
        return out

    def track_stereo(self, imgs_left, imgs_right, frame_id: int):
        """(B, H, W) rectified left and right images: all 2B extracted in one
        batch, then each stream's stereo matching and tracking. Returns one
        T_cw (R, t) or None per stream."""
        imgs = torch.cat([self._input(imgs_left), self._input(imgs_right)])
        feats = self.graphs.run("front", steps.batched_stereo_features,
                                dict(orb=self.orb, cams=tuple(t.cfg.cam for t in self.trackers)),
                                imgs=imgs)
        return [t.track_depth_features(f, frame_id) for t, f in zip(self.trackers, feats)]

    def export_trajectories(self):
        return [t.export_trajectory() for t in self.trackers]

    def shutdown(self):
        for t in self.trackers:
            t.shutdown()
