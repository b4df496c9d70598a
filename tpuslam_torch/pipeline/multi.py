"""MultiTracker: B independent SLAM sessions on one card with a batched
front end. Port of tpuslam/pipeline/multi.py.

Each frame's ORB extraction, the fixed cost, runs once over every stream's
images (2B for stereo): one FAST+NMS launch and one descriptor gather for
the whole batch. Each stream then matches its stereo pair over the batch's
atlas (one more gather) and runs its own Tracker: separate maps and
trajectories, and one stream going LOST does not disturb the others.
Monocular streams still initializing extract on their own at twice the
feature budget; only the steady state batches.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch

from tpuslam_torch.ops.orb import ORBFeatures, extract_orb_batched, extract_orb_batched_atlas
from tpuslam_torch.pipeline.steps import stereo_features
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
        steady = [t.state in (TrackingState.OK, TrackingState.LOST) for t in self.trackers]
        fb = extract_orb_batched(imgs, self.orb) if any(steady) else None
        out = []
        for b, tracker in enumerate(self.trackers):
            if steady[b]:
                f = ORBFeatures(*(leaf[b] for leaf in fb))
                out.append(tracker.track_monocular_features(tracker._mono_features(f), frame_id))
            else:
                out.append(tracker.track_monocular(imgs[b], frame_id))
        return out

    def track_stereo(self, imgs_left, imgs_right, frame_id: int):
        """(B, H, W) rectified left and right images: all 2B extracted in one
        batch, then each stream's stereo matching and tracking. Returns one
        T_cw (R, t) or None per stream."""
        imgs = torch.cat([self._input(imgs_left), self._input(imgs_right)])
        B = self.n_streams
        fb, atlas = extract_orb_batched_atlas(imgs, self.orb)
        out = []
        for b, tracker in enumerate(self.trackers):
            c = tracker.cfg.cam
            feats = stereo_features(fb, atlas, b, B + b, tuple(imgs.shape[-2:]), self.orb,
                                    c.fx, c.bf)
            out.append(tracker.track_depth_features(feats, frame_id))
        return out

    def export_trajectories(self):
        return [t.export_trajectory() for t in self.trackers]

    def shutdown(self):
        for t in self.trackers:
            t.shutdown()
