"""Live-feed adapter: drive a System from an asynchronous camera source.
Port of tpuslam/io/live.py.

Equivalent of the reference's ROS nodes (Examples/ROS/ORB_SLAM2/src/
ros_mono.cc, ros_stereo.cc, ros_rgbd.cc): a producer (camera driver,
socket, capture thread) pushes timestamped frames; a consumer thread feeds
them to System.track_*. Like an image-topic subscriber with queue size 1, a
slow tracker drops stale frames instead of building latency: the newest
frame wins.

The consumer thread tracks on the System's device. CUDA's current stream
is per thread and every thread starts on the default stream, so the
tracker's work stays on the default stream, as it does on the main thread.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional


class LiveFrame:
    __slots__ = ("img", "right", "depth", "timestamp")

    def __init__(self, img, timestamp, right=None, depth=None):
        self.img = img
        self.right = right
        self.depth = depth
        self.timestamp = timestamp


class LiveRunner:
    """Single-slot frame mailbox and consumer thread around a System.

    on_result(frame_id, timestamp, pose_or_None) fires after every tracked
    frame; pose is (R (3, 3), t (3,)) world->camera, or None when lost.
    """

    def __init__(self, system, on_result: Optional[Callable] = None):
        self.system = system
        self.on_result = on_result
        self._slot: Optional[LiveFrame] = None
        self._cv = threading.Condition()
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self.n_pushed = 0
        self.n_tracked = 0
        self.n_dropped = 0

    # ---------------------------------------------------------- producer API

    def push(self, img, timestamp: float, right=None, depth=None):
        """Deliver a frame (any thread). Overwrites an unconsumed frame: the
        drop-stale policy of a queue-1 image subscriber."""
        with self._cv:
            if self._slot is not None:
                self.n_dropped += 1
            self._slot = LiveFrame(img, timestamp, right=right, depth=depth)
            self.n_pushed += 1
            self._cv.notify()

    # ---------------------------------------------------------- consumer API

    def start(self):
        self._running = True
        self._thread = threading.Thread(target=self._loop, name="live-track", daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 30.0):
        with self._cv:
            self._running = False
            self._cv.notify()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def _track(self, f: LiveFrame):
        if f.depth is not None:
            return self.system.track_rgbd(f.img, f.depth, f.timestamp)
        if f.right is not None:
            return self.system.track_stereo(f.img, f.right, f.timestamp)
        return self.system.track_monocular(f.img, f.timestamp)

    def _loop(self):
        while True:
            with self._cv:
                while self._slot is None and self._running:
                    self._cv.wait(0.05)
                if not self._running and self._slot is None:
                    return
                f, self._slot = self._slot, None
            pose = self._track(f)
            self.n_tracked += 1
            if self.on_result is not None:
                self.on_result(self.n_tracked - 1, f.timestamp, pose)
