"""The kernels' launch counters (`fast_nms.launches`,
`gather_patches.launches`, `pose_optimization.launches`), with a graph
capture's launches held apart.

A capture records a kernel's launch into its graph and runs nothing, so
pipeline/graphs.py counts the launches a capture records and adds them at
each replay. Two threads may run at once (the tracking thread and an
async_mapping thread, each with its own StepGraphs): while one captures,
the other's real launches must reach the counters and not the capture's
tally. The tally is therefore the capturing thread's own."""

from __future__ import annotations

import contextlib
import threading

_local = threading.local()


def count_launch(wrapper) -> None:
    """One launch of `wrapper`'s kernel: into the calling thread's capture
    tally while it captures, else into wrapper.launches."""
    tally = getattr(_local, "tally", None)
    if tally is None:
        wrapper.launches += 1
    else:
        tally[wrapper.__name__] = tally.get(wrapper.__name__, 0) + 1


@contextlib.contextmanager
def capture_tally():
    """Yields a dict that counts, by wrapper name, the launches the calling
    thread makes in the block (a capture's); the counters do not move."""
    _local.tally = {}
    try:
        yield _local.tally
    finally:
        _local.tally = None
