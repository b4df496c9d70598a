"""The port's compiled programs as captured CUDA graphs (StepGraphs).

The JAX package jits its hot programs: the frame step (tpuslam/pipeline/
steps.py, fused_track_frame), the batched step bench.py times, the
batched front end of MultiTracker, relocalization's searches and pose
optimizations, localization mode's visual odometry, and the essential
graph's CG. The port runs each as pure segments (tensors in, new tensors
out, no host read), with the host's branch decisions and the eager calls
that cannot be captured (cuSOLVER's eigh and svd, the BoW query, shapes
that follow the map) between them. The frame step's segments are
steps.mm_segment, ref_segment, local_segment and a front end
(mono_frame_features, stereo_frame_features or rgbd_frame_features),
composed by steps.compose_track_frame. On a card each segment is one CUDA
graph, captured at its first run for a key: the segment, its static
arguments (camera, ORB settings, th, depth, capacities) and the names,
shapes and dtypes of its tensor inputs. A replay is one cudaGraphLaunch in
place of the segment's thousands of kernel launches; the reads between
segments are the eager form's reads.

The buffer protocol, the same on every device:
  - inputs: every tensor is copied into the key's static buffer, one
    `torch._foreach_copy_` per dtype, on the calling thread's stream (a map
    adopted from a background mapping job is complete by then: the job
    synchronizes its stream before it returns). The map's tensors are
    replaced by mapping at almost every keyframe, so nothing is captured
    on their addresses. A buffer whose last source is the same tensor,
    unmodified since (`_version`), is not copied again.
  - outputs: returned as new tensors (contiguous clones), so nothing the
    caller keeps aliases a graph's memory, which the next replay of a graph
    of the same pool may overwrite.
The static buffers are contiguous, so a segment sees its inputs in
contiguous layout; call_segment, the eager route, gives it the same
layouts (a product over a transposed factor can round differently).
On a card `run` replays the graph; on the CPU it calls the segment on the
same static buffers, so the CPU tests go through the same copies.

No fallback: a capture or replay that fails raises. The kernel launch
counters (ops/fast.py's fast_nms.launches, ops/patches.py's
gather_patches.launches) do not move on a replay, so each graph records
the launches it captured (the capturing thread's own tally,
ops/launch_count.py) and adds them on each replay. Captures take turns
across threads.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import threading
import time

import torch

from tpuslam_torch.ops.fast import fast_nms
from tpuslam_torch.ops.launch_count import capture_tally
from tpuslam_torch.ops.patches import gather_patches

_COUNTERS = (fast_nms, gather_patches)
_CU_GRAPH_NODE_TYPE_KERNEL = 0  # CUgraphNodeType

# One capture at a time in the process. Entering torch.cuda.graph
# synchronizes the device and empties the allocator's cache, which
# invalidates a capture under way in another thread (the tracking thread
# and an async_mapping thread each capture into their own StepGraphs).
_capture_lock = threading.Lock()


def _flatten(tree, path: str, leaves: list):
    """Tensors of a tree (a tensor, None, or a tuple / NamedTuple of such)
    into `leaves` as (path, tensor); returns a function that rebuilds the
    tree from as many tensors, in order."""
    if isinstance(tree, torch.Tensor):
        leaves.append((path, tree))
        return lambda it: next(it)
    if tree is None:
        return lambda it: None
    if isinstance(tree, tuple):
        names = getattr(tree, "_fields", None) or [str(i) for i in range(len(tree))]
        parts = [_flatten(x, f"{path}.{n}", leaves) for n, x in zip(names, tree)]
        kind = type(tree)
        if hasattr(tree, "_fields"):
            return lambda it: kind(*(p(it) for p in parts))
        return lambda it: tuple(p(it) for p in parts)
    raise TypeError(f"a segment takes tensors, None and tuples of them, not {type(tree).__name__} at {path}")


def _graph_nodes(graph: int) -> tuple:
    """(nodes, kernel nodes) of a cudaGraph_t, through the driver API."""
    cu = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(ctypes.c_void_p(graph), None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(ctypes.c_void_p(graph), nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    kernels = 0
    kind = ctypes.c_int(0)
    for node in nodes:
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)):
            raise RuntimeError("cuGraphNodeGetType failed")
        kernels += kind.value == _CU_GRAPH_NODE_TYPE_KERNEL
    return n.value, kernels


def _contiguous(tree):
    """tree with every tensor in contiguous layout (the same tensor where
    it already is)."""
    leaves = []
    rebuild = _flatten(tree, "", leaves)
    return rebuild(iter([t.contiguous() for _, t in leaves]))


def call_segment(name: str, fn, static: dict, **inputs):
    """A segment run eagerly: the `run` of every composed path off the
    graphs (StepGraphs.run's signature). Its inputs and outputs are in
    contiguous layout, as StepGraphs' static buffers and clones give them:
    a product or a reduction can round differently over another layout (a
    transposed factor from cuSOLVER or LAPACK, an expanded mask)."""
    return _contiguous(fn(**{k: _contiguous(v) for k, v in inputs.items()}, **static))


class _Captured:
    """One segment's graph, its static outputs and captured kernel launches."""

    def __init__(self, graph, out, launches):
        self.graph, self.out, self.launches = graph, out, launches


class StepGraphs:
    """The segments of one owner's programs (a tracker's frame step,
    keyframe insertion and relocalization; a tracker's LocalMapping job; a
    MultiTracker's front end; one essential-graph solve), by key: static
    input buffers, and on a card the captured graphs, all sharing one
    memory pool (one capture at a time, replays in the calling thread's
    order). One thread uses an object at a time: a tracker's mapping job
    has its own (`Tracker.map_graphs`), as it may run on another thread.
    `stage` names the metrics stage that times the captures."""

    def __init__(self, device, metrics=None, stage: str = "track.capture"):
        self.device = torch.device(device)
        self.metrics = metrics
        self.stage = stage
        self._buffers = {}      # (path, shape, dtype) -> static tensor
        self._sources = {}      # the same key -> (last source, its _version)
        self._graphs = {}       # key -> _Captured
        self._pool = None
        self._side = None       # the warm-up stream
        self.captures = 0
        self.replays = 0
        self.runs = 0  # calls of run (replays, captures and CPU calls)
        self.copied_bytes = 0  # bytes copied into the static buffers
        # The kernels' launches that came from replays (a part of their
        # counters).
        self.replayed_launches = {c.__name__: 0 for c in _COUNTERS}
        # One record per capture: segment, static arguments, capture and
        # instantiation ms, nodes, kernel nodes, launches of both kernels.
        self.captured = []

    def run(self, name: str, fn, static: dict, **inputs):
        """fn(**inputs, **static) through the key's static buffers: on a
        card a replay of its graph (captured on first use), elsewhere a
        call. Returns fn's outputs as new tensors.

        With the recorder tracing, span `seg.<name>` covers the whole run
        (copy-in, replay or call, clones) and, on a card, its child
        `launch.<name>` covers graph.replay() alone, with the event pair
        that gives `dev.launch.<name>`: the stream's time from the
        replay's start to its end, a wait for the launch to reach the card
        included."""
        met = self.metrics
        if met is None or not met._on:
            return self._run(name, fn, static, inputs, None)
        with met.trace("seg." + name):
            return self._run(name, fn, static, inputs, met)

    def _run(self, name: str, fn, static: dict, inputs: dict, met):
        self.runs += 1
        leaves = []
        parts = {k: _flatten(v, k, leaves) for k, v in inputs.items()}
        bufs = iter(self._copy_in(leaves))
        args = {k: part(bufs) for k, part in parts.items()}
        key = (name, tuple(sorted(static.items())),
               tuple((p, tuple(t.shape), t.dtype) for p, t in leaves))
        if self.device.type != "cuda":
            out = fn(**args, **static)
        else:
            entry = self._graphs.get(key)
            if entry is None:
                entry = self._capture(key, fn, args, static)
            if met is None:
                entry.graph.replay()
            else:
                with met.trace("launch." + name, device=self.device, timed=True):
                    entry.graph.replay()
            self.replays += 1
            for counter, n in zip(_COUNTERS, entry.launches):
                if n:  # no write where nothing launched: another thread may be counting
                    counter.launches += n
                    self.replayed_launches[counter.__name__] += n
            out = entry.out
        out_leaves = []
        rebuild_out = _flatten(out, "", out_leaves)
        return rebuild_out(iter([t.clone(memory_format=torch.contiguous_format)
                                 for _, t in out_leaves]))

    def _copy_in(self, leaves) -> list:
        """Each input into its static buffer (made at first sight), one
        _foreach_copy_ per dtype; returns the buffers in order."""
        bufs, pending = [], {}
        for path, t in leaves:
            k = (path, tuple(t.shape), t.dtype)
            buf = self._buffers.get(k)
            if buf is None:
                buf = self._buffers[k] = torch.empty(t.shape, dtype=t.dtype, device=self.device)
            bufs.append(buf)
            last = self._sources.get(k)
            if last is not None and last[0] is t and last[1] == t._version:
                continue  # the buffer already holds this tensor
            self._sources[k] = (t, t._version)
            dst, src = pending.setdefault(t.dtype, ([], []))
            dst.append(buf)
            src.append(t)
            self.copied_bytes += t.numel() * t.element_size()
        for dst, src in pending.values():
            torch._foreach_copy_(dst, src)
        return bufs

    def _capture(self, key, fn, args, static) -> _Captured:
        """Warm the segment up on a side stream (the kernels' library,
        cuBLAS handles and the per-shape constant caches load there), then
        capture it on that stream and instantiate it; the caller's stream
        waits for both. Raises if either fails."""
        dev = self.device
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._side = torch.cuda.Stream(dev)
        timer = self.metrics.span(self.stage) if self.metrics is not None else contextlib.nullcontext()
        with timer:
            t0 = time.perf_counter()
            cur = torch.cuda.current_stream(dev)
            self._side.wait_stream(cur)
            with torch.cuda.stream(self._side):
                fn(**args, **static)
            cur.wait_stream(self._side)
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            t1 = time.perf_counter()
            # A CUDAGraph that the collector frees inside the capture would
            # destroy itself there, which invalidates the capture: collect
            # first, and not during it.
            with _capture_lock, capture_tally() as tally:
                collecting = gc.isenabled()
                gc.collect()
                gc.disable()
                try:
                    with torch.cuda.graph(graph, pool=self._pool, stream=self._side,
                                          capture_error_mode="thread_local"):
                        out = fn(**args, **static)
                finally:
                    if collecting:
                        gc.enable()
            cur.wait_stream(self._side)
            # The capture recorded these launches; none ran.
            launches = tuple(tally.get(c.__name__, 0) for c in _COUNTERS)
            t2 = time.perf_counter()
            nodes, kernel_nodes = _graph_nodes(graph.raw_cuda_graph())
            t3 = time.perf_counter()
            graph.instantiate()
            t4 = time.perf_counter()
        self.captures += 1
        self.captured.append(dict(
            segment=key[0],
            static={k: v for k, v in key[1] if k not in ("cam", "cams", "orb", "config", "cfg")},
            warmup_ms=(t1 - t0) * 1e3, capture_ms=(t2 - t1) * 1e3, instantiate_ms=(t4 - t3) * 1e3,
            nodes=nodes, kernel_nodes=kernel_nodes,
            launches={c.__name__: n for c, n in zip(_COUNTERS, launches)}))
        entry = self._graphs[key] = _Captured(graph, out, launches)
        return entry

    def pool_bytes(self) -> int:
        """Bytes the allocator holds in this object's graph pool (0 before
        the first capture)."""
        if self._pool is None:
            return 0
        pool = tuple(self._pool)
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == pool)

    def buffer_bytes(self) -> int:
        """Bytes of the static input buffers."""
        return sum(b.numel() * b.element_size() for b in self._buffers.values())

