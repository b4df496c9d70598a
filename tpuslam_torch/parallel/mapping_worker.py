"""Mapping and loop closing in a separate process. Port of
tpuslam/parallel/mapping_worker.py.

The reference runs LocalMapping and LoopClosing as threads in the
tracker's process. A mapping job is a function of a MapState snapshot
(Tracker._mapping_compute), so it can run wherever the snapshot can be
sent. This module is the client (RemoteMappingWorker, called from the
tracker's mapping thread) and the worker
(`python -m tpuslam_torch.parallel.mapping_worker`).

Transport, as in the JAX package: length-prefixed pickles of numpy arrays
over the child's stdin and stdout; the messages init, map, interrupt
(tagged with the job id, so a late one cannot truncate the next job),
reset and close; a reader thread in the worker takes interrupts out of
band and sets the engine's InterruptBA event mid-job. Each job moves the
whole snapshot both ways (device -> host, pickle, pipe, unpickle, host ->
device); RemoteMappingWorker.jobs keeps the bytes and milliseconds of each
step.

The worker owns the loop-closing state (the keyframe database and the
consistency chains, as the reference's LoopClosing thread does) and runs
global BA inline after a closure. Each result carries the keyframes' new
BoW rows back, and the vocabulary once (in the npz layout), which the
tracker mirrors into its own loop closer so that relocalization keeps its
BoW candidates.

Device: the worker's engine runs on `device`, "cuda" by default: a card
takes both processes (the JAX package kept its worker on the CPU because
one process owns a TPU chip). A worker asked for "cuda" that finds no card
fails at start-up and the client raises; it never falls back to the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import queue
import struct
import subprocess
import sys
import threading
import time
import traceback

import numpy as np
import torch

from tpuslam_torch.mapstate.core import MapState

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _ms(t0: float) -> float:
    return (time.perf_counter() - t0) * 1e3


def _write_msg(stream, obj):
    """Pickle obj and write it with its 8-byte length. Returns (bytes,
    pickle ms, write ms)."""
    t0 = time.perf_counter()
    blob = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    t1 = time.perf_counter()
    stream.write(struct.pack("<Q", len(blob)))
    stream.write(blob)
    stream.flush()
    return len(blob), (t1 - t0) * 1e3, _ms(t1)


def _read_msg(stream):
    """One message. Returns (obj, bytes, ms reading the body after its
    length arrived, unpickle ms)."""
    header = stream.read(8)
    if len(header) < 8:
        raise EOFError("mapping worker pipe closed")
    (n,) = struct.unpack("<Q", header)
    t0 = time.perf_counter()
    blob = stream.read(n)
    if len(blob) < n:
        raise EOFError("mapping worker pipe truncated")
    t1 = time.perf_counter()
    return pickle.loads(blob), n, (t1 - t0) * 1e3, _ms(t1)


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _map_to_numpy(m: MapState) -> tuple:
    return tuple(x.cpu().numpy() for x in m)


class RemoteMappingWorker:
    """Client handle: starts the worker process and ships it mapping jobs.

    process(m, ki, depth_mode) is synchronous: the tracker calls it on its
    mapping thread, so the one-job-in-flight protocol is unchanged.
    `info` holds the worker's device, its start-up seconds and the jax or
    tpuslam modules it has loaded (none); `jobs` one dict of bytes and ms
    per job."""

    def __init__(self, tracker_config, device="cuda"):
        if device not in ("cuda", "cpu"):
            raise ValueError(f"mapping worker device must be 'cuda' or 'cpu', not {device!r}")
        t0 = time.perf_counter()
        self._proc = subprocess.Popen([sys.executable, "-m", "tpuslam_torch.parallel.mapping_worker"],
                                      stdin=subprocess.PIPE, stdout=subprocess.PIPE, cwd=_ROOT)
        # stdin is shared by the job writer (the mapping thread) and the
        # interrupt sender (the tracking thread): one frame at a time.
        self._stdin_lock = threading.Lock()
        self._job_id = 0
        self.jobs: list = []
        with self._stdin_lock:
            _write_msg(self._proc.stdin, ("init", tracker_config, device, torch.get_num_threads()))
        try:
            kind, payload = _read_msg(self._proc.stdout)[0]
        except EOFError as e:
            self._proc.kill()
            raise RuntimeError("mapping worker died while starting") from e
        if kind != "ready":
            self._proc.wait(timeout=30)
            raise RuntimeError(f"mapping worker failed to start:\n{payload}")
        self.info = dict(payload, startup_s=time.perf_counter() - t0)

    def process(self, m: MapState, ki: int, depth_mode: bool):
        """One keyframe's mapping and loop-closing job in the worker.
        Returns (MapState on m's device, the compaction remap or None, the
        new BoW rows [(slot, frame id, words, weights)], the vocabulary
        blob or None)."""
        dev = m.kf_R.device
        t = {}
        t0 = time.perf_counter()
        arrays = _map_to_numpy(m)
        t["d2h_ms"] = _ms(t0)
        with self._stdin_lock:
            self._job_id += 1
            t["bytes_out"], t["pickle_ms"], t["send_ms"] = _write_msg(
                self._proc.stdin, ("map", self._job_id, arrays, int(ki), bool(depth_mode)))
        t0 = time.perf_counter()
        reply, t["bytes_in"], t["recv_ms"], t["unpickle_ms"] = _read_msg(self._proc.stdout)
        t["wait_ms"] = _ms(t0)  # the job sent -> the reply read: the worker's work included
        kind, payload, pt_remap, bow_rows, voc_blob, t["worker"] = reply
        if kind == "err":
            raise RuntimeError(f"mapping worker failed:\n{payload}")
        t0 = time.perf_counter()
        m2 = MapState(*(torch.from_numpy(a).to(dev) for a in payload))
        remap = None if pt_remap is None else torch.from_numpy(pt_remap).to(dev)
        _sync(dev)
        t["h2d_ms"] = _ms(t0)
        self.jobs.append(t)
        return m2, remap, bow_rows, voc_blob

    def interrupt(self):
        """InterruptBA over the pipe: the current job skips its optional
        work. Tagged with the job id, so a late one is dropped."""
        if self._proc.poll() is not None:
            return
        with self._stdin_lock:
            _write_msg(self._proc.stdin, ("interrupt", self._job_id))

    def reset(self):
        """Clear the worker's loop-closing state (Tracking::Reset resets
        the LoopClosing thread too)."""
        with self._stdin_lock:
            _write_msg(self._proc.stdin, ("reset", None))
        status = _read_msg(self._proc.stdout)[0]
        if status != "reset-ok":
            raise RuntimeError(f"mapping worker reset: {status!r}")

    def close(self):
        if self._proc.poll() is None:
            try:
                with self._stdin_lock:
                    _write_msg(self._proc.stdin, ("close", None))
                self._proc.wait(timeout=30)
            except Exception:  # noqa: BLE001 - a worker that does not stop is killed
                self._proc.kill()
                self._proc.wait()


def _voc_blob(voc) -> dict:
    """A Vocabulary as the arrays of its npz file (vocabulary_from_arrays)."""
    blob = {f"centers_{i}": c.cpu().numpy() for i, c in enumerate(voc.centers)}
    blob.update(word_weight=voc.word_weight.cpu().numpy(), k=voc.k, levels=voc.levels)
    for i, v in enumerate(voc.centers_valid or ()):
        blob[f"centers_valid_{i}"] = v.cpu().numpy()
    return blob


def _worker_main() -> int:
    stdin, stdout = sys.stdin.buffer, sys.stdout.buffer
    # Nothing the mapping code prints may corrupt the framed protocol.
    sys.stdout = sys.stderr
    kind, cfg, device, n_threads = _read_msg(stdin)[0]
    assert kind == "init", kind
    try:
        if device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("the mapping worker was asked for device 'cuda', but no CUDA device "
                               "is visible; it does not fall back to the CPU")
        if device == "cpu":
            torch.set_num_threads(n_threads)  # the caller's: the same sums in the same order
        from tpuslam_torch.pipeline.tracker import Tracker

        # A non-tracking Tracker is the mapping context: the config's
        # constants, the loop closer (stateful across jobs), inline global BA.
        engine = Tracker(dataclasses.replace(cfg, async_mapping=False, mapping_process=False),
                         device=device)
    except Exception:  # noqa: BLE001 - reported to the client, which raises
        _write_msg(stdout, ("err", traceback.format_exc()))
        return 1
    dev = engine.device
    _write_msg(stdout, ("ready", {
        "device": str(dev), "name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "pid": os.getpid(),
        "foreign_modules": sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "tpuslam")),
    }))
    shipped_bow: dict = {}  # slot -> frame id already sent back
    voc_shipped = False
    jobs: "queue.Queue" = queue.Queue()
    current_job = [0]

    def reader():
        while True:
            try:
                msg, nbytes, recv_ms, unpickle_ms = _read_msg(stdin)
            except EOFError:
                jobs.put((("close", None), {}))
                return
            if msg[0] == "interrupt":
                if msg[1] == current_job[0]:
                    engine._mapping_interrupt.set()
                continue
            jobs.put((msg, {"recv_ms": recv_ms, "unpickle_ms": unpickle_ms}))
            if msg[0] == "close":
                return

    threading.Thread(target=reader, daemon=True, name="mapping-worker-reader").start()
    while True:
        (kind, *payload), t = jobs.get()
        if kind == "close":
            return 0
        if kind == "reset":
            engine.reset()
            shipped_bow.clear()
            _write_msg(stdout, "reset-ok")
            continue
        job_id, arrays, ki, depth_mode = payload
        try:
            t0 = time.perf_counter()
            m = MapState(*(torch.from_numpy(a).to(dev) for a in arrays))
            _sync(dev)
            t["h2d_ms"] = _ms(t0)
            engine._depth_mode = depth_mode
            engine._mapping_interrupt.clear()
            current_job[0] = job_id
            skipped = engine.metrics.counters["map.local_ba2_skipped"]
            t0 = time.perf_counter()
            m = engine._mapping_compute(m, ki)
            _sync(dev)
            t["compute_ms"] = _ms(t0)
            current_job[0] = 0
            t["ba2_skipped"] = engine.metrics.counters["map.local_ba2_skipped"] > skipped
            # The engine's mapping graphs (captured here, in the worker).
            t["map_jobs"] = engine.stats["map_jobs"]
            t["map_graph_replays"] = engine.stats["map_graph_replays"]
            t["map_graph_captures"] = engine.stats["map_graph_captures"]
            t0 = time.perf_counter()
            out = _map_to_numpy(m)
            remap = engine._pending_pt_remap
            engine._pending_pt_remap = None
            remap = None if remap is None else remap.cpu().numpy()
            bow_rows, voc_blob = [], None
            lc = engine.loop_closer
            if lc is not None and lc.voc is not None:
                fid = m.kf_frame_id.cpu().numpy().astype(np.int64)
                valid = m.kf_valid.cpu().numpy()
                for s, bow in lc._bow.items():
                    f = int(fid[s]) if valid[s] else -1
                    if f >= 0 and shipped_bow.get(s) != f:
                        shipped_bow[s] = f
                        bow_rows.append((int(s), f, bow.words.cpu().numpy(), bow.weight.cpu().numpy()))
                if not voc_shipped and (bow_rows or lc.db is not None):
                    voc_shipped = True
                    voc_blob = _voc_blob(lc.voc)
            t["d2h_ms"] = _ms(t0)
            _write_msg(stdout, ("ok", out, remap, bow_rows, voc_blob, t))
        except Exception:  # noqa: BLE001 - the job fails in the client
            current_job[0] = 0
            _write_msg(stdout, ("err", traceback.format_exc(), None, None, None, t))


if __name__ == "__main__":
    sys.exit(_worker_main())
