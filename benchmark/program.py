"""Everything the benchmark takes from the program under test, the PyTorch
and CUDA port (`tpuslam_torch`), in one place: its public entry (System),
the kernel build, the kernels' entry points and launch counters (for the
comparison of the kernels' outputs), and the tracker's counters and stage
timers. Nothing else of the benchmark imports the program.
"""

from __future__ import annotations

import time


def load(build: bool = True) -> dict:
    """Import the port (timed), then build and load its CUDA kernels
    through its own build (`tpuslam_torch/_build.py`, whose directory
    inside the checkout is the compile cache; `build` False only where
    there is no card, in the harness's tests). Returns the seconds of each
    step."""
    t0 = time.perf_counter()
    global System, SensorType, PinholeCamera, ORBConfig, build_pyramid, fast_nms_pyramid
    global detect_batched, gather_patches, fast_nms, _build
    from tpuslam_torch import _build
    from tpuslam_torch.geometry.camera import PinholeCamera
    from tpuslam_torch.ops.fast import fast_nms, fast_nms_pyramid
    from tpuslam_torch.ops.image import build_pyramid
    from tpuslam_torch.ops.orb import ORBConfig, detect_batched
    from tpuslam_torch.ops.patches import gather_patches
    from tpuslam_torch.pipeline.system import SensorType, System
    t1 = time.perf_counter()
    if build:
        _build.build()
        _build.lib()
    return {"import_s": t1 - t0, "build_s": time.perf_counter() - t1}


def make_system(config: dict, device="cuda"):
    """The configuration's System: its camera, ORB extractor, sensor and
    tracker settings, at its capacities."""
    cam = PinholeCamera(**config["camera"])
    sensor = {"monocular": SensorType.MONOCULAR, "stereo": SensorType.STEREO}[config["sensor"]]
    return System(cam, sensor, orb=ORBConfig(**config["orb"]), device=device, **config["tracker"])


def track(system, views, timestamp: float):
    """Hand one frame (host uint8 arrays: the image, or the rectified
    pair) to the System; its pose (R, t) world->camera, or None."""
    if len(views) == 1:
        return system.track_monocular(views[0], timestamp)
    return system.track_stereo(views[0], views[1], timestamp)


def load_vocabulary(system) -> float:
    """Seconds to load the loop closer's vocabulary now, which it would
    otherwise load at the first keyframe; 0 where there is no loop closer
    or no such step to call (then the load falls into the warm-up)."""
    lc = system.tracker.loop_closer
    ensure = getattr(lc, "_ensure_vocabulary", None)
    if ensure is None:
        return 0.0
    t0 = time.perf_counter()
    ensure(system.tracker.map)
    return time.perf_counter() - t0


def _captures(g) -> int:
    return int(getattr(g, "captures", 0) or 0)


def counters(system) -> dict:
    """The tracker's counts: keyframes inserted, keyframe jobs, graphs
    captured by its three graph sets and its loop closer's, the kernels'
    launches, frames handed over."""
    tr = system.tracker
    c = tr.metrics.counters
    lc = tr.loop_closer
    return {"keyframes": c.get("frames.keyframe", 0), "map_jobs": tr.stats.get("map_jobs", 0),
            "captures": sum(_captures(getattr(o, k, None)) for o, k in
                            ((tr, "graphs"), (tr, "map_graphs"), (tr, "gba_graphs"), (lc, "graphs"))),
            "fast_nms_launches": fast_nms.launches, "gather_patches_launches": gather_patches.launches,
            "n_frames": tr.n_frames}


def state(system) -> str:
    """The tracking state's name (OK, LOST, NOT_INITIALIZED, ...)."""
    return system.state.name


def tracking(system) -> bool:
    return system.state.name == "OK"


def keyframes(system) -> int:
    """Keyframes the tracker has inserted."""
    return system.tracker.metrics.counters.get("frames.keyframe", 0)


def stage_samples(system, copy: bool = True) -> dict:
    """The tracker's stage timers: name -> list of seconds, in order (the
    live lists with copy False: read them, do not keep them)."""
    samples = system.tracker.metrics.timer.samples
    return {k: list(v) for k, v in samples.items()} if copy else dict(samples)


def set_stage_sync(system, on: bool) -> None:
    """With it on, each stage's timer ends after the device has finished
    the stage's work, so it holds device time."""
    system.tracker.stage_sync = on


MAP_FIELDS = ("kf_valid", "kf_R", "kf_t", "kf_frame_id", "kf_obs_pt", "pt_valid", "pt_xyz",
              "pt_first_kf", "n_kf", "n_pt")


def map_host(system) -> dict:
    """The map's keyframes and points as host numpy arrays."""
    m = system.tracker.map
    return {k: getattr(m, k).cpu().numpy() for k in MAP_FIELDS}


def free(system) -> None:
    """Let the System go: finish its background work and drop its map."""
    system.shutdown()
    system.tracker.map = None
