"""One run of one cell: set-up, the window, the comparison, the result.
run.py is its command line; the tests drive it without a card."""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from benchmark import correct, program, stats, trace
from benchmark.traffic import frames as frames_mod
from benchmark.traffic import routes
from benchmark.traffic.scene import Corridor

lap = time.perf_counter


def info(msg: str) -> None:
    print(msg, flush=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _epochs(states: list) -> list:
    """The map's epoch of each frame: it steps where tracking restarts
    (a reset clears the map; the world and, monocular, the scale start
    anew), so that no pose is compared across it."""
    out, e, prev = [], 0, None
    for st in states:
        if st in ("NOT_INITIALIZED", "NO_IMAGES_YET") and prev not in (None, "NOT_INITIALIZED", "NO_IMAGES_YET"):
            e += 1
        out.append(e)
        prev = st
    return out


class Run:
    """`execute()` makes one run of `cell` (its BENCHMARK.json entry merged
    over its data file) with `seed`, a window of `seconds`, traced or not.
    `t0` is the process's start on the perf_counter clock. `device` is
    "cuda" but in the tests of the harness."""

    def __init__(self, man, cell: dict, seed: int, seconds: float, traced: bool, t0: float,
                 device="cuda"):
        self.man, self.cell, self.seed, self.seconds = man, cell, int(seed), float(seconds)
        self.traced, self.t0, self.device = traced, t0, device
        self.config = man.config(cell["config"])
        self.cam = dict(self.config["camera"])
        self.stereo = self.config["sensor"] == "stereo"
        self.fps = float(self.config["fps"])

    # ------------------------------------------------------------------ frames

    def _source(self, route: dict):
        baseline = self.cam["bf"] / self.cam["fx"] if self.stereo else 0.0
        return frames_mod.FrameSource(self.scene, self.cam, route, baseline)

    def truth_of(self, ids) -> tuple:
        """True world->camera poses of System frame ids (frame id k is
        route frame k)."""
        return routes.poses(self.route, np.asarray(ids, np.int64))

    def _warm_up(self, until, limit: int) -> int:
        """Hand route frames 0, 1, ... to the System until until(count)
        holds (at most `limit` frames, or the set-up fails). Returns the
        count."""
        src = self.window_src
        chunk = int(self.cell.get("chunk_frames", 64))
        done = 0
        while not until(done):
            if done >= limit:
                raise RuntimeError(f"set-up: no steady state after {done} frames of the warm-up")
            for views in src.render(done, chunk):
                program.track(self.system, views, done / self.fps)
                done += 1
                if until(done):
                    break
        self.next_id = done
        return done

    # ----------------------------------------------------------------- set-up

    def setup(self, smi: str) -> dict:
        s = {}
        info(f"card: {torch.cuda.get_device_name(0) if self.device == 'cuda' else self.device}, "
             f"device count {torch.cuda.device_count() if self.device == 'cuda' else 0}; "
             f"nvidia-smi name, power.limit: {smi}")
        s.update(program.load(self.device == "cuda"))
        t = lap()
        self.scene = Corridor(self.seed, device=self.device, **self.cell["scene"])
        sync(self.device)
        s["scene_s"] = lap() - t
        t = lap()
        self.system = program.make_system(self.config, self.device)
        s["system_s"] = lap() - t
        s["vocabulary_s"] = program.load_vocabulary(self.system)
        t = lap()
        self.route = self.cell["route"]
        self.window_src = self._source(self.route)
        self.route_frames = routes.length_frames(self.route, self.scene.x_lo, self.scene.x_hi,
                                                 float(self.cell.get("route_margin_m", 0.0)))
        c0 = program.counters(self.system)
        wu = self.cell["warmup"]

        def steady(done: int) -> bool:
            """Past the warm-up's least frames and keyframes (every graph
            and lazy step of the traffic met: initialization, the first
            keyframe jobs, the loop closer's first detections), and
            tracking."""
            return (done >= int(wu["min_frames"]) and program.tracking(self.system)
                    and program.keyframes(self.system) - c0["keyframes"] >= int(wu.get("min_keyframes", 0)))

        self.warmup_frames = self._warm_up(steady, int(wu["max_frames"]))
        sync(self.device)
        c1 = program.counters(self.system)
        s["warmup_s"] = lap() - t
        s["warmup_frames"] = self.warmup_frames
        s["warmup_keyframes"] = c1["keyframes"] - c0["keyframes"]
        s["warmup_captures"] = c1["captures"] - c0["captures"]
        s["setup_s"] = lap() - self.t0
        return s

    # ----------------------------------------------------------------- window

    def window(self) -> dict:
        """The measured window; returns its records."""
        sys_, traced = self.system, self.traced
        first_i = self.warmup_frames  # route index of the window's first frame
        first_id = self.next_id
        chunk = int(self.cell.get("chunk_frames", 64))
        sl = self.cell.get("trace_slice", {"start": 5, "frames": 5})
        buf = collections.deque()
        i_next = first_i
        rec = {"lat": [], "ids": [], "poses": [], "frame_stages": [], "syncs": [], "kf": [], "state": []}
        counter = trace.SyncCounter() if traced and self.device == "cuda" else None
        slice_ = trace.Slice() if traced and self.device == "cuda" else None
        if traced:
            program.set_stage_sync(sys_, True)
        stages0 = {k: len(v) for k, v in program.stage_samples(sys_).items()}
        self.counters0 = program.counters(sys_)
        self.stages0 = dict(stages0)
        if counter is not None:
            counter.__enter__()
        kf_before = program.keyframes(sys_)
        sync(self.device)
        t_start = lap()
        paused = 0.0
        k = 0
        try:
            while True:
                if not buf:
                    sync(self.device)
                    tp = lap()
                    n = min(chunk, self.route_frames - i_next)
                    if n <= 0:
                        raise RuntimeError(f"the route ran out after {i_next} frames: the program "
                                           "outran the corridor; lengthen the scene")
                    buf.extend(self.window_src.render(i_next, n))
                    i_next += n
                    sync(self.device)
                    paused += lap() - tp
                if slice_ is not None and k == int(sl["start"]):
                    tp = lap()
                    slice_.open()
                    self.slice_t = [lap()]
                    paused += lap() - tp
                views = buf.popleft()
                fid = self.next_id
                if counter is not None:
                    n_sync = len(counter.sites)
                    counter.counting = True
                a = lap()
                out = program.track(sys_, views, fid / self.fps)
                b = lap()
                if counter is not None:
                    counter.counting = False
                    rec["syncs"].append(len(counter.sites) - n_sync)
                self.next_id += 1
                rec["lat"].append(b - a)
                rec["ids"].append(fid)
                rec["poses"].append(out)
                rec["state"].append(program.state(sys_))
                kf_now = program.keyframes(sys_)
                rec["kf"].append(kf_now > kf_before)
                kf_before = kf_now
                rec["frame_stages"].append(self._new_stage_samples(stages0))
                k += 1
                if slice_ is not None and k == int(sl["start"]) + int(sl["frames"]):
                    tp = lap()
                    sync(self.device)
                    self.slice_t.append(lap())
                    slice_.close()
                    self.slice_ids = rec["ids"][int(sl["start"]):k]
                    paused += lap() - tp
                if b - t_start - paused >= self.seconds:
                    break
            sync(self.device)
            rec["window_s"] = lap() - t_start - paused
            if slice_ is not None and slice_.events is None and hasattr(self, "slice_t"):
                self.slice_t.append(lap())
                slice_.close()
                self.slice_ids = rec["ids"][int(sl["start"]):k]
        finally:
            if counter is not None:
                counter.__exit__(None, None, None)
        rec["first_id"], rec["first_i"], rec["last_i"] = first_id, first_i, first_i + k
        self.slice_ = slice_ if slice_ is not None and slice_.events is not None else None
        self.counters1 = program.counters(sys_)
        self.sync_sites = counter.sites if counter is not None else []
        return rec

    def _new_stage_samples(self, seen: dict) -> dict:
        """The stage samples the last frame added: name -> summed seconds."""
        out = {}
        for name, xs in program.stage_samples(self.system, copy=False).items():
            n0 = seen.get(name, 0)
            if len(xs) > n0:
                out[name] = float(sum(xs[n0:]))
                seen[name] = len(xs)
        return out

    # ------------------------------------------------------------- comparison

    def compare(self, rec: dict) -> tuple:
        """(numbers, informative readings) of the comparison."""
        numbers, extra = {}, {}
        epochs = _epochs(rec["state"])
        tracked = [(i, p, e) for i, p, e in zip(rec["ids"], rec["poses"], epochs) if p is not None]
        ids = np.asarray([i for i, _, _ in tracked], np.int64)
        R = np.asarray([p[0] for _, p, _ in tracked], np.float64).reshape(-1, 3, 3)
        t = np.asarray([p[1] for _, p, _ in tracked], np.float64).reshape(-1, 3)
        Rg, tg = self.truth_of(ids)
        fix = self.stereo
        n, x = correct.pose_numbers(ids, R, t, Rg, tg, float(self.route["speed"]), fix,
                                    np.asarray([e for _, _, e in tracked]))
        numbers.update(n)
        extra.update(x)
        n, x = correct.keyframe_numbers(self.map_after, rec["first_id"], self.truth_of, fix)
        numbers.update(n)
        extra["kf_n"] = x["n_kf"]
        n, x = correct.point_numbers(self.map_after, rec["first_id"], self.truth_of, self.scene, fix)
        numbers.update(n)
        extra.update(x)
        numbers.update(correct.fill_numbers(self.map_after))
        rng = np.random.default_rng([self.seed, 2])
        n_sample = min(int(self.cell.get("kernel_sample", 3)), len(rec["ids"]))
        picks = sorted(rng.choice(np.arange(rec["first_i"], rec["last_i"]), n_sample, replace=False))
        views = [self.window_src.render(int(i), 1)[0] for i in picks]
        numbers.update(correct.kernel_numbers(views, self.config["orb"], program, device=self.device))
        extra["kernel_frames"] = [int(i) for i in picks]
        return numbers, extra

    # --------------------------------------------------------------- the run

    def execute(self, smi: str) -> tuple:
        s = self.setup(smi)
        info("setup: " + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                                   for k, v in s.items()))
        rec = self.window()
        peak = torch.cuda.max_memory_allocated() if self.device == "cuda" else 0
        stages = self.window_stages()
        self.map_after = program.map_host(self.system)
        m = self.map_after
        cfg_t = self.config["tracker"]
        info(f"window: {len(rec['lat'])} frames in {rec['window_s']:.3f} s (route frames "
             f"{rec['first_i']}..{rec['last_i']} of {self.route_frames}: "
             f"{rec['last_i'] / self.route_frames:.2%} of the route used), render paused "
             f"the clock; peak memory allocated {peak} bytes; map at the end: "
             f"{int(m['kf_valid'].sum())} keyframes of {cfg_t['max_keyframes']}, "
             f"{int(m['pt_valid'].sum())} points of {cfg_t['max_points']}")
        info(f"counters before/after the window: {self.counters0} / {self.counters1}")
        lat = np.asarray(rec["lat"]) * 1e3
        kf = np.asarray(rec["kf"], bool)
        for name, sel in (("keyframe frames", kf), ("other frames", ~kf)):
            if sel.any():
                info(f"latency of {name}: n {int(sel.sum())}, p50 {np.percentile(lat[sel], 50):.3f} ms, "
                     f"p95 {np.percentile(lat[sel], 95):.3f} ms, max {lat[sel].max():.3f} ms")
        changes = [(rec["first_i"] + k, st) for k, st in enumerate(rec["state"])
                   if k == 0 or st != rec["state"][k - 1]]
        info(f"tracking state by route frame (where it changed): {changes[:40]}")
        slow = [k for k in range(len(lat)) if lat[k] > 3 * np.percentile(lat, 95)]
        for k in slow[:10]:
            top = sorted(rec["frame_stages"][k].items(), key=lambda kv: -kv[1])[:5]
            info(f"slow frame {rec['first_i'] + k}: {lat[k]:.3f} ms; stages "
                 + ", ".join(f"{n} {v * 1e3:.1f} ms" for n, v in top))
        if self.traced and self.sync_sites:
            top = collections.Counter(self.sync_sites).most_common(8)
            info(f"device->host reads in the window: {len(self.sync_sites)}; most at: {top}")
        program.free(self.system)
        numbers, extra = self.compare(rec)
        at_least = self.cell.get("at_least", {})
        ok, rows = correct.decide(numbers, self.cell["limits"], at_least)
        extra.update({k: v for k, v in numbers.items() if k not in self.cell["limits"] and k not in at_least})
        info("not compared: " + ", ".join(f"{k} {v}" for k, v in extra.items()))
        lost = sum(p is None for p in rec["poses"])
        metrics = {}
        if self.traced:
            ctx = self.layer_context(rec, stages)
            for mdef in self.man.metrics(self.cell["name"], "per_layer"):
                v = self.man.reader(mdef["name"])(ctx)
                if v is not None:
                    metrics[mdef["name"]] = {"value": float(v), "unit": mdef["unit"]}
        else:
            e2e = stats.window_metrics(rec["lat"], rec["window_s"])
            e2e["setup_s"] = s["setup_s"]
            for mdef in self.man.metrics(self.cell["name"], "end_to_end"):
                metrics[mdef["name"]] = {"value": float(e2e[mdef["name"]]), "unit": mdef["unit"]}
        dev = {"platform": "gpu",
               "kind": torch.cuda.get_device_name(0) if self.device == "cuda" else str(self.device),
               "count": int(self.cell["chips"]), "memory_peak_bytes": int(peak)}
        result = {"correct": bool(ok), "attempted": len(rec["lat"]), "failed": int(lost),
                  "metrics": metrics, "device": dev}
        if self.traced and self.slice_ is not None:
            dev["busy_s"] = self.busy_ns / 1e9
            dev["window_s"] = self.slice_wall_s
            result["breakdown"] = trace.breakdown(self.slice_.events, self.intervals, self.gaps)
        result["checks"] = {name: {"value": v, "limit": lim, "sense": sense} for name, v, lim, sense in rows}
        return result, rows

    # --------------------------------------------------------- traced readings

    def window_stages(self) -> dict:
        """name -> the stage samples (seconds) the window added."""
        now = program.stage_samples(self.system)
        return {k: v[self.stages0.get(k, 0):] for k, v in now.items() if len(v) > self.stages0.get(k, 0)}

    def layer_context(self, rec: dict, stages: dict) -> dict:
        """What the per-layer readers read."""
        ctx = {"cell": self.cell, "config": self.config, "frames": len(rec["lat"]),
               "latencies_s": rec["lat"], "counters0": self.counters0, "counters1": self.counters1,
               "stages": stages, "frame_stages": rec["frame_stages"], "syncs": rec["syncs"],
               "sync_sites": self.sync_sites, "kind": torch.cuda.get_device_name(0)}
        if self.slice_ is not None:
            self.intervals = trace.device_intervals(self.slice_.events)
            self.busy_ns, self.gaps = trace.union(self.intervals)
            self.slice_wall_s = self.slice_t[1] - self.slice_t[0]
            ctx["slice"] = {"intervals": self.intervals, "busy_ns": self.busy_ns,
                            "wall_s": self.slice_wall_s, "kernels": trace.by_name(self.intervals),
                            "bounds": self.slice_bounds(), "gaps": self.gaps}
        return ctx

    def slice_bounds(self) -> dict:
        """The kernels' bounds per launch at the slice's frames: FAST+NMS
        over each frame's pyramid with the pixels that score counted (their
        mean), the gather of B x n_features windows from the frame's
        atlas."""
        from benchmark import roofline
        from benchmark.reference import kernels as ref_k

        orb = self.config["orb"]
        kind = torch.cuda.get_device_name(0)
        fast, atlas_shape, B = [], None, 1
        for fid in self.slice_ids:
            views = self.window_src.render(fid, 1)[0]
            imgs = torch.stack([torch.from_numpy(np.ascontiguousarray(v)) for v in views]).to(self.device).float()
            B = imgs.shape[0]
            levels = ref_k.pyramid(imgs, orb["n_levels"], orb["scale_factor"])
            scoring = sum(int((ref_k.fast_score(x, orb["min_th_fast"]) > 0).sum()) for x in levels)
            fast.append(roofline.fast_bound_s([tuple(x.shape) for x in levels], scoring, kind))
            atlas_shape = tuple(ref_k.atlas(levels).shape)
        n = B * int(orb["n_features"])
        return {"fast_nms": float(np.mean(fast)),
                "gather_patches": roofline.gather_bound_s(atlas_shape, 1, n, kind)}
