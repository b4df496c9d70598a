"""The control of `correct`: the plain reference put in the program's place
and computed in bfloat16, the precision below the float32 the
configurations state, held to the same comparison and the cell's limits.
It has to come out not correct. The benchmark's own runs do not run it.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --frames 170 --kf-every 8

- poses: the route's poses computed in bfloat16 (benchmark/traffic/
  routes.py with dtype bfloat16) at the frame ids a window of `--frames`
  frames after the warm-up holds, against the float64 truth;
- keyframes: the same at every `--kf-every`-th of those frames;
- points: surface points each such keyframe sees, made in bfloat16 from
  their true pixels: from a stereo keyframe's disparity, or triangulated
  with the next keyframe;
- the kernels: the reference's pyramid, FAST+NMS and atlas in bfloat16
  on the cell's frames, against the float32 reference.
Prints one line per seed with each number beside its limit, then a JSON
line of all readings.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import correct, manifest  # noqa: E402
from benchmark.reference import points as ref_pt  # noqa: E402
from benchmark.traffic import routes  # noqa: E402
from benchmark.traffic.frames import FrameSource  # noqa: E402
from benchmark.traffic.scene import Corridor  # noqa: E402


def readings(man, cell: dict, seed: int, n_frames: int, kf_every: int, device="cuda") -> dict:
    """The control's numbers of one seed at the cell's size."""
    config = man.config(cell["config"])
    stereo = config["sensor"] == "stereo"
    route, first = cell["route"], int(cell["warmup"]["min_frames"])
    ids = np.arange(first, first + n_frames)
    Rg, tg = routes.poses(route, ids)
    Rb, tb = routes.poses(route, ids, dtype=torch.bfloat16)
    out, _ = correct.pose_numbers(ids, Rb, tb, Rg, tg, float(route["speed"]), stereo)
    kf = ids[::kf_every]
    R, t = routes.poses(route, kf, dtype=torch.bfloat16)
    fake = {"kf_valid": np.ones(len(kf), bool), "kf_frame_id": kf, "kf_R": R, "kf_t": t}
    n, _ = correct.keyframe_numbers(fake, first, lambda f: routes.poses(route, f), stereo)
    out.update(n)
    scene = Corridor(seed, device=device, **cell["scene"])
    cam = config["camera"]
    fake.update(_points(scene, cam, route, kf, stereo, seed))
    n, _ = correct.point_numbers(fake, first, lambda f: routes.poses(route, f), scene, stereo)
    out.update(n)
    src = FrameSource(scene, cam, route, cam["bf"] / cam["fx"] if stereo else 0.0)
    rng = np.random.default_rng([seed, 2])
    picks = sorted(rng.choice(ids, min(int(cell.get("kernel_sample", 3)), len(ids)), replace=False))
    views = [src.render(int(i), 1)[0] for i in picks]
    out.update(correct.kernel_numbers(views, config["orb"], None, torch.bfloat16, device))
    return out


def _points(scene, cam: dict, route: dict, kf, stereo: bool, seed: int, n: int = 300) -> dict:
    """The control's points: n surface points seen by each keyframe, made
    in bfloat16 from their true pixels (float64), with the keyframe's pose
    in bfloat16 too: from the disparity of the keyframe's left and right
    images (stereo), or triangulated with the next keyframe (monocular)."""
    rng = np.random.default_rng([seed, 3])
    Rg, tg = routes.poses(route, kf)
    Rb, tb = routes.poses(route, kf, dtype=torch.bfloat16)
    xyz, obs, n_pts = [], np.full((len(kf), n), -1, np.int64), 0
    for k in range(len(kf) - (0 if stereo else 1)):
        X = ref_pt.surface_points(Rg[k], tg[k], cam, scene.depths, scene.x_lo, scene.band, n, rng)
        uv1 = ref_pt.project(Rg[k], tg[k], X, cam)
        if stereo:
            u2 = ref_pt.project(Rg[k], tg[k] - np.float64([cam["bf"] / cam["fx"], 0.0, 0.0]), X, cam)[:, 0]
            Xb = ref_pt.stereo_points(Rb[k], tb[k], uv1, u2, cam, torch.bfloat16)
        else:
            uv2 = ref_pt.project(Rg[k + 1], tg[k + 1], X, cam)
            Xb = ref_pt.triangulate(Rb[k], tb[k], Rb[k + 1], tb[k + 1], uv1, uv2, cam, torch.bfloat16)
        obs[k, :len(Xb)] = n_pts + np.arange(len(Xb))
        xyz.append(Xb)
        n_pts += len(Xb)
    pts = np.concatenate(xyz)
    return {"kf_obs_pt": obs, "pt_xyz": pts, "pt_valid": np.ones(len(pts), bool)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--frames", type=int, required=True, help="frames a window compares")
    ap.add_argument("--kf-every", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    man = manifest.Manifest()
    cell = man.cell(args.workload)
    limits = cell["limits"]
    allr = {}
    for seed in [int(s) for s in args.seeds.split(",")]:
        r = readings(man, cell, seed, args.frames, args.kf_every)
        allr[seed] = r
        failed = [k for k, v in r.items() if k in limits and not v <= limits[k]]
        print(f"control seed {seed}: " + ", ".join(f"{k} {v!r} (limit {limits.get(k)!r})" for k, v in r.items())
              + f"; fails {failed}; correct {not failed}", flush=True)
    print(json.dumps({"workload": args.workload, "control": allr}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
