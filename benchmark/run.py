"""The benchmark of the PyTorch and CUDA port (`tpuslam_torch`): one cell
of BENCHMARK.json, one process, one card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

1. set-up: imports the port and builds its kernels (tpuslam_torch/_build.py,
   whose build directory inside the checkout is the compile cache), makes
   the corridor scene and the route from the seed, builds the System of the
   cell's configuration, loads the vocabulary, builds the map where the
   cell drives a mapped route, and warms up along the route until every
   graph the traffic uses has been captured;
2. the window: a closed loop with one camera, as ORB-SLAM2's examples feed
   a dataset faster than real time. Each frame goes to System.track_*
   as host uint8 arrays; the next goes when the pose is back on the host;
   the device is synchronised once at the end, which ends the window. The
   frames are rendered in chunks with the clock stopped, the device
   synchronised around each chunk;
3. `correct`: every pose of the window, the keyframes the window made and
   the points they see, the map's fill, and, in a pass of their own, the
   kernels' outputs on a sample of the window's frames, against the plain
   reference (benchmark/correct.py);
4. the result: the last line of standard output, one JSON object; the
   numbers compared, each beside its limit, are the last lines of standard
   error.

With --trace 1 the tracker's stage timers hold device time (stage_sync on
for the whole window), the device->host reads of every frame are counted,
a profiler slice covers a fixed run of frames after the window's first, and
the metrics are the cell's per-layer metrics. Without a CUDA card, or with
fewer cards than the cell asks for, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "tpuslam")
HOST_THREADS = 1


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc), so that set-up
    counts the interpreter's own start."""
    try:
        start_ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T0 = time.perf_counter() - process_age_s()


def info(msg: str) -> None:
    print(msg, flush=True)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (the port's own name begins with the JAX package's)."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def smi_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv=None) -> int:
    args = parse(argv)
    # Load from one process with few threads: the host's cores are shared,
    # and pools as wide as the machine make the frame's host work wait for
    # cores that other work holds. Set before numpy and torch start theirs.
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(HOST_THREADS)
    import torch

    torch.set_num_threads(HOST_THREADS)

    from benchmark import manifest

    man = manifest.Manifest()
    cell = man.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: cell {args.workload} needs {cell['chips']} CUDA card(s), found {n}; "
              "no result", file=sys.stderr)
        return 2
    from benchmark.session import Run

    run = Run(man, cell, args.seed, args.seconds, bool(args.trace), T0)
    result, rows = run.execute(smi_line())
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: modules of JAX or the JAX package loaded: {bad}; no result", file=sys.stderr)
        return 3
    for name, value, limit, sense in rows:
        print(f"check {name} {value!r} limit {limit!r} ({sense.replace('_', ' ')})", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
