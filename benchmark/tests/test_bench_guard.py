"""What a run refuses to do: run without a card, run where the program is
missing, or print a result with JAX or the JAX package loaded (top-level
module names compared whole: the port's name begins with the JAX
package's). The reference and the traffic import nothing of the program."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "benchmark"))
import run as run_mod  # noqa: E402


@pytest.mark.parametrize("names, found", [
    (["tpuslam_torch", "tpuslam_torch.pipeline.system", "numpy"], []),
    (["tpuslam", "tpuslam_torch"], ["tpuslam"]),
    (["jax.numpy", "jaxlib.xla_client"], ["jax", "jaxlib"]),
    (["flax.linen", "tpuslam.ops.orb"], ["flax", "tpuslam"]),
    (["jaxtyping", "tpuslamx", "flaxen"], []),
])
def test_forbidden_modules_by_whole_top_level_name(monkeypatch, names, found):
    for n in list(sys.modules):
        if n.split(".")[0] in ("jax", "jaxlib", "flax", "tpuslam"):
            monkeypatch.delitem(sys.modules, n)
    for n in names:
        monkeypatch.setitem(sys.modules, n, object())
    assert run_mod.forbidden_modules() == found


def _run(cwd: Path, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "kitti_stereo.drive",
                           "--seed", "4000000007", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def _no_result(p):
    lines = p.stdout.strip().splitlines()
    return p.returncode != 0 and not (lines and lines[-1].startswith("{"))


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the run without one")
    p = _run(ROOT)
    assert _no_result(p) and "CUDA card" in p.stderr


def test_only_the_benchmark_no_result(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = dict(os.environ, PYTHONPATH="")
    p = _run(tmp_path, env)
    assert _no_result(p)


@pytest.mark.parametrize("module", ["benchmark.reference.kernels", "benchmark.reference.poses",
                                    "benchmark.correct", "benchmark.traffic.scene",
                                    "benchmark.traffic.routes", "benchmark.roofline"])
def test_the_yardstick_imports_nothing_of_the_program(module):
    code = (f"import sys, json; import {module}; "
            "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    top = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "tpuslam", "tpuslam_torch"}, top


def test_nothing_reads_the_old_bench():
    for p in (ROOT / "benchmark").rglob("*.py"):
        if "tests" in p.parts:
            continue
        text = p.read_text()
        assert "bench.py" not in text and "BENCH_r" not in text and "BASELINE.json" not in text, p
