"""Configurations, cells and per-layer metrics are found by their names in
BENCHMARK.json, each in a file of its own: a new one is added by adding
files and entries, and no file that is there changes."""

import hashlib
import json
import shutil
from pathlib import Path

from benchmark import manifest

ROOT = Path(__file__).resolve().parents[2]


def _digest(d: Path) -> dict:
    return {str(p.relative_to(d)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(d.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_shipped_entries_are_found_by_name():
    man = manifest.Manifest()
    for c in man.doc["workloads"]:
        cell = man.cell(c["name"])
        assert cell["name"] == c["name"] and cell["config"] == c["config"]
        cfg = man.config(cell["config"])
        assert cfg["name"] == c["config"] and cfg["sensor"] in ("monocular", "stereo")
        assert "camera" in cfg and "orb" in cfg and "tracker" in cfg
    for m in man.doc["per_layer"]:
        assert callable(man.reader(m["name"]))


def test_a_new_config_cell_and_metric_by_adding_files_only(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", bench, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digest(bench)

    cfg = json.loads((bench / "configs" / "kitti_stereo.json").read_text())
    cfg["orb"]["n_features"] = 1200
    cfg["camera"].update(fx=435.2, fy=435.2, cx=367.5, cy=252.2, bf=47.9, width=752, height=480)
    (bench / "configs" / "euroc_stereo.json").write_text(json.dumps(cfg))
    wl = json.loads((bench / "workloads" / "kitti_stereo.drive.json").read_text())
    wl["config"] = "euroc_stereo"
    (bench / "workloads" / "euroc_stereo.drive.json").write_text(json.dumps(wl))
    (bench / "metrics" / "frames_in_window.py").write_text(
        "def read(ctx):\n    return ctx['frames']\n")

    doc = json.loads((tmp_path / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "euroc_stereo", "source": "https://example.org/EuRoC.yaml",
                           "file": "benchmark/configs/euroc_stereo.json", "reduced": [], "why": "a test"})
    doc["workloads"].append({"name": "euroc_stereo.drive", "config": "euroc_stereo", "traffic": "drive",
                             "chips": 1, "why": "a test"})
    doc["per_layer"].append({"name": "frames_in_window", "unit": "frames", "better": "higher",
                             "source": "host_clock", "layer": "System / Tracker", "moves": "frames_per_s",
                             "workloads": ["euroc_stereo.drive"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))

    man = manifest.Manifest(root=tmp_path, bench_dir=bench)
    cell = man.cell("euroc_stereo.drive")
    assert man.config(cell["config"])["orb"]["n_features"] == 1200
    names = [m["name"] for m in man.metrics("euroc_stereo.drive", "per_layer")]
    assert names == ["frames_in_window"]
    assert man.reader("frames_in_window")({"frames": 7}) == 7
    assert "frames_in_window" not in [m["name"] for m in man.metrics("kitti_stereo.drive", "per_layer")]
    after = _digest(bench)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {"configs/euroc_stereo.json", "workloads/euroc_stereo.drive.json",
                                        "metrics/frames_in_window.py"}


def test_a_reader_that_finds_nothing_returns_nothing():
    man = manifest.Manifest()
    empty = {"frames": 0, "frame_stages": [], "stages": {}, "syncs": [],
             "counters0": {"keyframes": 0, "captures": 0}, "counters1": {"keyframes": 0, "captures": 0}}
    for name in ("fast_nms_roofline", "gather_patches_roofline", "device_idle_pct", "track_step_ms",
                 "mapping_front_ms", "local_ba_ms", "loop_detect_ms", "reads_per_frame",
                 "keyframe_share_pct"):
        assert man.reader(name)(empty) is None, name
