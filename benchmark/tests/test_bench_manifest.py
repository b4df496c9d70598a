"""BENCHMARK.json against the contract the benchmark is written to: names
and units, the keys of each entry, what each metric moves and where it is
reported, the share of four-chip cells, the time a full check takes, and
the files each entry names."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
DOC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_size():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(DOC["paths"]) <= 16
    for p in DOC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/") and ".." not in p
    assert 1 <= len(DOC["command"]) <= 32
    for word in DOC["command"]:
        assert 1 <= len(word) <= 200 and "\t" not in word and "\n" not in word
        if "/" in word:  # a file of the repo it names lies under paths
            assert any(word.startswith(p + "/") for p in DOC["paths"])


@pytest.mark.parametrize("kind", list(KEYS))
def test_entries_have_just_the_keys_shown(kind):
    for e in DOC[kind]:
        extra = set(e) - KEYS[kind] - ({"workloads"} if kind in ("end_to_end", "per_layer") else set())
        assert KEYS[kind] <= set(e) and not extra, (e["name"], extra)


def test_names_units_and_text_fields():
    names = {k: [e["name"] for e in DOC[k]] for k in KEYS}
    for k, ns in names.items():
        assert len(ns) == len(set(ns)), k
        assert all(NAME.match(n) for n in ns), ns
    metric_names = names["end_to_end"] + names["per_layer"]
    assert len(metric_names) == len(set(metric_names))
    for e in DOC["end_to_end"] + DOC["per_layer"]:
        assert UNIT.match(e["unit"]), e
        assert e["better"] in ("lower", "higher")
    for e in DOC["workloads"]:
        assert NAME.match(e["config"]) and NAME.match(e["traffic"])
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"]
    for e in DOC["configs"]:
        assert 1 <= len(e["source"]) <= 200 and len(e["reduced"]) <= 16
        assert all(NAME.match(k) for k in e["reduced"])
    for e in DOC["per_layer"]:
        assert 1 <= len(e["layer"]) <= 200 and "\n" not in e["layer"]


def test_counts_and_sources():
    assert 1 <= len(DOC["configs"]) <= 24
    assert 1 <= len(DOC["workloads"]) <= 24
    assert 1 <= len(DOC["end_to_end"]) <= 16
    assert 1 <= len(DOC["per_layer"]) <= 128
    for e in DOC["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for e in DOC["per_layer"]:
        assert e["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert any(e["name"] == "setup_s" for e in DOC["end_to_end"])


def test_four_chip_cells_and_pairs():
    cells = DOC["workloads"]
    assert all(c["chips"] in (1, 4) for c in cells)
    assert sum(c["chips"] == 4 for c in cells) <= max(1, len(cells) // 4)
    pairs = [(c["config"], c["traffic"]) for c in cells]
    assert len(pairs) == len(set(pairs))
    used = {c["config"] for c in cells}
    assert used == {c["name"] for c in DOC["configs"]}


def test_every_metric_moves_an_end_to_end_metric_its_cells_report():
    cells = {c["name"] for c in DOC["workloads"]}
    e2e = {m["name"]: m for m in DOC["end_to_end"]}

    def reported(metric, cell):
        return cell in metric.get("workloads", cells)

    for m in DOC["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert reported(e2e[m["moves"]], cell), (m["name"], cell)
    for cell in cells:
        e = [m for m in DOC["end_to_end"] if reported(m, cell)]
        assert any(m["name"] == "setup_s" for m in e) and len(e) >= 2
        assert any(reported(m, cell) for m in DOC["per_layer"])
    layers = {}
    for m in DOC["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def test_a_full_check_fits_with_24_cells():
    rs = DOC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_named_files_exist_under_paths():
    paths = DOC["paths"]
    for c in DOC["configs"]:
        assert any(c["file"].startswith(p + "/") for p in paths)
        assert (ROOT / c["file"]).is_file()
    files = [c["file"] for c in DOC["configs"]]
    assert len(files) == len(set(files))
    for w in DOC["workloads"]:
        assert (ROOT / "benchmark" / "workloads" / f"{w['name']}.json").is_file()
    for m in DOC["per_layer"]:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()


def test_each_cell_states_its_limits():
    for w in DOC["workloads"]:
        data = json.loads((ROOT / "benchmark" / "workloads" / f"{w['name']}.json").read_text())
        lim = data["limits"]
        # the frame step, the keyframe job (its keyframes and points), the kernels
        assert {"rpe_r_deg", "kf_rpe_r_deg", "pt_depth_err", "fast_diff", "patch_diff"} <= set(lim)
        assert lim["fast_diff"] == 0 and lim["patch_diff"] == 0
        assert set(data["at_least"]) == {"map_kf", "map_pt"}
