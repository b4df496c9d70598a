"""BENCHMARK.json and the files it names, found by name: a cell's data file
`benchmark/workloads/<cell>.json`, a configuration's `file`, a per-layer
metric's reader `benchmark/metrics/<metric>.py`. Adding a configuration, a
cell or a metric adds files and entries; no file of the harness changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


class Manifest:
    def __init__(self, root: Path = ROOT, bench_dir: Path = BENCH_DIR):
        self.root, self.bench_dir = Path(root), Path(bench_dir)
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())

    def _entry(self, key: str, name: str) -> dict:
        for e in self.doc[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"BENCHMARK.json has no {key} entry named {name!r}")

    def cell(self, name: str) -> dict:
        """The cell's BENCHMARK.json entry merged over its data file."""
        entry = self._entry("workloads", name)
        data = json.loads((self.bench_dir / "workloads" / f"{name}.json").read_text())
        return {**data, **entry}

    def config(self, name: str) -> dict:
        entry = self._entry("configs", name)
        return {**json.loads((self.root / entry["file"]).read_text()), **entry}

    def metrics(self, cell: str, kind: str) -> list:
        """The `end_to_end` or `per_layer` entries this cell reports: those
        that list it under `workloads`, and those without the key."""
        return [m for m in self.doc[kind] if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        """The per-layer metric's reader: `read(ctx)` of its own file."""
        path = self.bench_dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
