"""Spreads of sets of runs and the bounds they give, from the runs'
result lines.

    python3 benchmark/bounds.py SET_A.jsonl SET_B.jsonl [...]

Each file holds the result lines (one JSON object each, as run.py prints
them last) of one set of runs of one cell, the same seeds in every set.
For each end-to-end metric it prints each set's median and spread (the
distance between the first and third quartile over the median,
statistics.quantiles with n=4), the wider spread, five times it as the
bound (never under 1%), and the check's tightness reading (the mean of the
sets' spreads, each set without its run farthest from its median).
"""

from __future__ import annotations

import json
import statistics
import sys

from stats import spread


def load(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip().startswith("{")]


def without_farthest(xs: list) -> list:
    med = statistics.median(xs)
    far = max(range(len(xs)), key=lambda i: abs(xs[i] - med))
    return [x for i, x in enumerate(xs) if i != far]


def report(sets: list) -> dict:
    names = sorted(set().union(*(r["metrics"] for s in sets for r in s)))
    out = {}
    for name in names:
        vals = [[r["metrics"][name]["value"] for r in s if name in r["metrics"]] for s in sets]
        meds = [statistics.median(v) for v in vals]
        spreads = [spread(v) for v in vals]
        widest = max(spreads)
        out[name] = {"medians": meds, "spreads": spreads, "bound": max(0.01, 5 * widest),
                     "tightness": statistics.mean(spread(without_farthest(v)) for v in vals),
                     "sets_differ_by": abs(meds[1] - meds[0]) / meds[0] if len(meds) > 1 else 0.0}
    return out


if __name__ == "__main__":
    for name, r in report([load(p) for p in sys.argv[1:]]).items():
        print(name, json.dumps(r))
