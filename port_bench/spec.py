"""Finding a cell, its configuration, its generator and its metrics by name."""
from __future__ import annotations

import importlib.util
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


class SpecError(Exception):
    """BENCHMARK.json or a file it names is missing or inconsistent."""


def load_benchmark(root: str = ROOT) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    try:
        with open(path) as fh:
            return json.load(fh)
    except OSError as exc:
        raise SpecError(f"no BENCHMARK.json at {root}: {exc}") from None


def _load_json(root: str, kind: str, name: str) -> dict:
    path = os.path.join(root, "port_bench", kind, name + ".json")
    try:
        with open(path) as fh:
            return json.load(fh)
    except OSError as exc:
        raise SpecError(f"{kind} {name!r}: {exc}") from None


def cell(bench: dict, name: str, root: str = ROOT) -> tuple[dict, dict]:
    """-> (the cell's workload file, its configuration file), each checked
    against its BENCHMARK.json entry."""
    entries = [w for w in bench.get("workloads", []) if w["name"] == name]
    if len(entries) != 1:
        raise SpecError(f"workload {name!r} is not in BENCHMARK.json")
    entry = entries[0]
    work = _load_json(root, "workloads", name)
    conf = _load_json(root, "configs", entry["config"])
    for key in ("config", "traffic", "chips"):
        if work.get(key) != entry[key]:
            raise SpecError(f"workload {name!r}: {key} is {work.get(key)!r} "
                            f"in its file and {entry[key]!r} in "
                            "BENCHMARK.json")
    if conf.get("name") != entry["config"]:
        raise SpecError(f"configuration file of {entry['config']!r} names "
                        f"{conf.get('name')!r}")
    return work, conf


def metrics_for(bench: dict, name: str, kind: str) -> list[dict]:
    """The `end_to_end` or `per_layer` entries that the cell reports: those
    without a `workloads` key and those that list it."""
    return [m for m in bench.get(kind, [])
            if "workloads" not in m or name in m["workloads"]]


def generator(name: str):
    """The traffic generator module `port_bench/traffic/<name>.py`."""
    return importlib.import_module(f"port_bench.traffic.{name}")


def reader(name: str, root: str = ROOT):
    """`read(run) -> float | None` of `port_bench/metrics/<name>.py`."""
    path = os.path.join(root, "port_bench", "metrics", name + ".py")
    if not os.path.exists(path):
        raise SpecError(f"per-layer metric {name!r} has no reader at {path}")
    mod_name = "port_bench_metric_" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod.read
