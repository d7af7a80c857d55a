"""BENCHMARK.json, the files it names, and adding a cell by files alone."""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from port_bench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_every_cell_finds_its_files_by_name(bench):
    for w in bench["workloads"]:
        work, conf = spec.cell(bench, w["name"])
        assert work["name"] == w["name"]
        assert conf["name"] == w["config"]
        assert hasattr(spec.generator(work["generator"]), "run")
        conf_entry = [c for c in bench["configs"]
                      if c["name"] == w["config"]][0]
        assert conf_entry["file"] == f"port_bench/configs/{w['config']}.json"
        assert conf_entry["reduced"] == conf["reduced"]


def test_every_per_layer_metric_has_a_reader(bench):
    for m in bench["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_names_units_and_entries_keep_the_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(names)) == len(names)
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and set(m) <= {
            "name", "unit", "better", "source", "layer", "moves", "workloads"}
    for w in bench["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
        reported = spec.metrics_for(bench, w["name"], "end_to_end")
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2
        assert spec.metrics_for(bench, w["name"], "per_layer")
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) \
        < 64 * 1024


def test_a_cell_config_and_metric_are_added_by_files_alone(tmp_path):
    """A copy of the benchmark gains a configuration, a generator, a cell
    and a per-layer metric by new files and new BENCHMARK.json entries;
    the harness finds and runs them with no file edited."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(spec.ROOT, "port_bench"),
                    root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    pb = root / "port_bench"
    (pb / "configs" / "dummy_cfg.json").write_text(json.dumps(
        {"name": "dummy_cfg", "reduced": []}))
    (pb / "workloads" / "dummy_cfg.tiny.json").write_text(json.dumps(
        {"name": "dummy_cfg.tiny", "config": "dummy_cfg", "traffic": "tiny",
         "generator": "dummy_gen", "chips": 1, "why": "a test",
         "params": {"n": 3}}))
    (pb / "traffic" / "dummy_gen.py").write_text(
        "def run(ctx):\n"
        "    n = ctx.params['n']\n"
        "    return {'setup_s': 0.5, 'window_s': ctx.seconds,\n"
        "            'end_to_end': {'dummy_rate': n / ctx.seconds},\n"
        "            'attempted': n, 'failed': 0,\n"
        "            'checks': {'mismatch': (0, 0)},\n"
        "            'memory_peak_bytes': 0, 'trace': None,\n"
        "            'collected': {'things': n}}\n")
    (pb / "metrics" / "things.dummy.py").write_text(
        "def read(run):\n    return float(run['collected']['things'])\n")
    bench["configs"].append({"name": "dummy_cfg", "source": "a test",
                             "file": "port_bench/configs/dummy_cfg.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy_cfg.tiny", "config":
                               "dummy_cfg", "traffic": "tiny", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "dummy_rate", "unit": "things/s",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["dummy_cfg.tiny"]})
    bench["per_layer"].append({"name": "things.dummy", "unit": "things",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "dummy", "moves": "dummy_rate",
                               "workloads": ["dummy_cfg.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys\n"
            "from port_bench import run\n"
            "out = {}\n"
            "for trace in (False, True):\n"
            "    r, lines = run.execute('dummy_cfg.tiny', 1, 2.0, trace,\n"
            "                           backend='torch', root=sys.argv[1])\n"
            "    out[str(trace)] = r\n"
            "print(json.dumps(out))\n")
    proc = subprocess.run([sys.executable, "-c", code, str(root)],
                          cwd=root, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["False"]["metrics"] == {
        "dummy_rate": {"value": 1.5, "unit": "things/s"},
        "setup_s": {"value": 0.5, "unit": "s"}}
    assert out["True"]["metrics"] == {
        "things.dummy": {"value": 3.0, "unit": "things"}}
    assert out["True"]["correct"] is True
