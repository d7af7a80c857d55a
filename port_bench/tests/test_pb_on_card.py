"""One short run of each cell through the command, on the card."""
import json
import subprocess
import sys

import pytest

from port_bench import spec


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  spec.load_benchmark()["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card_is_correct(card, cell, trace):
    proc = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", cell,
         "--seed", "2718281828459", "--seconds", "3", "--trace", str(trace)],
        capture_output=True, text=True, timeout=900, cwd=spec.ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["kind"] == card
    assert result["device"]["torch_source"] == "cuda"
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert result["breakdown"]["device_ops"]
