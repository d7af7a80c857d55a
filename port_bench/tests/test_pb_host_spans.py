"""The program's host spans in a short traced run of the pool cell, on
the card: every host-span metric reads, and the run stays correct."""
import json
import subprocess
import sys

import pytest

from port_bench import spec

POOL = "pool4_f1.nym_w1000"
HOST_SPAN_METRICS = ["node_ms.pool", "threepc_ms.pool", "bls_ms.pool",
                     "execution_ms.pool", "durable_ms.pool", "auth_ms.pool",
                     "serde_ms.pool", "ring_ms.pool", "ring_wait_ms.pool"]


@pytest.mark.gpu
def test_a_traced_run_reads_every_host_span_metric(card):
    proc = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", POOL,
         "--seed", "3141592653589", "--seconds", "5", "--trace", "1"],
        capture_output=True, text=True, timeout=900, cwd=spec.ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["kind"] == card
    metrics = result["metrics"]
    for name in HOST_SPAN_METRICS:
        assert name in metrics, name
        assert metrics[name]["value"] > 0, name
    print(json.dumps({n: metrics[n]["value"] for n in HOST_SPAN_METRICS}))
