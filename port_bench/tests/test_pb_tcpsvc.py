"""The tcpsvc cell (`traffic/tcp_closed.py`): the whole deployment on the
kernels' plain versions (`service:torch`), the control and a planted
fault, each a short window; and on the card, a traced run that reads
every per-layer metric the cell adds."""
import json
import subprocess
import sys

import pytest

from port_bench import faults, spec, stores
from port_bench.run import execute

CELL = "tcpsvc_f1.nym_w300"
# the plain K3 + K4 verify a signature in ~30 ms on a CPU: few requests,
# a patient crypto host (no supervisor hedging onto the CPU verifier)
TINY = dict(presigned=400, in_flight=20, corrupt_per_1000=100,
            reference_sample=8, service_args=["--no-supervisor"])
TCPSVC_METRICS = [m["name"] for m in spec.load_benchmark()["per_layer"]
                  if m.get("workloads") == [CELL]]


def rehearse(seed, hooks=None, trace=False):
    return execute(CELL, seed, 6.0, trace, backend="torch", params=TINY,
                   hooks=hooks, workers=2)


def test_the_cell_on_the_plain_kernels_is_correct():
    result, lines = rehearse(2718281828459, trace=True)
    assert result["correct"] is True, (result["checks"], lines)
    assert result["failed"] == 0 and result["attempted"] > 0
    metrics = result["metrics"]
    # no card: the device trace's two metrics read nothing
    for name in set(TCPSVC_METRICS) - {"device_idle.tcpsvc",
                                       "ed25519_roofline.tcpsvc"}:
        assert metrics[name]["value"] > 0, name
    assert 0 < metrics["svc_cache_hit.tcpsvc"]["value"] <= 75.0


def test_untraced_it_reports_the_end_to_end_metrics():
    result, _ = rehearse(5)
    assert result["correct"] is True, result["checks"]
    assert set(result["metrics"]) == {"write_tps", "setup_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())


def test_the_control_is_not_correct():
    # seed 6 spoils S + L twins among the first 20 requests
    result, _ = rehearse(6, hooks={"built": [faults.control]})
    assert result["correct"] is False
    assert result["checks"]["forged_acked"]["value"] > 0


def test_a_state_root_changed_in_one_store_is_not_correct():
    def plant(ctx, system):
        stores.write_state_root(system["base"], system["names"][-1],
                                b"\x11" * 32)
    result, _ = rehearse(9, hooks={"stopped": [plant]})
    assert result["correct"] is False
    assert result["checks"]["state_mismatch"]["value"] == 1


@pytest.mark.gpu
def test_a_traced_run_on_the_card_reads_every_new_metric(card):
    proc = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", CELL,
         "--seed", "1618033988749", "--seconds", "10", "--trace", "1"],
        capture_output=True, text=True, timeout=900, cwd=spec.ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["kind"] == card
    metrics = result["metrics"]
    print(json.dumps({n: metrics.get(n, {}).get("value")
                      for n in TCPSVC_METRICS}))
    for name in TCPSVC_METRICS:
        assert metrics[name]["value"] > 0, name
    assert metrics["ed25519_roofline.tcpsvc"]["value"] < 100
