"""Each generator rehearsed on the kernels' plain versions (CPU), the
acknowledgement rule, the last line, and `correct` under the control and
the planted faults."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from port_bench import faults, importcheck, spec
from port_bench.run import execute
from port_bench.traffic.pool_closed import Answers

POOL = "pool4_f1.nym_w1000"
TINY = {
    POOL: dict(presigned=600, in_flight=20, corrupt_per_1000=200,
               reference_sample=8,
               program_overrides={"PIPELINE_MIN_BUCKET": 8}),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain kernels' small tensors only oversubscribe a host that
    runs tests side by side: one intra-op thread, restored after."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _patient(ctx, system):
    """The ring's supervisor given deadlines the CPU's plain kernels keep,
    so that a slow test host reads as slow and not as a hedge off the
    card (`off_card_waves`)."""
    from plenum_tpu_torch.parallel.supervisor import find_supervisor
    if system.get("pipe") is not None:
        budget = find_supervisor(system["pipe"]._ed_inner).budget
        budget.base = budget.min_s = 60.0


def rehearse(cell, seed=5, hooks=None, trace=False):
    built = [_patient] + list((hooks or {}).get("built", ()))
    # the pool's first 3PC batches take seconds on the plain kernels
    return execute(cell, seed, 8.0, trace, backend="torch",
                   params=TINY[cell], hooks={"built": built}, workers=2)


def test_a_write_is_acknowledged_by_f_plus_1_matching_replies():
    a = Answers(quorum=2)
    a.reply(7, "Node1", (12, 1000), 1.0)
    assert 7 not in a.answer
    a.reply(7, "Node1", (12, 1000), 1.5)        # the same node again
    assert 7 not in a.answer
    a.reply(7, "Node2", (13, 1000), 2.0)        # disagrees on seqNo
    assert 7 not in a.answer
    a.reply(7, "Node3", (12, 1000), 3.0)
    assert a.answer[7] == ("ack", 12, 3.0)
    a.reply(7, "Node4", (12, 1000), 4.0)        # settled once
    assert a.answer[7] == ("ack", 12, 3.0)
    a.nack(8, "Node1", 1.0)
    a.nack(8, "Node2", 2.0)
    assert a.answer[8] == ("nack", 2.0)


@pytest.mark.parametrize("cell", [POOL])
def test_rehearsal_is_correct_and_prints_the_contracts_line(cell):
    result, lines = rehearse(cell)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    bench = spec.load_benchmark()
    want = {m["name"] for m in spec.metrics_for(bench, cell, "end_to_end")}
    assert set(result["metrics"]) == want
    assert all(m["value"] > 0 for m in result["metrics"].values()), lines
    assert all(set(c) == {"value", "limit"}
               for c in result["checks"].values())
    assert lines[-len(result["checks"]):] == [
        f"check {k}: {c['value']} (limit {c['limit']})"
        for k, c in result["checks"].items()]


@pytest.mark.parametrize("cell", [POOL])
def test_the_control_is_not_correct(cell):
    # seed 6: three of the pool's first 20 requests (sent at once) are
    # S + L twins
    result, _ = rehearse(cell, seed=6, hooks={"built": [faults.control]})
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", [POOL])
def test_a_planted_fault_is_not_correct(cell, fault):
    result, _ = rehearse(cell, seed=9,
                         hooks={"built": [faults.FAULTS[fault]]})
    assert result["correct"] is False, (fault, result["checks"])


def test_the_import_check_compares_whole_top_level_names():
    assert importcheck.forbidden_loaded(
        ["plenum_tpu_torch", "plenum_tpu_torch.ops", "jaxtyping"]) == []
    assert importcheck.forbidden_loaded(
        ["plenum_tpu.ops.ed25519", "jaxlib.xla", "numpy"]) == [
            "jaxlib", "plenum_tpu"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import json\n"
            "from port_bench import importcheck\n"
            "from port_bench.run import execute\n"
            f"execute({POOL!r}, 3, 2.0, False, backend='torch', "
            f"params={TINY[POOL]!r}, workers=1)\n"
            "print(json.dumps(importcheck.forbidden_loaded()))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=spec.ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_without_a_card_the_command_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", POOL,
         "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
        timeout=300, cwd=spec.ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copytree(os.path.join(spec.ROOT, "port_bench"),
                    tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", POOL,
         "--seed", "1", "--seconds", "1"], capture_output=True,
        text=True, timeout=300, cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert proc.returncode != 0 and proc.stdout.strip() == ""
