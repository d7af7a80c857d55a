"""The card's tools on the CPU: tools/gpu_probe.py, tools/gpu_microbench.py
and tools/multichip.py, the GPU counterparts of the reference's TPU tools
(tpu_probe, tpu_microbench, multichip). Here they run on `--backend
torch` (the kernels' plain versions) with small batches: the microbench's
verdicts, negative control and leaf digests; the multi-lane harness's
correctness wave through every lane and its fail-closed rerun after a
dead child (the build directory purged, the row tagged `rebuilt`, never
a CPU fallback); and the probe answering in bounded time on a machine
with no card, without initialising CUDA."""
from __future__ import annotations

import json
import os
import stat
import subprocess
import sys
import time

import pytest

from plenum_tpu_torch.tools import gpu_microbench, gpu_probe, multichip

from test_torch_pool import one_torch_thread  # noqa: F401 (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lines(capsys) -> list[dict]:
    return [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]


@pytest.mark.usefixtures("one_torch_thread")
def test_microbench_on_the_plain_kernels(capsys):
    """Two verify batches and the leaf hash: every verdict true, the
    corrupted signature the only false one, every leaf digest hashlib's;
    one JSON line each and a summary, rc 0."""
    rc = gpu_microbench.main(["--backend", "torch", "--batches", "4,2",
                              "--sha-batch", "8", "--reps", "1"])
    rows = _lines(capsys)
    assert rc == 0, rows
    header, ed4, ed2, sha, summary = rows
    assert header["device"] == "cpu" and header["backend"] == "torch"
    for row, batch in ((ed4, 4), (ed2, 2)):
        assert row["kernel"] == "ed25519_verify" and row["batch"] == batch
        assert row["negative_control"] == "one verdict flipped"
        assert row["sigs_per_s_best"] > 0
        assert row["k4_launches"] == 0        # CPU tensors never count
    assert sha["kernel"] == "sha256_leaves" and sha["leaves_match_hashlib"]
    assert summary["errors"] == [] and set(summary["ed25519"]) == {"4", "2"}


@pytest.mark.usefixtures("one_torch_thread")
def test_microbench_negative_control_fails_closed(monkeypatch, capsys):
    """A verifier that passes a corrupted signature fails the batch and
    the run's rc (2), as the reference's microbench does."""
    import numpy as np

    from plenum_tpu_torch.crypto import ed25519

    class Lenient:
        def verify_batch(self, items):
            return np.ones(len(items), dtype=bool)

    monkeypatch.setattr(ed25519, "make_verifier",
                        lambda backend, **kw: Lenient())
    row = gpu_microbench.bench_ed25519(2, reps=1, backend="torch")
    assert row == {"error": "negative control failed at batch 2"}
    rc = gpu_microbench.main(["--backend", "torch", "--batches", "2",
                              "--sha-batch", "4", "--reps", "1"])
    assert rc == 2
    assert _lines(capsys)[-1]["errors"] == [
        "negative control failed at batch 2"]


def test_multichip_two_lanes_on_the_plain_kernels():
    """The harness's child drives two CPU lanes: the correctness wave
    hits every lane with the corrupted signature caught, the flood
    settles items on both, the commit wave's roots are hashlib's, and no
    lane's supervisor sent anything off its device."""
    row = multichip.run_harness(2, bucket=2, seconds=0.3, timeout=300.0,
                                backend="torch")
    assert row["ok"], row
    assert row["torch_source"] == "torch-cpu" and row["rc"] == 0
    assert row["lanes_ok"] and row["cmt_ok"]
    assert set(row["per_device_dispatches"]) == {"lane0", "lane1"}
    assert all(n > 0 for n in row["per_device_dispatches"].values())
    assert row["off_device_batches"] == {"lane0": 0, "lane1": 0}
    assert row["flood_items_per_s"] > 0


def test_multichip_reruns_on_a_purged_build_after_the_child_dies(
        monkeypatch, tmp_path):
    """A child that died: the build directory is purged and the step runs
    once more on the same backend (a stub child here; the test above
    runs a real one); the row is that rerun's, tagged `rebuilt`, with
    the first attempt recorded. A rerun that fails too fails the row."""
    build = tmp_path / "build"
    build.mkdir()
    (build / "libed25519-stale.so").write_bytes(b"\0")
    calls = []

    def dies_first(n, bucket, seconds, timeout, backend):
        calls.append((backend, build.exists()))
        if len(calls) == 1:
            return {"rc": -11, "tail": "Segmentation fault",
                    "error": "no measured output"}
        return {"rc": 0, "tail": "", "ok": True, "n_devices": n}

    monkeypatch.setattr(multichip, "_run_step", dies_first)
    row = multichip.run_harness(2, bucket=2, seconds=0.2, timeout=300.0,
                                backend="torch", build_dir=str(build))
    # the rerun on the same backend, after the purge: never the CPU
    assert calls == [("torch", True), ("torch", False)]
    assert row["ok"] and row["torch_source"] == "rebuilt"
    assert row["build_purged"] and not build.exists()
    assert row["first_attempt"]["rc"] == -11

    monkeypatch.setattr(multichip, "_run_step",
                        lambda *a: {"rc": 1, "tail": "", "ok": False})
    row = multichip.run_harness(2, bucket=2, seconds=0.2, timeout=300.0,
                                backend="torch", build_dir=str(build))
    assert not row["ok"] and row["torch_source"] == "rebuilt"


def _fake_smi(tmp_path, body: str) -> str:
    path = tmp_path / "nvidia-smi"
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(tmp_path)


def test_probe_answers_in_bounded_time_without_a_card(monkeypatch,
                                                      tmp_path):
    """No nvidia-smi (this machine), one that hangs, and one that answers:
    each within the timeout, the hung one named as such."""
    monkeypatch.setenv("PATH", str(tmp_path / "none"))
    out = gpu_probe.probe_gpu(timeout=2.0)
    assert not out["up"] and out["error"] == "nvidia-smi not found"

    monkeypatch.setenv("PATH", _fake_smi(tmp_path, "exec sleep 30\n")
                       + os.pathsep + "/bin:/usr/bin")
    t0 = time.monotonic()
    out = gpu_probe.probe_gpu(timeout=1.0)
    assert time.monotonic() - t0 < 5.0
    assert not out["up"] and "no answer" in out["error"]

    monkeypatch.setenv("PATH", _fake_smi(
        tmp_path, 'echo "NVIDIA H100 80GB HBM3, 700.00 W, 81559 MiB, '
                  '0 MiB, 0 %"\n') + os.pathsep + "/bin:/usr/bin")
    out = gpu_probe.probe_gpu(timeout=5.0)
    assert out["up"] and out["gpus"][0]["name"] == "NVIDIA H100 80GB HBM3"
    assert out["gpus"][0]["power.limit"] == "700.00 W"


def test_probe_never_initialises_cuda():
    """The probe's process imports no torch: it cannot create a context,
    and its rc says the card is down here."""
    code = ("import sys\n"
            "from plenum_tpu_torch.tools import gpu_probe\n"
            "rc = gpu_probe.main()\n"
            "assert 'torch' not in sys.modules\n"
            "sys.exit(rc)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == (0 if gpu_probe.probe_gpu()["up"] else 1), \
        out.stderr
    assert " gpu " in out.stdout
