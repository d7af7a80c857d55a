"""MULTICHIP harness: the N-lane crypto-plane run that must never crash or
blank a column.

The measured step runs in a SUBPROCESS, so a card fault (a kernel that
traps, a context that dies, a library built for another machine) takes
the child and not the caller. If the child dies or reports a failed
row, the harness purges the port's kernel build directory and runs the
step once more, so every kernel is rebuilt from the sources in the
checkout; that row is tagged `torch_source: rebuilt`, a measured number
with its provenance named. It never falls back to the CPU: a "cuda" run
stays on the card.

The measured step drives the multi-device pipeline
(`make_multidevice_pipeline`): one breakable supervised lane per device
("cuda": N lanes wrapped onto this host's cards; "torch": N CPU lanes of
the kernels' plain versions), a correctness wave of real signatures
through EVERY lane (one corrupted signature each), then a timed flood
whose aggregate wave throughput and PER-LANE dispatch counts are the
row, and a two-level sha3 commit wave on the ring's cmt lane. Run:

    python -m plenum_tpu_torch.tools.multichip --devices 4 [--backend torch]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_INNER = r"""
import json, os, sys, time

from plenum_tpu_torch.config import Config
from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
from plenum_tpu_torch.parallel.pipeline import make_multidevice_pipeline

backend = %(backend)r
out = {"n_devices": %(n)d, "backend": backend}
if backend == "cuda":
    import torch
    from plenum_tpu_torch import ops
    out["devices_seen"] = torch.cuda.device_count()
    out["device"] = torch.cuda.get_device_name(0)
    devices = None
else:
    out["devices_seen"] = %(n)d
    out["device"] = "cpu"
    devices = ["cpu"] * %(n)d
cfg = Config(PIPELINE_MIN_BUCKET=%(bucket)d, PIPELINE_MAX_BUCKET=%(bucket)d,
             PIPELINE_FLUSH_WAIT=0.0)
t0 = time.perf_counter()
pipe = make_multidevice_pipeline(cfg, %(n)d, min_batch=1, devices=devices)
pipe.prewarm([%(bucket)d])
pipe.prewarm_cmt([4])        # the cmt ladder the commit wave below rides
pipe.pin()
out["warmup_s"] = round(time.perf_counter() - t0, 1)
if backend == "cuda":
    out["build"] = ops.build_preflight()

# correctness wave through EVERY lane: real signatures, every verdict
# checked (the dryrun acceptance, per lane). Content is UNIQUE PER LANE
# — the ring's verdict cache is shared, so repeating one item set would
# settle lanes 1..N-1 from lane 0's cached verdicts and never test
# their devices at all
signer = Ed25519Signer(seed=b"multichip-harness".ljust(32, b"\0"))
lanes_ok = True
for lane in range(len(pipe.lanes)):
    msgs = [b"mc-l%%d-%%d" %% (lane, i) for i in range(4)]
    good = [(m, signer.sign(m), signer.verkey) for m in msgs]
    bad = [(b"forged-l%%d" %% lane, signer.sign(msgs[0]), signer.verkey)]
    disp_before = pipe.lanes[lane].stats["dispatches"]
    got = pipe.collect_verify(
        pipe.submit_verify(good + bad, lane=lane), wait=True)
    if list(got) != [True] * 4 + [False]:
        lanes_ok = False
    if pipe.lanes[lane].stats["dispatches"] <= disp_before:
        lanes_ok = False        # the wave must have HIT this lane
out["lanes_ok"] = lanes_ok

# timed flood: unique well-formed content (the kernel's work does not
# depend on verdict), ring-placed across all lanes, double-buffered
import random
rng = random.Random(7)
def junk(k):
    return [(rng.randbytes(16), rng.randbytes(63) + b"\x00",
             rng.randbytes(32)) for _ in range(k)]
deadline = time.perf_counter() + %(seconds)f
settled = 0
toks = []
while time.perf_counter() < deadline:
    toks.append(pipe.submit_verify(junk(%(bucket)d)))
    pipe.service()
    while len(toks) > 2 * len(pipe.lanes):
        tok = toks.pop(0)
        if pipe.collect_verify(tok, wait=True) is not None:
            settled += %(bucket)d
t_flood0 = time.perf_counter()
for tok in toks:
    if pipe.collect_verify(tok, wait=True) is not None:
        settled += %(bucket)d
elapsed = %(seconds)f + (time.perf_counter() - t_flood0)
out["flood_items_per_s"] = round(settled / elapsed, 1)
out["per_device_dispatches"] = {
    "lane%%d" %% d["lane"]: d["dispatches"] for d in pipe.device_state()}

# commitment lane: a two-level commit wave (hlev sha3 jobs — the MPT
# node-hash levels a state recommit stages) rides the SAME ring, its
# roots held to a host-computed reference
import hashlib
from plenum_tpu_torch.parallel.commit_wave import CommitWave
def _cmt_family(tag):
    def gen():
        msgs = tuple(b"mc-cmt-%%d-%%d" %% (tag, j) for j in range(8))
        (lvl1,) = yield [("hlev", "sha3", msgs)]
        (root,) = yield [("hlev", "sha3", (b"".join(lvl1),))]
        return root[0]
    return gen()
def _cmt_expect(tag):
    msgs = [b"mc-cmt-%%d-%%d" %% (tag, j) for j in range(8)]
    lvl1 = b"".join(hashlib.sha3_256(m).digest() for m in msgs)
    return hashlib.sha3_256(lvl1).digest()
cwave = CommitWave(pipe)
for fam in range(3):
    cwave.add("fam%%d" %% fam, _cmt_family(fam))
roots = cwave.run()
out["cmt"] = {"waves": pipe.stats["cmt_waves"],
              "levels": pipe.stats["cmt_levels"],
              "items": pipe.stats["cmt_items"],
              "host_fallbacks": pipe.stats["cmt_host_fallbacks"]}
cmt_ok = (all(roots.get("fam%%d" %% f) == _cmt_expect(f)
              for f in range(3))
          and pipe.stats["cmt_waves"] >= 1
          and pipe.stats["cmt_levels"] >= 2
          and pipe.stats["cmt_host_fallbacks"] == 0)
out["cmt_ok"] = cmt_ok
# every lane's supervisor kept its waves on its device
from plenum_tpu_torch.parallel.supervisor import find_supervisor
off_device = {}
for lane in pipe.lanes:
    sup = find_supervisor(lane.inner)
    off_device["lane%%d" %% lane.idx] = sum(sup.stats[k] for k in (
        "fallback_batches", "hedge_wins", "open_circuit_fallbacks",
        "device_errors", "deadline_misses"))
out["off_device_batches"] = off_device
out["unpinned_shapes"] = pipe.stats["unpinned_shapes"]
out["ok"] = bool(lanes_ok and settled > 0 and cmt_ok
                 and pipe.stats["unpinned_shapes"] == 0
                 and not any(off_device.values()))
pipe.close()
print(json.dumps(out))
"""


def _run_step(n_devices: int, bucket: int, seconds: float,
              timeout: float, backend: str) -> dict:
    code = _INNER % {"n": n_devices, "bucket": bucket, "seconds": seconds,
                     "backend": backend}
    env = dict(os.environ, PYTHONPATH=REPO)
    if backend != "cuda":
        env["CUDA_VISIBLE_DEVICES"] = ""
    try:
        proc = subprocess.run([sys.executable, "-c", code],
                              capture_output=True, text=True,
                              timeout=timeout, env=env, cwd=REPO)
    except subprocess.TimeoutExpired:
        return {"rc": -1, "error": "measured step timed out", "tail": ""}
    row: dict = {"rc": proc.returncode,
                 "tail": (proc.stderr or "")[-2000:]}
    for line in reversed((proc.stdout or "").strip().splitlines() or [""]):
        try:
            parsed = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(parsed, dict):
            row.update(parsed)
            return row
    row["error"] = "no measured output"
    return row


def _build_dir() -> str:
    from plenum_tpu_torch import ops
    return ops.BUILD_DIR


def run_harness(n_devices: int = 4, bucket: int = 16,
                seconds: float = 10.0, timeout: float = 900.0,
                backend: str = "cuda", build_dir: str = None) -> dict:
    """-> the MULTICHIP row. A first attempt that died or failed its
    checks re-runs once after the kernel build directory is purged (every
    library rebuilt from the checkout's sources); that row is tagged
    `torch_source: rebuilt`, never absent. A timeout re-runs too, but
    purges nothing: a slow run is not a stale build."""
    source = "cuda" if backend == "cuda" else "torch-cpu"
    row = _run_step(n_devices, bucket, seconds, timeout, backend)
    timed_out = row.get("rc") == -1
    failed = row.get("rc") != 0 or not row.get("ok")
    if failed:
        purged = False
        if not timed_out:
            target = build_dir or _build_dir()
            purged = os.path.isdir(target)
            shutil.rmtree(target, ignore_errors=True)
        retry = _run_step(n_devices, bucket, seconds, timeout, backend)
        retry["torch_source"] = "rebuilt"
        retry["first_attempt"] = {
            "rc": row.get("rc"), "ok": row.get("ok", False),
            "error": row.get("error"), "tail": row.get("tail", "")[-400:]}
        retry["build_purged"] = purged
        row = retry
    else:
        row["torch_source"] = source
    row["ok"] = bool(row.get("ok")) and row.get("rc") == 0
    row["tail"] = row.get("tail", "")[-1500:] if not row["ok"] else ""
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=4)
    ap.add_argument("--bucket", type=int, default=16)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--backend", default="cuda", choices=["cuda", "torch"])
    ap.add_argument("--out", default=None,
                    help="also write the row to this JSON file")
    args = ap.parse_args(argv)
    row = run_harness(args.devices, args.bucket, args.seconds,
                      args.timeout, args.backend)
    print(json.dumps(row))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(row, fh, indent=2)
    # a measured row (even a rebuilt one) is a SUCCESS; only a retry
    # that ALSO failed is a harness failure
    return 0 if row.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
