"""Kernel microbenchmarks on the card.

Measures the Ed25519 batch verify (K3 + K4, `make_verifier`) in sigs/s
at the headline batch sizes (2,048 warm, 128 small-dispatch), with a
negative control (one corrupted signature must flip exactly one
verdict), and the leaf SHA-256 kernel (K1) through `make_tree_hasher`,
checked against hashlib. Replaces the hot spot the reference spends its
CPU on (/root/reference/stp_core/crypto/nacl_wrappers.py:62,212 — scalar
libsodium verify per request per node).

Run: python -m plenum_tpu_torch.tools.gpu_microbench [--batches 2048,128]
        [--backend cuda|torch]
Prints one JSON line per measurement plus a trailing summary line. On
"cuda" a card that does not answer `nvidia-smi` fails in bounded time
(tools/gpu_probe.py), never hangs; "torch" runs the kernels' plain
versions on the CPU.
"""
from __future__ import annotations

import json
import sys
import time


def _now_iso() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


def _sync(backend: str) -> None:
    if backend == "cuda":
        import torch
        torch.cuda.synchronize()


def bench_ed25519(batch: int, reps: int = 5, backend: str = "cuda") -> dict:
    """sigs/s for one warm dispatch of `batch` signatures."""
    import numpy as np

    from plenum_tpu_torch import ops
    from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer, make_verifier

    rng = np.random.default_rng(7)
    signers = [Ed25519Signer(bytes(rng.integers(0, 256, 32, dtype=np.uint8)))
               for _ in range(min(batch, 64))]
    items = []
    for i in range(batch):
        s = signers[i % len(signers)]
        msg = bytes(rng.integers(0, 256, 64, dtype=np.uint8))
        items.append((msg, s.sign(msg), s.verkey))
    ver = make_verifier(backend, supervised=False)
    # warm: kernel load + first launch
    t0 = time.perf_counter()
    out = ver.verify_batch(items)
    first_s = time.perf_counter() - t0
    if not bool(np.asarray(out).all()):
        return {"error": f"verdicts wrong at batch {batch}"}
    # negative control: one corrupted signature must flip exactly one verdict
    bad = list(items)
    bad[0] = (bad[0][0], bad[0][1][:32] + bytes(32), bad[0][2])
    out_bad = np.asarray(ver.verify_batch(bad))
    if bool(out_bad[0]) or not bool(out_bad[1:].all()):
        return {"error": f"negative control failed at batch {batch}"}
    launches = ops.LAUNCHES["ed25519_verify"]
    times = []
    for _ in range(reps):
        _sync(backend)
        t0 = time.perf_counter()
        ver.verify_batch(items)
        _sync(backend)
        times.append(time.perf_counter() - t0)
    best = min(times)
    med = sorted(times)[len(times) // 2]
    return {
        "kernel": "ed25519_verify", "backend": backend, "batch": batch,
        "first_call_s": round(first_s, 3),
        "warm_best_s": round(best, 5), "warm_median_s": round(med, 5),
        "sigs_per_s_best": round(batch / best, 1),
        "sigs_per_s_median": round(batch / med, 1),
        "negative_control": "one verdict flipped",
        "k4_launches": ops.LAUNCHES["ed25519_verify"] - launches,
        "reps": reps,
    }


def bench_sha256(batch: int = 4096, reps: int = 5,
                 backend: str = "cuda") -> dict:
    """The Merkle leaf hash (K1) over `batch` 48-byte leaves, through the
    ledger's device tree hasher, every digest held to hashlib."""
    import hashlib

    import numpy as np

    from plenum_tpu_torch import ops
    from plenum_tpu_torch.ledger.tree_hasher import make_tree_hasher

    rng = np.random.default_rng(3)
    leaves = [bytes(rng.integers(0, 256, 48, dtype=np.uint8))
              for _ in range(batch)]
    hasher = make_tree_hasher(backend, min_batch=1)
    t0 = time.perf_counter()
    out = hasher.hash_leaves(leaves)
    first_s = time.perf_counter() - t0
    matches = out == [hashlib.sha256(b"\x00" + leaf).digest()
                      for leaf in leaves]
    launches = ops.LAUNCHES["sha256_words"]
    times = []
    for _ in range(reps):
        _sync(backend)
        t0 = time.perf_counter()
        hasher.hash_leaves(leaves)
        _sync(backend)
        times.append(time.perf_counter() - t0)
    best = min(times)
    out = {
        "kernel": "sha256_leaves", "backend": backend, "batch": batch,
        "first_call_s": round(first_s, 3),
        "warm_best_s": round(best, 5),
        "hashes_per_s_best": round(batch / best, 1),
        "leaves_match_hashlib": matches,
        "k1_launches": ops.LAUNCHES["sha256_words"] - launches,
        "reps": reps,
    }
    if not matches:
        out["error"] = "leaf digests differ from hashlib"
    return out


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default="2048,128")
    ap.add_argument("--sha-batch", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--backend", default="cuda", choices=["cuda", "torch"])
    ap.add_argument("--skip-probe", action="store_true")
    args = ap.parse_args(argv)

    header = {"ts": _now_iso(), "backend": args.backend}
    if args.backend == "cuda":
        if not args.skip_probe:
            from plenum_tpu_torch.tools.gpu_probe import probe_gpu
            probe = probe_gpu()
            if not probe["up"]:
                print(json.dumps({"error": "card down", "ts": probe["ts"],
                                  "probe": probe.get("error")}))
                return 1
        import torch
        header["device"] = torch.cuda.get_device_name(0)
    else:
        header["device"] = "cpu"
    print(json.dumps(header), flush=True)

    results = []
    for b in [int(x) for x in args.batches.split(",") if x]:
        r = bench_ed25519(b, reps=args.reps, backend=args.backend)
        r["ts"] = _now_iso()
        print(json.dumps(r), flush=True)
        results.append(r)
    r = bench_sha256(args.sha_batch, reps=args.reps, backend=args.backend)
    r["ts"] = _now_iso()
    print(json.dumps(r), flush=True)
    results.append(r)

    errors = [r["error"] for r in results if "error" in r]
    summary = {"summary": True, **header, "errors": errors,
               "ed25519": {str(r["batch"]): r.get("sigs_per_s_best")
                           for r in results
                           if r.get("kernel") == "ed25519_verify"}}
    print(json.dumps(summary), flush=True)
    # rc mirrors correctness: a wrong verdict / failed negative control
    # must not look like a passed device run to log-scrapers
    return 2 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
