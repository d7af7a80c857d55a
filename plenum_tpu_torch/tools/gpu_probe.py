"""Cheap liveness probe for the card.

A benchmark that reaches for a GPU that is absent, wedged or held by a
dead context can stall in CUDA's initialisation for the length of its
timeout, learning nothing. This probe asks the driver through
`nvidia-smi`, in a subprocess with a timeout, so it answers in bounded
time and never initialises CUDA (or imports torch) in the caller: a
probe that created a context would itself take memory on the card and
could hang where the probed program hangs.

Usage:
    python -m plenum_tpu_torch.tools.gpu_probe      # human-readable + rc 0/1
    from plenum_tpu_torch.tools.gpu_probe import probe_gpu
"""
from __future__ import annotations

import subprocess
import time

QUERY = "name,power.limit,memory.total,memory.used,utilization.gpu"


def probe_gpu(timeout: float = 10.0) -> dict:
    """-> {"up": bool, "gpus": [{...}], "ms": t, "ts": iso} and, when
    down, "error". Never raises; never initialises CUDA."""
    t0 = time.monotonic()
    out = {"up": False, "gpus": [],
           "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())}
    try:
        proc = subprocess.run(
            ["nvidia-smi", f"--query-gpu={QUERY}",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=timeout)
    except FileNotFoundError:
        out["error"] = "nvidia-smi not found"
    except subprocess.TimeoutExpired:
        out["error"] = f"nvidia-smi gave no answer in {timeout} s"
    except OSError as exc:
        out["error"] = f"{type(exc).__name__}: {exc}"
    else:
        if proc.returncode != 0:
            out["error"] = (proc.stderr or proc.stdout or "").strip()[-300:] \
                or f"nvidia-smi exited {proc.returncode}"
        for line in (proc.stdout or "").strip().splitlines():
            fields = [f.strip() for f in line.split(",")]
            if len(fields) == len(QUERY.split(",")):
                out["gpus"].append(dict(zip(QUERY.split(","), fields)))
        out["up"] = proc.returncode == 0 and bool(out["gpus"])
    out["ms"] = round((time.monotonic() - t0) * 1e3, 1)
    return out


def main() -> int:
    result = probe_gpu()
    state = "UP" if result["up"] else "DOWN"
    detail = "; ".join(f"{g['name']} {g['power.limit']}"
                       for g in result["gpus"]) or result.get("error", "")
    print(f"{result['ts']} gpu {state} ({result['ms']} ms) {detail}")
    return 0 if result["up"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
