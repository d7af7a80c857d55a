"""One run of one cell: set-up, a measured window, the check, one line.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is the result (JSON): `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), `device`, with --trace 1 `breakdown`, and
last `checks`, each number compared with its limit. The same numbers
are the last lines of standard error. Without the cards the cell asks
for, or with JAX or the JAX package loaded once the window has closed,
the run prints no result and exits with another code than 0.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

from port_bench import importcheck, spec  # noqa: E402


@dataclass
class Context:
    """What a traffic generator is given."""
    seed: int
    seconds: float
    trace: bool
    work: dict
    conf: dict
    params: dict
    backend: str = "cuda"
    t_process: float = T_PROCESS
    workers: int = 0              # signing processes; 0: the host's cores
    # fault and control injection: stage name -> [callable(ctx, system)]
    hooks: dict = field(default_factory=dict)
    # (object, attribute, value) that a hook patched, set back after the run
    restore: list = field(default_factory=list)
    # what the generator's prepare() started before torch was loaded
    prepared: object = None


def _pin_caches(root: str) -> None:
    """Every build and kernel cache of the program at a fixed path inside
    the checkout, so that only a checkout's first run builds. The port's
    nvcc libraries go to <checkout>/build/plenum_tpu_torch by its own
    rule; its host C++ goes under XDG_CACHE_HOME."""
    cache = os.path.join(root, "build", "port_bench")
    os.environ["XDG_CACHE_HOME"] = os.path.join(cache, "xdg")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"


def start(name: str, seed: int, seconds: float, trace: bool,
          backend: str = "cuda", root: str = spec.ROOT, params: dict = None,
          hooks: dict = None, workers: int = 0) -> tuple:
    """Find the cell and start what its generator prepares before torch
    is loaded -> (bench, generator, Context)."""
    bench = spec.load_benchmark(root)
    work, conf = spec.cell(bench, name, root)
    ctx = Context(seed=seed, seconds=seconds, trace=trace, work=work,
                  conf=conf, params=dict(work["params"], **(params or {})),
                  backend=backend, hooks=hooks or {}, workers=workers)
    gen = spec.generator(work["generator"])
    if hasattr(gen, "prepare"):
        ctx.prepared = gen.prepare(ctx)
    return bench, gen, ctx


def execute(name: str, seed: int, seconds: float, trace: bool,
            backend: str = "cuda", root: str = spec.ROOT,
            params: dict = None, hooks: dict = None,
            workers: int = 0) -> tuple[dict, list]:
    """Run the cell -> (result line, lines for standard error). backend
    "torch" runs the kernels' plain versions on the CPU, for the tests;
    the command line runs "cuda" only, after finding the cards."""
    return finish(*start(name, seed, seconds, trace, backend, root, params,
                         hooks, workers), root)


def finish(bench: dict, gen, ctx: Context,
           root: str = spec.ROOT) -> tuple[dict, list]:
    name, work, trace, backend = (ctx.work["name"], ctx.work, ctx.trace,
                                  ctx.backend)
    try:
        run = gen.run(ctx)
    finally:
        for obj, attr, value in reversed(ctx.restore):
            setattr(obj, attr, value)

    metrics = {}
    if trace:
        for m in spec.metrics_for(bench, name, "per_layer"):
            value = spec.reader(m["name"], root)(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec.metrics_for(bench, name, "end_to_end"):
            value = run["setup_s"] if m["name"] == "setup_s" \
                else run["end_to_end"][m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if backend == "cuda":
        from port_bench import device
        dev = device.info(work["chips"])
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "torch_source": backend}
    dev["memory_peak_bytes"] = run["memory_peak_bytes"]
    checks = {k: {"value": v, "limit": lim}
              for k, (v, lim) in run["checks"].items()}
    result = {"correct": all(c["value"] <= c["limit"]
                             for c in checks.values()),
              "attempted": run["attempted"], "failed": run["failed"],
              "metrics": metrics, "device": dev}
    if trace and run.get("trace") is not None:
        tr = run["trace"]
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": [list(x) for x in
                                              tr["device_ops"]],
                               "idle_gaps": [list(x) for x in
                                             tr["idle_gaps"]]}
    result["checks"] = checks
    lines = list(run.get("notes", []))
    lines.append(f"window {run['window_s']} s, set-up {run['setup_s']:.3f} s")
    lines += [f"check {k}: {c['value']} (limit {c['limit']})"
              for k, c in checks.items()]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _pin_caches(spec.ROOT)
    try:
        started = start(args.workload, args.seed, args.seconds,
                        bool(args.trace))
    except spec.SpecError as exc:
        print(f"port_bench: {exc}", file=sys.stderr)
        return 2
    bench, gen, ctx = started
    from port_bench import device
    try:
        device.require_cards(ctx.work["chips"])
    except (device.NoCard, ImportError) as exc:
        if ctx.prepared is not None:
            gen.abandon(ctx.prepared)
        print(f"port_bench: no result without the card: {exc}",
              file=sys.stderr)
        return 3
    result, lines = finish(*started)
    loaded = importcheck.forbidden_loaded()
    if loaded:
        print(f"port_bench: the run loaded {', '.join(loaded)}; no result",
              file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
