"""The benchmark of the PyTorch and CUDA port (`plenum_tpu_torch`).

One run is one process:

    python3 -m port_bench.run --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`. The harness is
driven by data: a cell is `workloads/<cell>.json`, its configuration
`configs/<config>.json`, its traffic generator `traffic/<generator>.py`,
and each per-layer metric a reader `metrics/<metric>.py`, all found by
the names in `BENCHMARK.json`. `reference/` is the plain reference that
decides `correct`; `tests/` holds the CPU tests (`python3 -m pytest
port_bench/tests`) and the control and fault tests.
"""
