"""Traffic generators, one module each, named by a cell's `generator`.

Each module has `run(ctx) -> dict` (see `port_bench.run.Context` and
`port_bench.run.execute` for what it is given and what it returns); the
parameters of a mix live in the cell's `workloads/<cell>.json`.
"""
