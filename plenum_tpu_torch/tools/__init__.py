"""Operator tools: pool runners, key generation, benchmarks
(ref scripts/ — start_plenum_node, generate_plenum_pool_transactions &c)."""
