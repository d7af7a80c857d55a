"""Horizontal state sharding: per-shard ordering sub-pools with
proof-carrying cross-shard reads AND writes, live resharding
(docs/sharding.md).

- mapping.py      the BLS-anchored mapping ledger + ownership proofs
- router.py       ShardRouter behind the ingress seam
- read_client.py  client map view + composed cross-shard verification
- fabric.py       N shards in one process on the shared seeded timer
- reshard.py      live shard split/merge as mapping-ledger transactions
- cross_write.py  proof-carrying fail-closed cross-shard write 2PC
"""
from .mapping import (MAPPING_LEDGER_ID, SHARD_PROOF,  # noqa: F401
                      MappingLedger, ShardDescriptor, equal_ranges,
                      key_point, range_midpoint, routing_key,
                      verify_ownership)
from .read_client import (CrossShardReadCheck,  # noqa: F401
                          CrossShardReadStats, ShardMapView)
from .router import ShardRouter  # noqa: F401
from .fabric import (ShardReadGate, ShardedSimFabric,  # noqa: F401
                     SimShard, shard_node_names)
from .reshard import (Migration, ReshardManager,  # noqa: F401
                      STALE_WRITE_NACK)
from .cross_write import (CrossShardWrites,  # noqa: F401
                          CrossWriteParticipant)
