"""plenum_tpu_torch — the PyTorch/CUDA port of the JAX package `plenum_tpu`.

The same BFT ledger framework (the JAX package `plenum_tpu` is its
reference and stays as it is), with the device programs rewritten as CUDA
kernels by hand for NVIDIA Hopper. Module paths and names follow the
reference's, so each counterpart is easy to find. The port imports
neither `jax` nor anything of `plenum_tpu`.

Every module of the reference has its counterpart here:

    ops/       CUDA kernels (csrc/), their build seam and plain versions
    crypto/    Ed25519 signing and batched verification (backends
               "cuda", "torch", "cpu"); BLS over BN254, multi-signatures
    parallel/  the sharded crypto plane, the device ring (CryptoPipeline)
               and its multi-lane, federated and multi-host forms, its
               supervisor, the commit wave and the crypto service
    node/      the Node, client request authentication, the pool manager,
               NodeBootstrap (a replica's components) and the observer
    consensus/ RBFT ordering, checkpoints, view change, BLS
    catchup/, client/, network/, reads/, ingress/, observability/
    ledger/    Merkle ledger on batched SHA-256 (backends as above)
    state/     MPT state, state commitments (KZG, Verkle)
    execution/ txn handlers, write and read managers, the batch executor
    storage/   key-value stores (memory, file log, native, chunked)
    native/    host C++ (BN254 pairings, key-value store, MPT codec)
    common/    messages, request, serialization (C msgpack when it
               imports, else pure Python), metrics, tracing
    shards/    the sharded fabric: mapping ledger, router, cross-shard
               reads and writes, live resharding
    control/   the autopilot control plane
    tools/     the pools, bench configurations, ops tools and the card's
               probe, microbench and multi-lane harness
    convert    carrying a reference ledger's or replica's stores into the
               port

Entry points run on the card unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
