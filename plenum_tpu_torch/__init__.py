"""plenum_tpu_torch — the PyTorch/CUDA port of the JAX package `plenum_tpu`.

The same BFT ledger framework (the JAX package `plenum_tpu` is its
reference and stays as it is), with the device programs rewritten as CUDA
kernels by hand for NVIDIA Hopper. Module paths and names follow the
reference's, so each counterpart is easy to find. The port imports
neither `jax` nor anything of `plenum_tpu`.

Ported so far (everything below the Node orchestrator):

    ops/       CUDA kernels (csrc/), their build seam and plain versions
    crypto/    Ed25519 signing and batched verification (backends
               "cuda", "torch", "cpu"); BLS over BN254, multi-signatures
    parallel/  the sharded crypto plane, the device ring (CryptoPipeline),
               its supervisor and the commit wave
    node/      client request authentication, the pool manager and
               NodeBootstrap (a replica's components)
    ledger/    Merkle ledger on batched SHA-256 (backends as above)
    state/     MPT state, state commitments (KZG, Verkle)
    execution/ txn handlers, write and read managers, the batch executor
    consensus/ the master replica's BLS and the batch-executor seam
    storage/   key-value stores (memory, file log, native, chunked)
    native/    host C++ (BN254 pairings, key-value store, MPT codec)
    common/    messages, request, serialization (pure-Python msgpack),
               metrics, tracing
    tools/     the in-process pool's genesis
    convert    carrying a reference ledger's or replica's stores into the
               port

Entry points run on the card unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
