"""The benchmark's plain reference: what decides `correct`.

Plain Python over hashlib, written or copied for the benchmark alone. It
imports neither `jax`, `plenum_tpu` nor anything of `plenum_tpu_torch`,
and takes nothing the program made: the checks hand it the benchmark's
own inputs and the program's outputs, which it reads only to judge them.

- `ed25519`: RFC 8032 section 5.1.7 verification (strict decoding).
- `merkle`: the RFC 6962 Merkle tree hash over a ledger's leaves.
- `mpt`: the root of an Ethereum-shaped Merkle Patricia trie (RLP,
  SHA3-256) over a key-value set, built from scratch.
- `codec`: msgpack, canonical JSON, base58 and request digests.
"""
