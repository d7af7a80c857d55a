"""The port's copy of tests/test_sha256_ops.py: the SHA-256 kernels'
plain versions (plenum_tpu_torch/ops/sha256.py on CPU tensors) against
hashlib ground truth, each output also held to the reference's
(plenum_tpu/ops/sha256.py, JAX on the CPU) on the same inputs."""
import hashlib
import random

import jax.numpy as jnp
import torch

from plenum_tpu.ops import sha256 as ref
from plenum_tpu_torch.ops.sha256 import (bytes_to_digests, digests_to_bytes,
                                         hash_interior, merkle_reduce_pow2,
                                         n_blocks_for, sha256_batch,
                                         to_tensor)

CPU = torch.device("cpu")


def ref_hash(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def _t(hs):
    return to_tensor(bytes_to_digests(hs), CPU)


def test_empty_and_abc():
    assert sha256_batch([b""], device=CPU) == [ref_hash(b"")]
    assert sha256_batch([b"abc"], device=CPU) == [ref_hash(b"abc")]
    assert sha256_batch([b"", b"abc"], device=CPU) == \
        ref.sha256_batch([b"", b"abc"])


def test_random_lengths_match_hashlib():
    rng = random.Random(42)
    msgs = [rng.randbytes(rng.randint(0, 300)) for _ in range(64)]
    got = sha256_batch(msgs, device=CPU)
    assert got == [ref_hash(m) for m in msgs]
    assert got == ref.sha256_batch(msgs)


def test_prefix_applied():
    msgs = [b"leafdata", b"x" * 100]
    got = sha256_batch(msgs, prefix=b"\x00", device=CPU)
    assert got == [ref_hash(b"\x00" + m) for m in msgs]
    assert got == ref.sha256_batch(msgs, prefix=b"\x00")


def test_block_boundary_lengths():
    # 55/56/63/64/119/120 bytes straddle padding edges
    msgs = [bytes(range(256))[:n] for n in [55, 56, 63, 64, 119, 120, 128]]
    for m in msgs:
        assert sha256_batch([m], device=CPU) == [ref_hash(m)], \
            f"len {len(m)}"
    assert sha256_batch(msgs, device=CPU) == ref.sha256_batch(msgs)


def test_n_blocks_for():
    assert n_blocks_for(0) == 1
    assert n_blocks_for(55) == 1
    assert n_blocks_for(56) == 2   # padding needs 9 bytes
    assert n_blocks_for(119) == 2
    assert n_blocks_for(120) == 3
    assert all(n_blocks_for(n) == ref.n_blocks_for(n) for n in range(300))


def test_hash_interior_matches_rfc6962_shape():
    rng = random.Random(7)
    lefts = [rng.randbytes(32) for _ in range(17)]
    rights = [rng.randbytes(32) for _ in range(17)]
    out = digests_to_bytes(hash_interior(_t(lefts), _t(rights)))
    expect = [ref_hash(b"\x01" + l + r) for l, r in zip(lefts, rights)]
    assert out == expect
    assert out == ref.digests_to_bytes(ref.hash_interior(
        jnp.asarray(ref.bytes_to_digests(lefts)),
        jnp.asarray(ref.bytes_to_digests(rights))))


def test_merkle_reduce_pow2_vs_host():
    rng = random.Random(9)
    leaves = [rng.randbytes(32) for _ in range(16)]

    def host_root(hs):
        if len(hs) == 1:
            return hs[0]
        nxt = [ref_hash(b"\x01" + hs[i] + hs[i + 1])
               for i in range(0, len(hs), 2)]
        return host_root(nxt)

    root = digests_to_bytes(merkle_reduce_pow2(_t(leaves))[None])[0]
    assert root == host_root(leaves)
    ref_root = ref.merkle_reduce_pow2(jnp.asarray(ref.bytes_to_digests(leaves)))
    assert root == ref.digests_to_bytes(ref_root[None])[0]


def test_digest_bytes_roundtrip():
    rng = random.Random(1)
    hs = [rng.randbytes(32) for _ in range(5)]
    assert digests_to_bytes(_t(hs)) == hs
    assert (bytes_to_digests(hs) == ref.bytes_to_digests(hs)).all()
