"""Merkle tree hashing seam — the first of the three crypto provider seams
(SURVEY.md §7 stage 2).

Reference behavior: ledger/tree_hasher.py:4 — RFC-6962 domain separation:
    leaf hash     = SHA256(0x00 || data)
    interior hash = SHA256(0x01 || left || right)
Backends: `cpu` (hashlib, scalar), `cuda` (batched SHA-256 kernels from
plenum_tpu_torch.ops.sha256) and `torch` (those kernels' plain PyTorch
versions on the CPU, for tests). The batch API is the contract —
`hash_leaves` / `hash_children_batch` take whole vectors so the device
backend issues one launch per call, never one per hash.
"""
from __future__ import annotations

import hashlib
from typing import Optional, Sequence

import numpy as np
import torch

from plenum_tpu_torch import ops
from plenum_tpu_torch.ops.sha256 import (TILED_MAX, bytes_to_digests,
                                         digests_to_bytes, hash_interior,
                                         merkle_wave_flat, sha256_batch,
                                         to_tensor, wave_rows)


class TreeHasher:
    """CPU backend (hashlib)."""

    def hash_empty(self) -> bytes:
        return hashlib.sha256(b"").digest()

    def hash_leaf(self, data: bytes) -> bytes:
        return hashlib.sha256(b"\x00" + data).digest()

    def hash_children(self, left: bytes, right: bytes) -> bytes:
        return hashlib.sha256(b"\x01" + left + right).digest()

    # batch API (scalar loop on CPU; one device call on the device backend)
    def hash_leaves(self, leaves: Sequence[bytes]) -> list[bytes]:
        return [self.hash_leaf(l) for l in leaves]

    def hash_children_batch(self, pairs: Sequence[tuple[bytes, bytes]]) -> list[bytes]:
        return [self.hash_children(l, r) for l, r in pairs]


def fused_wave_levels(new_hashes, bounds, offs, counts, device,
                      note_shape=None):
    """An append wave's interior levels through ops/sha256.merkle_wave_flat
    — the shared implementation behind `hash_wave_levels`.

    new_hashes: the wave's new level-0 digests (32-byte each).
    bounds[l]:  the old left-boundary digest level l pairs with, or None.
    offs[l]:    1 when level l uses its boundary.
    counts[l]:  how many parents level l really forms (the valid prefix).

    Returns per-level lists of parent digests for the first
    min(len(counts), log2(bucket)) levels; the CALLER finishes any deeper
    (single-node spine) levels on host. The inputs go to the device in one
    copy (new0, bounds and offs packed into one int32 buffer) and the
    levels come back in one copy (a prefix of the flat output).
    note_shape, when given, is called with the shape key ("merkle",
    bucket) before the launch, so the pipeline's shape guard can count
    it.
    """
    n = len(new_hashes)
    bucket = _pow2_at_least(max(2, n))
    depth = bucket.bit_length() - 1          # log2(bucket) levels
    if note_shape is not None:
        note_shape(("merkle", bucket))
    packed = np.zeros(8 * bucket + 9 * depth, dtype=np.uint32)
    new0 = packed[:8 * bucket].reshape(bucket, 8)
    bnd = packed[8 * bucket:8 * (bucket + depth)].reshape(depth, 8)
    off = packed[8 * (bucket + depth):]
    new0[:n] = bytes_to_digests(list(new_hashes))
    levels = min(depth, len(counts))
    for l in range(levels):
        if offs[l] and bounds[l] is not None:
            bnd[l] = bytes_to_digests([bounds[l]])[0]
            off[l] = 1
    dev = to_tensor(packed, device)
    flat = merkle_wave_flat(dev[:8 * bucket].view(bucket, 8),
                            dev[8 * bucket:8 * (bucket + depth)].view(depth, 8),
                            dev[8 * (bucket + depth):])
    rows = wave_rows(bucket)[:levels]
    got = digests_to_bytes(flat[:rows[-1][1]] if rows else flat[:0])
    return [got[start:start + counts[l]]
            for l, (start, _) in enumerate(rows)]


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class TorchTreeHasher(TreeHasher):
    """Device backend: batched SHA-256 (plenum_tpu_torch/ops/sha256.py).

    Scalar calls stay on hashlib (correctness identical); the wins come
    from the batch entry points used by Ledger.extend_batch and the catchup
    verifier. `device` None means the card, and raises when there is none;
    "cpu" runs the kernels' plain versions.
    """

    def __init__(self, min_batch: int = 1024, fuse_min: Optional[int] = None,
                 device=None):
        # Below min_batch the launch and copy overhead beats the kernel's
        # win — hashlib does 1024 sha256 in under a millisecond — so only
        # catchup-scale batch verification and bulk appends go to the device.
        self._min_batch = min_batch
        # fused append waves hash all interior levels per call, so they
        # amortize earlier than the flat batch threshold
        self._fuse_min = min_batch if fuse_min is None else fuse_min
        self.device = ops.resolve_device(device)

    def hash_wave_levels(self, new_hashes, bounds, offs, counts):
        """Fused interior levels for one append wave, or None to decline
        (small waves stay on the hashlib per-level path, waves wider than
        one launch takes go level by level through hash_children_batch)."""
        if not self._fuse_min <= len(new_hashes) <= TILED_MAX:
            return None
        return fused_wave_levels(new_hashes, bounds, offs, counts, self.device)

    def hash_leaves(self, leaves: Sequence[bytes]) -> list[bytes]:
        if len(leaves) < self._min_batch:
            return [self.hash_leaf(l) for l in leaves]
        return sha256_batch(list(leaves), prefix=b"\x00", device=self.device)

    def hash_children_batch(self, pairs: Sequence[tuple[bytes, bytes]]) -> list[bytes]:
        if len(pairs) < self._min_batch:
            return [self.hash_children(l, r) for l, r in pairs]
        lefts = to_tensor(bytes_to_digests([p[0] for p in pairs]), self.device)
        rights = to_tensor(bytes_to_digests([p[1] for p in pairs]), self.device)
        return digests_to_bytes(hash_interior(lefts, rights))


def make_tree_hasher(backend: str = "cuda", min_batch: int = 1024,
                     fuse_min: Optional[int] = None) -> TreeHasher:
    """The hasher for a backend name: "cuda" (the default; raises without
    a GPU), "torch" (plain versions on the CPU) or "cpu" (hashlib). The
    sharded verifier backends hash as their single-device ones do, as the
    reference's "jax-sharded" hashes on its device hasher: a node on
    "cuda-sharded" hashes on the card, on "torch-sharded" on the CPU.
    A node whose verifier is remote ("service") hashes on hashlib, as the
    reference's does. min_batch/fuse_min are TorchTreeHasher's
    thresholds."""
    if backend in ("cuda", "cuda-sharded"):
        return TorchTreeHasher(min_batch, fuse_min, device="cuda")
    if backend in ("torch", "torch-sharded"):
        return TorchTreeHasher(min_batch, fuse_min, device="cpu")
    if backend in ("cpu", "service"):
        return TreeHasher()
    raise ValueError(f"unknown tree-hasher backend {backend!r} (want "
                     "'cuda', 'cuda-sharded', 'torch', 'torch-sharded', "
                     "'cpu' or 'service')")
