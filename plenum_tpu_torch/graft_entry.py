"""Entry points of the crypto plane (the JAX package's __graft_entry__.py).

entry(device):             the fused forward step — compressed-dispatch
                           Ed25519 verify (K3 + K4) then a Merkle subtree
                           reduce (K7) — and example arguments on `device`.
dryrun_multichip(n):       the same step sharded over an n-device
                           ("inst", "sig") roster by ShardedCryptoPlane,
                           run once on tiny shapes and checked.

Both run on the card unless the caller names other devices; without a
GPU the defaults raise.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from plenum_tpu_torch import ops
from plenum_tpu_torch.ops import ed25519 as ed_ops
from plenum_tpu_torch.ops import sha256 as sha_ops


def _example_batch(n_sigs: int, n_keys: int | None = None):
    """Deterministic signed messages -> compressed-dispatch byte arrays
    (s_u8, h_u8, keys_u8, idx, r_u8), signed by the pure-Python RFC 8032
    signer; the same seeds and messages as the reference's."""
    n_keys = n_keys or n_sigs
    seeds = [hashlib.sha256(b"graft-key-%d" % k).digest()
             for k in range(n_keys)]
    keys, s_rows, h_rows, r_rows, idx = [], [], [], [], []
    for i in range(n_sigs):
        msg = b"plenum_tpu graft example %d" % i
        sig, vk = ed_ops.pure_python_sign(seeds[i % n_keys], msg)
        if i < n_keys:
            keys.append(vk)
        h = int.from_bytes(
            hashlib.sha512(sig[:32] + vk + msg).digest(), "little") % ed_ops.L
        s_rows.append(sig[32:])
        h_rows.append(h.to_bytes(32, "little"))
        r_rows.append(sig[:32])
        idx.append(i % n_keys)

    def u8(rows):
        return np.frombuffer(b"".join(rows), np.uint8).reshape(-1, 32)

    return (u8(s_rows), u8(h_rows), u8(keys),
            np.asarray(idx, np.int32), u8(r_rows))


def _example_leaves(n_leaves: int) -> np.ndarray:
    """uint32[n_leaves, 8]: RFC-6962 leaf digests of b"leaf<i>"."""
    return sha_ops.bytes_to_digests(
        [hashlib.sha256(b"\x00leaf%d" % i).digest() for i in range(n_leaves)])


def _tensors(arrays, device) -> tuple:
    out = []
    for a in arrays:
        if a.dtype == np.uint32:
            a = a.view(np.int32)           # words travel as int32 bits
        out.append(torch.from_numpy(np.array(a)).to(device))
    return tuple(out)


def entry(device=None):
    """-> (fn, example_args): fn(s_u8, h_u8, keys_u8, idx, r_u8, leaves)
    -> (ok bool[8], root int32[8]); 8 signatures over 4 keys, 16 leaves,
    on `device` (None: the card)."""
    dev = ops.resolve_device(device)

    def forward(s_u8, h_u8, keys_u8, idx, r_u8, leaves):
        ok = ed_ops.verify_kernel_bytes(s_u8, h_u8, keys_u8, idx, r_u8)
        root = sha_ops.merkle_reduce_pow2(leaves)
        return ok, root

    args = _tensors(_example_batch(8, n_keys=4) + (_example_leaves(16),), dev)
    return forward, args


def dryrun_multichip(n_devices: int, devices=None):
    """Shard the plane step over an n_devices roster of `devices` (None:
    the CUDA devices, wrapped when there are fewer) and run it once:
    one signature per shard, half as many keys, two leaves per shard.
    Raises unless every verdict is True and n_ok counts them all.
    -> (ok bool[inst, sig], root int32[8], n_ok)."""
    from plenum_tpu_torch.parallel.crypto_plane import ShardedCryptoPlane
    from plenum_tpu_torch.parallel.mesh import lane_roster, make_mesh

    roster = lane_roster(n_devices, devices)
    mesh = make_mesh(n_devices, roster)
    n_inst, n_sig = mesh.shape["inst"], mesh.shape["sig"]
    m = n_inst * n_sig
    s_u8, h_u8, keys_u8, idx, r_u8, leaves = _tensors(
        _example_batch(m, n_keys=max(1, m // 2))
        + (_example_leaves(2 * mesh.size),), mesh.flat[0])
    plane = ShardedCryptoPlane(mesh)
    ok, root, n_ok = plane.step_bytes(
        s_u8.reshape(n_inst, n_sig, 32), h_u8.reshape(n_inst, n_sig, 32),
        keys_u8, idx.reshape(n_inst, n_sig), r_u8.reshape(n_inst, n_sig, 32),
        leaves)
    if not bool(ok.all()):
        raise AssertionError("sharded verify rejected a valid signature")
    if int(n_ok) != m:
        raise AssertionError("verdict count mismatch")
    return ok, root, n_ok
