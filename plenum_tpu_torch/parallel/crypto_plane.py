"""Sharded crypto plane (the JAX package's parallel/crypto_plane.py).

One step verifies an [inst, n_sigs] grid of signatures and reduces a
Merkle root over [n_leaves] leaf digests, sharded over a 2-D
("inst", "sig") mesh of torch devices (parallel/mesh.py):

  - signature tensors: the grid is cut into one block per shard; each
    shard verifies its block with the compressed dispatch (K3 + K4,
    `step_bytes`) or the limb-staged one (K5 + K6, `step`). The
    distinct-key table is replicated: every shard gets all of it.
  - Merkle leaves: cut over the flattened mesh (inst-major); each shard
    reduces its complete subtree with K7, the per-shard roots are
    gathered onto the first shard's device (peer copies), padded to a
    power of two by repeating the last one, and reduced with K7 again.
  - verdict count: the per-shard counts, summed on the first device.

The reference runs this as one shard_map program with an all_gather and
a psum. Here one process drives every device of its lanes: it launches
each shard's kernels on that device's current stream, all shards before
any synchronisation, then gathers. On a mesh over a process group
(parallel/multihost.py `global_mesh`) each process verifies and reduces
the shards of its own lanes, and the shard roots and the count cross
the processes with torch.distributed's all_gather and all_reduce.
"""
from __future__ import annotations

import contextlib

import torch

from plenum_tpu_torch import ops
from plenum_tpu_torch.crypto.ed25519 import TorchEd25519Verifier
from plenum_tpu_torch.ops import ed25519 as ed_ops
from plenum_tpu_torch.ops import sha256 as sha_ops
from plenum_tpu_torch.parallel.mesh import Mesh, lane_roster, make_mesh


def _on(device: torch.device):
    """Make `device` current for the launches and allocations inside."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _reduce_roots(roots: torch.Tensor) -> torch.Tensor:
    """Top of the Merkle tree over the per-shard roots int32[S, 8]; a
    shard count that is not a power of two is padded by repeating the
    last root."""
    s = roots.shape[0]
    p = 1
    while p < s:
        p *= 2
    if p != s:
        roots = torch.cat([roots, roots[-1:].expand(p - s, 8)])
    return sha_ops.merkle_reduce_pow2(roots.contiguous())


# each step input's layout over the mesh (the reference's in_specs), in
# the order step_bytes and step take them: Mesh.shard reads them
_BYTES = ("inst", "sig", None)                  # u8 payloads [I, N, 32]
_IDX = ("inst", "sig")                          # idx, r_sign [I, N]
_LEAF = (("inst", "sig"), None)                 # leaves [L, 8]
STEP_BYTES_SPECS = (_BYTES, _BYTES, None, _IDX, _BYTES, _LEAF)
STEP_SPECS = ((None, "inst", "sig"), (None, None, "inst", "sig"), None,
              _IDX, ("inst", "sig", None), _IDX, _LEAF)


def _across_processes(roots: torch.Tensor, n_ok: torch.Tensor):
    """Every process's shard roots, in rank order (each holds as many
    shards), and the job's verdict count: all_gather and all_reduce over
    the default process group."""
    import torch.distributed as dist
    parts = [torch.empty_like(roots) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, roots)
    n_ok = n_ok.clone()
    dist.all_reduce(n_ok)
    return torch.cat(parts), n_ok


class ShardedCryptoPlane:
    """Verify + Merkle root + verdict count of one grid over a mesh.

    Each input is this process's part of the grid (all of it on one
    process) as a tensor, or already cut for its lanes as
    `multihost.shard_host_batch` leaves it. The verdicts returned are
    this process's block of the grid; the root and the count are the
    whole job's."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def _shards(self, args, specs) -> list:
        """-> per lane this process drives: (its device, its block of
        every input). The grid must tile the mesh exactly, and each
        shard's leaf block be a power of two."""
        lanes = self.mesh.flat[self.mesh.local]
        cut = [a if isinstance(a, list) else self.mesh.shard(a, spec)
               for a, spec in zip(args, specs)]
        if any(len(c) != len(lanes) for c in cut):
            raise ValueError(f"inputs cut for {[len(c) for c in cut]} lanes, "
                             f"not {len(lanes)}")
        for leaves in cut[-1]:
            n = leaves.shape[0]
            if n == 0 or n & (n - 1):
                raise ValueError(f"{n} leaves a shard: want a power of two")
        return list(zip(lanes, zip(*cut)))

    def _combine(self, outs):
        """Gather the shards' verdict blocks, roots and counts onto this
        process's first lane, the roots and counts of a process group
        across its processes -> (ok bool[I, N], root int32[8], n_ok)."""
        rows, cols = self.mesh.local_grid()
        dev0 = self.mesh.flat[self.mesh.local][0]
        with _on(dev0):
            ok = torch.cat([torch.cat([o.to(dev0) for o, _, _ in
                                       outs[a * cols:(a + 1) * cols]], dim=1)
                            for a in range(rows)], dim=0)
            roots = torch.stack([r.to(dev0) for _, r, _ in outs])
            n_ok = torch.stack([c.to(dev0) for _, _, c in outs]).sum(
                dtype=torch.int32)
            if self.mesh.in_group:
                roots, n_ok = _across_processes(roots, n_ok)
            root = _reduce_roots(roots)
        return ok, root, n_ok

    @staticmethod
    def _shard_out(ok, idx, leaves):
        """A shard's verdict block (idx's shape), subtree root, count."""
        ok = ok.reshape(idx.shape)
        return (ok, sha_ops.merkle_reduce_pow2(leaves),
                ok.sum(dtype=torch.int32))

    def step_bytes(self, s_u8, h_u8, keys_u8, idx, r_u8, leaves):
        """The compressed dispatch over the grid -> (ok bool[I, N], root
        int32[8], n_ok int32 scalar tensor).

        s_u8, h_u8, r_u8 uint8[I, N, 32] and idx int32[I, N] shard over
        the grid; keys_u8 uint8[U, 32] is replicated; leaves int32[L, 8]
        shard over the flattened mesh (a power of two per shard)."""
        outs = []
        for dev, (s, h, k, i, r, lv) in self._shards(
                (s_u8, h_u8, keys_u8, idx, r_u8, leaves), STEP_BYTES_SPECS):
            with _on(dev):
                ok = ed_ops.verify_kernel_bytes(
                    s.reshape(-1, 32), h.reshape(-1, 32), k, i.reshape(-1),
                    r.reshape(-1, 32))
                outs.append(self._shard_out(ok, i, lv))
        return self._combine(outs)

    def step(self, s_dig, h_dig, aq_unique, idx, ry, r_sign, leaves):
        """The limb-staged dispatch over the grid -> (ok bool[I, N],
        root int32[8], n_ok int32 scalar tensor).

        s_dig int32[32, I, N], h_dig int32[16, 4, I, N], idx int32[I, N],
        ry int32[I, N, 20] and r_sign int32[I, N] shard over the grid;
        aq_unique int32[U, 4, 4, 20] is replicated (each shard builds the
        tables of every row with K5 and gathers them by idx in K6);
        leaves as in step_bytes."""
        outs = []
        for dev, (sd, hd, aq, i, ry_, rs, lv) in self._shards(
                (s_dig, h_dig, aq_unique, idx, ry, r_sign, leaves), STEP_SPECS):
            with _on(dev):
                m = i.numel()
                ok = ed_ops.verify_kernel_indexed(
                    sd.reshape(ed_ops.N_COMB, m),
                    hd.reshape(ed_ops.N_WIN, ed_ops.N_QUARTERS, m), aq,
                    i.reshape(m), ry_.reshape(m, ed_ops.NLIMB),
                    rs.reshape(m))
                outs.append(self._shard_out(ok, i, lv))
        return self._combine(outs)


class ShardedTorchEd25519Verifier(TorchEd25519Verifier):
    """TorchEd25519Verifier whose dispatch is the sharded plane: the same
    host staging (key cache, digit arrays), padded to a power of two so
    the batch tiles the mesh, then one plane step per batch. The seam of
    `make_verifier("cuda-sharded")`."""

    def __init__(self, plane: ShardedCryptoPlane, min_batch: int = 1,
                 cache_size: int = 65536):
        inst = plane.mesh.shape["inst"]
        sig = plane.mesh.shape["sig"]
        if plane.mesh.in_group:
            raise ValueError("a verifier dispatches one process's traffic; "
                             "a plane over a process group is stepped on "
                             "every rank")
        if inst & (inst - 1) or sig & (sig - 1):
            raise ValueError(
                f"mesh axes must be powers of two for the pow2-padded "
                f"dispatch to tile exactly, got inst={inst} sig={sig}")
        super().__init__(device=plane.mesh.flat[0], cache_size=cache_size)
        # every dispatch must fill the grid: at least one lane per shard
        self._min_batch = max(min_batch, inst * sig)
        self._plane = plane
        self._grid = (inst, sig)
        self.dispatches = 0
        self.rewarms = 0

    def rewarm(self) -> None:
        super().rewarm()
        self.rewarms += 1

    def _pad_sizes(self, m: int, n_keys: int) -> tuple[int, int]:
        """The reference's bucketing policy: batch rows pad to the next
        power of two >= min_batch; the distinct-key table to 64 keys or
        to the padded batch."""
        m_pad = 1
        while m_pad < max(m, self._min_batch):
            m_pad *= 2
        small = min(64, m_pad)             # u <= m <= m_pad always holds
        return m_pad, (small if n_keys <= small else m_pad)

    def _pad(self, per_sig: list, keys: list) -> None:
        """Pad to `_pad_sizes`: pad rows repeat row 0, and their verdicts
        are dropped; the grid then tiles the mesh exactly."""
        m_pad, u_pad = self._pad_sizes(len(per_sig[0]), len(keys))
        for rows in per_sig:
            rows += [rows[0]] * (m_pad - len(rows))
        keys += [keys[0]] * (u_pad - len(keys))

    def _zero_leaves(self) -> torch.Tensor:
        """The plane fuses a Merkle reduction; verification only needs
        the verdicts, so one zero leaf per shard, root dropped."""
        return torch.zeros((self._plane.mesh.size, 8), dtype=torch.int32,
                           device=self.device)

    def _device_verify_bytes(self, s_u8, h_u8, k_u8, idx, r_u8):
        inst, _ = self._grid
        m = s_u8.shape[0]               # a power of two >= inst * sig
        n = m // inst
        ok, _root, _n_ok = self._plane.step_bytes(
            s_u8.reshape(inst, n, 32), h_u8.reshape(inst, n, 32), k_u8,
            idx.reshape(inst, n), r_u8.reshape(inst, n, 32),
            self._zero_leaves())
        self.dispatches += 1
        return ok.reshape(m)

    def _device_verify(self, s_digits, h_digits, aq_unique, idx, ry, r_sign):
        inst, _ = self._grid
        s_digits, h_digits, aq_unique, idx, ry, r_sign = ed_ops.stage_on(
            self.device, s_digits, h_digits, aq_unique, idx, ry, r_sign)
        m = idx.shape[0]
        n = m // inst
        ok, _root, _n_ok = self._plane.step(
            s_digits.reshape(ed_ops.N_COMB, inst, n),
            h_digits.reshape(ed_ops.N_WIN, ed_ops.N_QUARTERS, inst, n),
            aq_unique, idx.reshape(inst, n),
            ry.reshape(inst, n, ed_ops.NLIMB), r_sign.reshape(inst, n),
            self._zero_leaves())
        self.dispatches += 1
        return ok.reshape(m)


def make_sharded_verifier(min_batch: int = 1, n_devices=None,
                          devices=None) -> ShardedTorchEd25519Verifier:
    """Plane + verifier over a roster: `devices` (default: every CUDA
    device, which raises on a host without one), wrapped or cut to
    n_devices. The dispatch tiles power-of-two batches, so a roster that
    is not a power of two long (e.g. 6) is trimmed to its largest
    power-of-two prefix."""
    roster = lane_roster(n_devices, devices)
    if not roster:
        ops.resolve_device("cuda")      # raises: no CUDA device
        raise ValueError("make_sharded_verifier: no devices")
    pow2 = 1
    while pow2 * 2 <= len(roster):
        pow2 *= 2
    plane = ShardedCryptoPlane(make_mesh(pow2, roster))
    return ShardedTorchEd25519Verifier(plane, min_batch=min_batch)
