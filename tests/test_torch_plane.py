"""The port's sharded crypto plane (plenum_tpu_torch.parallel) against the
JAX package: verdicts against `CpuEd25519Verifier`, roots against JAX
`merkle_reduce_pow2` and hashlib, counts against the verdicts.

The port's shards here are explicit CPU devices, so each shard runs the
kernels' plain versions; the grid is cut, verified per shard, gathered
and reduced exactly as on the card. The reference's own plane (8 virtual
JAX devices) makes JAX compile its Ed25519 kernels for minutes on a CPU,
so that comparison is marked `slow`; the plane on real cards is marked
`gpu`. Every comparison is exact.
"""
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plenum_tpu.crypto.ed25519 import CpuEd25519Verifier, Ed25519Signer as RefSigner
from plenum_tpu.ops import sha256 as ref_sha
from plenum_tpu.parallel.mesh import mesh_shape_for as ref_mesh_shape_for
from plenum_tpu_torch import graft_entry, ops
from plenum_tpu_torch.crypto.ed25519 import TorchEd25519Verifier, make_verifier
from plenum_tpu_torch.ops import sha256 as sha
from plenum_tpu_torch.parallel.crypto_plane import (
    ShardedCryptoPlane, ShardedTorchEd25519Verifier, make_sharded_verifier)
from plenum_tpu_torch.parallel.mesh import lane_roster, make_mesh, mesh_shape_for

P = 2**255 - 19
N_LANES = 12               # per instance: tiles sig = 3 (6 shards) and 4 (8)
N_INST = 2                 # RBFT instances validating the same batch (f + 1)


def _items():
    """12 items under 4 signers plus bad keys: valid, bit-flipped R and
    S, a changed message, and keys that are off curve, y = 0 or y >= p.
    Every S < L, so the byte staging keeps all 12 lanes."""
    rng = np.random.default_rng(41)
    signers = [RefSigner(bytes([i + 70]) * 32) for i in range(4)]
    items = []
    for i in range(9):
        s = signers[i % 4]
        msg = rng.bytes(int(rng.integers(1, 40)))
        sig = s.sign(msg)
        if i == 2:       # R bit flipped
            sig = bytes([sig[0] ^ 8]) + sig[1:]
        if i == 5:       # S bit flipped (stays < L)
            sig = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
        if i == 7:       # message changed after signing
            msg = msg + b"!"
        items.append((msg, sig, s.verkey))
    msg, sig, _ = items[0]
    for bad in ((2).to_bytes(32, "little"), bytes(32),
                (P + 1).to_bytes(32, "little")):
        items.append((msg, sig, bad))
    return items


_ITEMS = _items()
_WANT = CpuEd25519Verifier().verify_batch(_ITEMS)


def _lanes(arrays, lane_axes):
    """Pad the staged per-signature arrays to N_LANES lanes (repeating
    lane 0, as the sharded verifier pads) and stack N_INST instances:
    lane axis `ax` becomes (N_INST, N_LANES)."""
    out = []
    for a, ax in zip(arrays, lane_axes):
        if ax is None:                         # replicated: keys / key rows
            out.append(a)
            continue
        m = a.shape[ax]
        pad = a.index_select(ax, torch.zeros(N_LANES - m, dtype=torch.long))
        a = torch.cat([a, pad], dim=ax)
        a = torch.stack([a] * N_INST, dim=ax)
        out.append(a.contiguous())
    return out


def _grid(dispatch):
    v = TorchEd25519Verifier(device="cpu")
    if dispatch == "bytes":
        idxs, staged = v.stage_bytes(_ITEMS)
        return _lanes(staged, (0, 0, None, 0, 0)), idxs
    idxs, staged = v.stage_limbs(_ITEMS)
    staged = [torch.from_numpy(np.ascontiguousarray(a)) for a in staged]
    return _lanes(staged, (1, 2, None, 0, 0, 0)), idxs


def _leaves(n):
    rng = np.random.default_rng(n)
    return rng.integers(0, 2**32, size=(n, 8), dtype=np.uint64).astype(np.uint32)


def _hash_root(digests):
    hs = list(digests)
    while len(hs) > 1:
        hs = [hashlib.sha256(b"\x01" + hs[i] + hs[i + 1]).digest()
              for i in range(0, len(hs), 2)]
    return hs[0]


@pytest.mark.parametrize("n_shards", [8, 6])
@pytest.mark.parametrize("dispatch", ["bytes", "limbs"])
def test_plane_on_cpu_shards_matches_reference(n_shards, dispatch):
    mesh = make_mesh(n_shards, ["cpu"] * n_shards)
    assert (mesh.shape["inst"], mesh.shape["sig"]) == \
        ref_mesh_shape_for(n_shards) == ({8: (2, 4), 6: (2, 3)}[n_shards])
    arrays, idxs = _grid(dispatch)
    leaves = _leaves(2 * n_shards)
    plane = ShardedCryptoPlane(mesh)
    step = plane.step_bytes if dispatch == "bytes" else plane.step
    before = dict(ops.LAUNCHES)
    ok, root, n_ok = step(*arrays, sha.to_tensor(leaves, "cpu"))
    assert ops.LAUNCHES == before              # CPU tensors: plain versions
    assert ok.shape == (N_INST, N_LANES) and ok.dtype == torch.bool
    for inst in range(N_INST):
        got = np.zeros(len(_ITEMS), dtype=bool)
        got[idxs] = ok[inst, :len(idxs)].numpy()
        assert got.tolist() == _WANT.tolist()
        # pad lanes repeat lane 0
        assert ok[inst, len(idxs):].tolist() == \
            [bool(ok[inst, 0])] * (N_LANES - len(idxs))
    assert int(n_ok) == int(ok.sum())
    # the root: per-shard subtrees, then the shard roots padded to a
    # power of two by repeating the last
    digests = sha.digests_to_bytes(leaves)
    shard_roots = [_hash_root(digests[2 * k:2 * k + 2]) for k in range(n_shards)]
    padded = shard_roots + shard_roots[-1:] * (8 - n_shards)
    want = np.asarray(ref_sha.merkle_reduce_pow2(
        jnp.asarray(sha.bytes_to_digests(padded))))
    assert root.numpy().view(np.uint32).tolist() == want.tolist()
    assert sha.digests_to_bytes(root[None]) == [_hash_root(padded)]
    if n_shards == 8:                          # a complete tree
        assert sha.digests_to_bytes(root[None]) == [_hash_root(digests)]


def test_mesh_cuts_a_process_block_by_spec():
    """Mesh.shard on one process's lanes of a (2, 4) mesh: rank 1 of two
    drives lanes 4..7, the second "inst" row, and gets its row block cut
    into one block per lane, as the reference's PartitionSpec places
    it; a run of lanes that is no block of the grid raises, and so does
    a verifier over a mesh in a process group."""
    mesh = make_mesh(8, ["cpu"] * 8)
    mesh.local = slice(4, 8)
    assert mesh.local_grid() == (1, 4)
    grid = torch.arange(4 * 3).reshape(1, 4, 3)       # this rank's row
    assert [b.tolist() for b in mesh.shard(grid, ("inst", "sig", None))] \
        == [grid[:, k:k + 1].tolist() for k in range(4)]
    leaves = torch.arange(8 * 2).reshape(8, 2)
    assert [b.tolist() for b in mesh.shard(leaves, (("inst", "sig"), None))] \
        == [leaves[2 * k:2 * k + 2].tolist() for k in range(4)]
    assert all(torch.equal(b, grid) for b in mesh.shard(grid, None))
    mesh.local = slice(2, 4)
    assert mesh.local_grid() == (1, 2)
    mesh.local = slice(2, 5)
    with pytest.raises(ValueError):
        mesh.local_grid()
    # a verifier dispatches one process's traffic: not over a group
    mesh.local, mesh.in_group = slice(0, 8), True
    with pytest.raises(ValueError, match="every rank"):
        ShardedTorchEd25519Verifier(ShardedCryptoPlane(mesh))


def test_plane_rejects_grids_that_do_not_tile():
    plane = ShardedCryptoPlane(make_mesh(6, ["cpu"] * 6))
    (s, h, k, idx, r), _ = _grid("bytes")
    leaves = sha.to_tensor(_leaves(12), "cpu")
    with pytest.raises(ValueError):
        plane.step_bytes(s[:, :10], h[:, :10], k, idx[:, :10], r[:, :10], leaves)
    with pytest.raises(ValueError):            # 3 leaves per shard
        plane.step_bytes(s, h, k, idx, r, sha.to_tensor(_leaves(18), "cpu"))


@pytest.mark.parametrize("dispatch", ["bytes", "limbs"])
def test_torch_sharded_verifier_matches_cpu(dispatch):
    v = make_verifier("torch-sharded", supervised=False)
    assert v._plane.mesh.shape == {"inst": 2, "sig": 2}
    v._compressed_dispatch = dispatch == "bytes"
    assert v.verify_batch(_ITEMS).tolist() == _WANT.tolist()
    assert v.dispatches == 1
    # limb staging screens the three invalid keys on the host
    assert len(v._pt_cache) == (0 if dispatch == "bytes" else 7)
    v.rewarm()
    assert v.rewarms == 1 and not v._pt_cache


def test_sharded_verifier_pads_to_a_power_of_two():
    v = make_sharded_verifier(min_batch=8, devices=["cpu"] * 2)
    assert v._min_batch == 8
    assert v._pad_sizes(3, 2) == (8, 8) and v._pad_sizes(9, 70) == (16, 16)
    idxs, staged = v.stage_bytes(_ITEMS[:5])
    assert idxs == list(range(5)) and staged[0].shape == (8, 32)
    assert staged[2].shape == (8, 32)          # 4 keys, padded with key 0
    # the single-device verifier does not pad
    _, plain = TorchEd25519Verifier(device="cpu").stage_bytes(_ITEMS[:5])
    assert plain[0].shape == (5, 32) and plain[2].shape == (4, 32)


def test_mesh_and_roster():
    for n in range(1, 17):
        assert mesh_shape_for(n) == ref_mesh_shape_for(n)
    roster = lane_roster(5, ["cpu", "meta"])
    assert [d.type for d in roster] == ["cpu", "meta", "cpu", "meta", "cpu"]
    assert lane_roster(None, ["cpu"]) == [torch.device("cpu")]
    mesh = make_mesh(None, ["cpu"] * 6)
    assert mesh.devices.shape == (2, 3) and mesh.size == 6
    # a roster of 6 is trimmed to its largest power of two
    assert make_sharded_verifier(devices=["cpu"] * 6)._plane.mesh.size == 4
    with pytest.raises(ValueError):                # sig = 3
        ShardedTorchEd25519Verifier(ShardedCryptoPlane(mesh))


def test_cuda_backends_raise_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for backend in ("cuda-sharded", "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_verifier(backend)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(2, ["cuda", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(4)


def test_graft_entry_on_cpu_matches_reference():
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "ref_graft_entry", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "__graft_entry__.py"))
    ref_graft = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_graft)
    fn, args = graft_entry.entry("cpu")
    want_args = ref_graft._example_batch(8, n_keys=4) + \
        (ref_graft._example_leaves(16),)
    for got, want in zip(args, want_args):
        assert got.device.type == "cpu"
        assert np.array_equal(got.numpy().view(want.dtype), want)
    ok, root = fn(*args)
    assert ok.tolist() == [True] * 8
    want_root = np.asarray(ref_sha.merkle_reduce_pow2(jnp.asarray(want_args[-1])))
    assert root.numpy().view(np.uint32).tolist() == want_root.tolist()


def test_dryrun_multichip_on_cpu_roster():
    """Four shards on a roster of one CPU device, wrapped."""
    ok, root, n_ok = graft_entry.dryrun_multichip(4, ["cpu"])
    assert ok.shape == (2, 2) and bool(ok.all()) and int(n_ok) == 4
    leaves = sha.digests_to_bytes(graft_entry._example_leaves(8))
    assert sha.digests_to_bytes(root[None]) == [_hash_root(leaves)]


def test_parallel_package_imports_nothing_eagerly():
    """The package's __init__ imports no submodule at its top level (the
    reference's imports the SPMD plane eagerly), and the mesh module
    needs neither the plane nor the verifier."""
    import ast
    import plenum_tpu_torch.parallel as par
    import plenum_tpu_torch.parallel.mesh as mesh_mod
    for mod, banned in ((par, ("plenum_tpu_torch",)),
                        (mesh_mod, ("plenum_tpu_torch.parallel.crypto_plane",
                                    "plenum_tpu_torch.crypto"))):
        with open(mod.__file__) as fh:
            tree = ast.parse(fh.read())
        for node in tree.body:                 # module level only
            if isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            elif isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            else:
                continue
            assert not any(n.startswith(banned) for n in names), \
                (mod.__name__, names)
    assert par.ShardedCryptoPlane is ShardedCryptoPlane
    assert par.make_mesh is make_mesh


# --- against the reference's plane (minutes of XLA compile on a CPU) -------

@pytest.mark.slow
@pytest.mark.parametrize("dispatch", ["bytes", "limbs"])
def test_plane_matches_jax_sharded_plane(dispatch):
    """dryrun_multichip's inputs through both planes on 8 shards (the
    reference on its 8 virtual devices)."""
    import jax
    from plenum_tpu.crypto.ed25519 import JaxEd25519Verifier
    from plenum_tpu.parallel import ShardedCryptoPlane as RefPlane
    from plenum_tpu.parallel import make_mesh as ref_make_mesh
    inst, sig = mesh_shape_for(8)
    s_u8, h_u8, k_u8, idx, r_u8 = graft_entry._example_batch(8, n_keys=4)
    items = []
    seeds = [hashlib.sha256(b"graft-key-%d" % k).digest() for k in range(4)]
    for i in range(8):
        msg = b"plenum_tpu graft example %d" % i
        sig_b = r_u8[i].tobytes() + s_u8[i].tobytes()
        items.append((msg, sig_b, RefSigner(seeds[i % 4]).verkey))
    leaves = graft_entry._example_leaves(16)
    ref_plane = RefPlane(ref_make_mesh(8))
    plane = ShardedCryptoPlane(make_mesh(8, ["cpu"] * 8))
    leaves_t = sha.to_tensor(leaves, "cpu")
    if dispatch == "bytes":
        args = (s_u8.reshape(inst, sig, 32), h_u8.reshape(inst, sig, 32), k_u8,
                idx.reshape(inst, sig), r_u8.reshape(inst, sig, 32))
        want = ref_plane.step_bytes(*(jnp.asarray(a) for a in args),
                                    jnp.asarray(leaves))
        got = plane.step_bytes(*(torch.from_numpy(np.array(a)) for a in args),
                               leaves_t)
    else:
        ref_v = JaxEd25519Verifier()
        ref_v._compressed_dispatch = False
        v = TorchEd25519Verifier(device="cpu")
        idxs, (sd, hd, aq, ix, ry, rs) = v.stage_limbs(items)
        assert idxs == list(range(8))
        args = (sd.reshape(32, inst, sig), hd.reshape(16, 4, inst, sig), aq,
                ix.reshape(inst, sig), ry.reshape(inst, sig, 20),
                rs.reshape(inst, sig))
        want = ref_plane.step(*(jnp.asarray(a) for a in args),
                              jnp.asarray(leaves))
        got = plane.step(*(torch.from_numpy(np.ascontiguousarray(a))
                           for a in args), leaves_t)
    jax.block_until_ready(want)
    assert got[0].tolist() == np.asarray(want[0]).tolist()
    assert got[1].numpy().view(np.uint32).tolist() == np.asarray(want[1]).tolist()
    assert int(got[2]) == int(want[2]) == 8


# --- on real cards -----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dispatch", ["bytes", "limbs"])
def test_plane_on_cards_matches_cpu_shards(cuda_device, dispatch):
    """The plane over every card (wrapped to 4 shards on a one-card
    host) against the same grid on 4 CPU shards."""
    roster = lane_roster(4)
    arrays, _ = _grid(dispatch)
    leaves = sha.to_tensor(_leaves(8), "cpu")
    cpu = ShardedCryptoPlane(make_mesh(4, ["cpu"] * 4))
    card = ShardedCryptoPlane(make_mesh(4, roster))
    step_cpu = cpu.step_bytes if dispatch == "bytes" else cpu.step
    step_card = card.step_bytes if dispatch == "bytes" else card.step
    want = step_cpu(*arrays, leaves)
    got = step_card(*(a.to(roster[0]) for a in arrays), leaves.to(roster[0]))
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    assert int(got[2]) == int(want[2])


@pytest.mark.gpu
def test_plane_across_cards(cuda_device):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more GPUs")
    n = torch.cuda.device_count()
    ok, root, n_ok = graft_entry.dryrun_multichip(n)
    want_ok, want_root, want_n = graft_entry.dryrun_multichip(n, ["cpu"])
    assert torch.equal(ok.cpu(), want_ok) and torch.equal(root.cpu(), want_root)
    assert int(n_ok) == int(want_n)
