"""The port's copy of tests/test_multihost.py: the multi-host plane with
REAL multiple processes, on torch.distributed.

Two OS processes join one `gloo` process group over a localhost address,
each driving 4 explicit CPU lanes of one 8-lane global mesh. They run the
crypto plane's collective pattern through `global_mesh` +
`shard_host_batch` (per-shard reductions, an all_gather of the partials,
an all_reduce of the shard count), then the plane itself: each process
passes its row of a [2, 4] grid of signatures and its half of 16 leaves
to `ShardedCryptoPlane(global_mesh()).step_bytes`, and gets back its row
of verdicts and the job's root and count, held to the reference's
verifier and Merkle reduction. The card's group is `nccl`, which refuses
two ranks on one GPU: on one H100 the group has world size 1
(chip_smoke.py path H3), so the two-process case runs on `gloo` only."""
import hashlib
import json
import os
import socket
import subprocess
import sys

import pytest

_WORKER = r"""
import hashlib, json, sys
rank = int(sys.argv[1]); port = sys.argv[2]
import numpy as np
import torch
import torch.distributed as dist
from plenum_tpu_torch.parallel.multihost import (global_mesh, init_multihost,
                                                 process_count,
                                                 shard_host_batch)
pre = init_multihost(coordinator="127.0.0.1:" + port, num_processes=2,
                     process_id=rank, backend="gloo")
assert process_count() == 2 and set(pre) >= {"build_dir", "warm"}
mesh = global_mesh(devices=["cpu"] * 4)     # spans both processes' lanes
assert mesh.size == 8 and mesh.in_group, mesh.shape
lanes = mesh.flat[mesh.local]
assert mesh.local == slice(4 * rank, 4 * rank + 4) and len(lanes) == 4

# each "host" stages its local half of a [8, 16] batch (values encode the
# global row index so misplacement is detectable)
local = np.arange(4 * 16, dtype=np.float32).reshape(4, 16) + rank * 64
blocks = shard_host_batch(mesh, local, (("inst", "sig"), None))
assert [tuple(b.shape) for b in blocks] == [(1, 16)] * 4
assert [b.device for b in blocks] == lanes

# the plane's collective pattern: per-shard reduction on each lane,
# all_gather of the partials, a sum of the shard counts
part = torch.stack([b.sum() for b in blocks])
gathered = [torch.zeros_like(part) for _ in range(process_count())]
dist.all_gather(gathered, part)
parts = torch.cat(gathered)
n = torch.tensor(len(lanes), dtype=torch.int32)
dist.all_reduce(n)
want = np.arange(128, dtype=np.float32).reshape(8, 16).sum(axis=1)
assert np.allclose(parts.numpy(), want), parts
assert int(n) == 8
print("RANK_OK", rank, flush=True)

# the plane over the job: a [2, 4] grid of signatures (item 5 forged)
# and 16 leaves; this host holds grid row `rank` and leaves 8 rank ..
from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer, TorchEd25519Verifier
from plenum_tpu_torch.ops import sha256 as sha
from plenum_tpu_torch.parallel.crypto_plane import (STEP_BYTES_SPECS,
                                                    ShardedCryptoPlane)
signers = [Ed25519Signer(seed=bytes([90 + k]) * 32) for k in range(2)]
items = []
for i in range(8):
    msg = b"multihost %d" % i
    sig = signers[i % 2].sign(msg)
    if i == 5:
        sig = sig[:32] + bytes(32)         # S = 0 < L: it reaches the lane
    items.append((msg, sig, signers[i % 2].verkey))
idxs, (s, h, k, ix, r) = TorchEd25519Verifier(device="cpu").stage_bytes(items)
assert idxs == list(range(8))
leaves = sha.to_tensor(sha.bytes_to_digests(
    [hashlib.sha256(b"leaf %d" % i).digest() for i in range(16)]), "cpu")
row = slice(rank, rank + 1)
host = (s.reshape(2, 4, 32)[row], h.reshape(2, 4, 32)[row], k,
        ix.reshape(2, 4)[row], r.reshape(2, 4, 32)[row],
        leaves[8 * rank:8 * rank + 8])
ok, root, n_ok = ShardedCryptoPlane(mesh).step_bytes(*(
    shard_host_batch(mesh, a.numpy(), spec)
    for a, spec in zip(host, STEP_BYTES_SPECS)))
dist.destroy_process_group()
print("PLANE " + json.dumps({
    "ok": ok.tolist(), "root": root.numpy().view(np.uint32).tolist(),
    "n_ok": int(n_ok),
    "items": [[m.hex(), g.hex(), v.hex()] for m, g, v in items]}), flush=True)
"""


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' output, the group joined once for the module."""
    tmp_path = tmp_path_factory.mktemp("multihost")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), port],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        cwd=str(tmp_path)) for r in range(2)]
    outs = []
    try:
        for r, p in enumerate(procs):
            out, _ = p.communicate(timeout=180)
            outs.append(out.decode())
            assert p.returncode == 0, f"rank{r} failed:\n{outs[-1]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def test_two_process_gloo_group_on_cpu_lanes(two_ranks):
    assert "RANK_OK 0" in two_ranks[0]
    assert "RANK_OK 1" in two_ranks[1]


def test_two_process_plane_on_gloo_is_the_references(two_ranks):
    """Each rank's verdict row, and the job's root and count, equal the
    reference's verifier and Merkle reduction over the whole grid."""
    import jax.numpy as jnp
    import numpy as np

    from plenum_tpu.crypto.ed25519 import CpuEd25519Verifier
    from plenum_tpu.ops import sha256 as ref_sha

    got = [json.loads(next(line[len("PLANE "):] for line in out.splitlines()
                           if line.startswith("PLANE ")))
           for out in two_ranks]
    assert got[0]["items"] == got[1]["items"]
    items = [tuple(bytes.fromhex(x) for x in it) for it in got[0]["items"]]
    want = [bool(v) for v in CpuEd25519Verifier().verify_batch(items)]
    assert want == [i != 5 for i in range(8)]
    want_root = np.asarray(ref_sha.merkle_reduce_pow2(jnp.asarray(
        ref_sha.bytes_to_digests([hashlib.sha256(b"leaf %d" % i).digest()
                                  for i in range(16)])))).tolist()
    for rank, res in enumerate(got):
        assert res["ok"] == [want[4 * rank:4 * rank + 4]]
        assert res["root"] == want_root
        assert res["n_ok"] == sum(want) == 7
