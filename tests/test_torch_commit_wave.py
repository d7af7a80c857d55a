"""The commit wave (plenum_tpu_torch/parallel/commit_wave.py) over the
ledger's deferred hashing (Ledger.append_txns_to_uncommitted(...,
defer_hash=True), uncommitted_root_staged), held to the reference: the
same seeded txns staged on four co-hosted replicas of each package and
drained by one wave per batch give the same roots, proofs and ring
counters. The port's ring hashes on the torch backend (K1 and the fused
wave's plain versions on the CPU); the reference's on hashlib."""
import random

import pytest

from plenum_tpu.ledger.compact_merkle_tree import \
    CompactMerkleTree as RefTree
from plenum_tpu.ledger.ledger import Ledger as RefLedger
from plenum_tpu.parallel import commit_wave as ref_commit_wave
from plenum_tpu.parallel import pipeline as ref_pipeline
from plenum_tpu_torch.crypto.ed25519 import TorchEd25519Verifier
from plenum_tpu_torch.ledger.compact_merkle_tree import CompactMerkleTree
from plenum_tpu_torch.ledger.ledger import Ledger, txn_to_leaf
from plenum_tpu_torch.ledger.merkle_verifier import MerkleVerifier
from plenum_tpu_torch.ledger.tree_hasher import TreeHasher
from plenum_tpu_torch.parallel import commit_wave
from plenum_tpu_torch.parallel.pipeline import CryptoPipeline

_REPLICAS = 4


class _NoBls:
    def batch_verify(self, items):
        raise AssertionError("no BLS on the commit path")


def _txns(rng, n, tag):
    return [{"type": "1", "dest": "did:%s:%d" % (tag, i),
             "verkey": rng.randbytes(8).hex(), "seq": rng.randrange(10**6)}
            for i in range(n)]


def _drain(pipe, wave_mod, ledgers):
    wave = wave_mod.CommitWave(pipe)
    for i, led in enumerate(ledgers):
        wave.add("domain%d" % i, led.uncommitted_root_staged())
    return wave.run()


def _run(seed, pipe, wave_mod, make_ledger):
    """Rounds of: stage on every replica with defer_hash=True (sometimes a
    second batch staged behind an already-hashed shadow, sometimes a host
    read racing the wave), one wave over the four families, commit ->
    per round the wave's roots and the committed roots."""
    rng = random.Random(seed)
    ledgers = [make_ledger() for _ in range(_REPLICAS)]
    base = _txns(rng, 37, "base")
    for led in ledgers:
        led.append_batch(base)
    out = []
    for rnd in range(6):
        batch = _txns(rng, rng.randint(1, 70), "r%d" % rnd)
        for led in ledgers:
            root, size = led.append_txns_to_uncommitted(batch,
                                                        defer_hash=True)
            assert root is None and size == led.size + len(batch)
        if rnd % 3 == 1:        # a host read before the wave folds leaves in
            out.append([ledgers[0].uncommitted_root_hash])
        roots = _drain(pipe, wave_mod, ledgers)
        if rnd % 2:             # a second batch behind the hashed shadow
            more = _txns(rng, rng.randint(1, 20), "m%d" % rnd)
            for led in ledgers:
                led.append_txns_to_uncommitted(more, defer_hash=True)
            roots2 = _drain(pipe, wave_mod, ledgers)
            batch = batch + more
        else:
            roots2 = {}
        n = len(batch)
        for led in ledgers:
            if rnd == 4:        # revert the tail, then commit the rest
                led.discard_txns(n // 2)
            led.commit_txns(led.uncommitted_size - led.size)
        out.append([sorted(roots.items()), sorted(roots2.items()),
                    [led.root_hash for led in ledgers],
                    [led.size for led in ledgers]])
    return out, ledgers


@pytest.mark.parametrize("seed,sha_device", [(1, False), (2, False),
                                             (1, True)])
def test_commit_wave_matches_reference(seed, sha_device):
    """sha_device=False: both rings on hashlib, every counter equal.
    sha_device=True: the port hashes on its device path (K1, fused waves)
    and takes fewer SHA lane items than the reference's hashlib path
    (fused waves, not a flush per level); roots, proofs and the commit
    wave's counters stay the reference's."""
    ref_pipe = ref_pipeline.CryptoPipeline(bls_inner=_NoBls())
    ref_out, ref_ledgers = _run(
        seed, ref_pipe, ref_commit_wave,
        lambda: RefLedger(RefTree(ref_pipe.tree_hasher())))
    port_pipe = CryptoPipeline(ed_inner=TorchEd25519Verifier(device="cpu"),
                               sha_device=sha_device, sha_min_device=8)
    port_out, port_ledgers = _run(
        seed, port_pipe, commit_wave,
        lambda: Ledger(CompactMerkleTree(port_pipe.tree_hasher())))
    assert port_out == ref_out
    cmt = {k: v for k, v in port_pipe.stats.items() if k.startswith("cmt_")}
    assert cmt == {k: v for k, v in ref_pipe.stats.items()
                   if k.startswith("cmt_")}
    if not sha_device:
        assert port_pipe.stats == ref_pipe.stats
    else:
        # the port's ring really hashed on its device path
        assert ("merkle", 64) in port_pipe._shapes and \
            any(k[0] == "sha" for k in port_pipe._shapes)
    assert cmt["cmt_waves"] == cmt["cmt_levels"] == 9
    # one hlev job per pending replica per wave (the replica whose host
    # read folded its leaves in has none), deduped to one hash level
    assert cmt["cmt_unique"] == 9 and cmt["cmt_items"] == 9 * _REPLICAS - 2
    assert cmt["cmt_host_fallbacks"] == 0
    for ref, port in zip(ref_ledgers, port_ledgers):
        assert port.root_hash == ref.root_hash and port.size == ref.size
        for seq in (1, port.size // 2, port.size):
            assert port.merkle_info(seq) == ref.merkle_info(seq)


def test_deferred_root_equals_eager_root():
    """Within the port: a replica staged with defer_hash=True and drained
    by the wave reaches the eager uncommitted root, round after round,
    and its committed leaves prove inclusion."""
    rng = random.Random(9)
    pipe = CryptoPipeline(ed_inner=TorchEd25519Verifier(device="cpu"),
                          sha_device=True, sha_min_device=8)
    deferred = Ledger(CompactMerkleTree(pipe.tree_hasher()))
    eager = Ledger(CompactMerkleTree(TreeHasher()))
    for rnd in range(5):
        batch = _txns(rng, rng.randint(1, 40), "e%d" % rnd)
        want, _ = eager.append_txns_to_uncommitted(batch)
        deferred.append_txns_to_uncommitted(batch, defer_hash=True)
        roots = _drain(pipe, commit_wave, [deferred])
        assert roots == {"domain0": want}
        assert deferred.uncommitted_root_hash == want
        eager.commit_txns(len(batch))
        _, infos = deferred.commit_txns(len(batch))
        assert deferred.root_hash == eager.root_hash == want
        k = rng.randrange(len(batch))
        path = [bytes.fromhex(h) for h in infos[k]["auditPath"]]
        assert MerkleVerifier().verify_inclusion(
            txn_to_leaf(batch[k]), infos[k]["seqNo"] - 1, deferred.size,
            path, deferred.root_hash)
    # a clean ledger's family resolves without a level
    assert _drain(pipe, commit_wave, [deferred]) == \
        {"domain0": deferred.root_hash}

