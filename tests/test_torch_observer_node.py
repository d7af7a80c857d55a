"""The port's copy of tests/test_observer_node.py, run on plenum_tpu_torch
(validator processes on the `cpu` backend; the observer's components on
`cpu`, restarted on `torch`: the kernels' plain versions reach the same
roots).

Deployable observer: a follower process with its own transport that
subscribes to a LIVE TCP pool, applies pushed batches under an f+1 push
quorum, and — after being killed and restarted — catches up unaided by
pulling the gap over its own GET_TXN queries.

Reference behavior under test: plenum/server/observer/observer_node.py (a
self-contained follower with storage + transport + sync policy).
"""
from __future__ import annotations

import asyncio
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import pytest

from plenum_tpu_torch.common.node_messages import DOMAIN_LEDGER_ID, POOL_LEDGER_ID


@pytest.fixture
def tcp_pool_4():
    pytest.importorskip(
        "cryptography",
        reason="the TCP node stack's handshake needs the cryptography package")
    from plenum_tpu_torch.tools.tcp_pool import REPO, setup_pool_dir, _wait_all_started
    import os

    from test_torch_tools import retry_port_race

    names = [f"Node{i + 1}" for i in range(4)]
    trustee_seed = b"obs-pool-trustee".ljust(32, b"\0")
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    procs = []

    def stop(tmp):
        for p in procs:
            p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()
        procs.clear()
        shutil.rmtree(tmp, ignore_errors=True)

    def start():
        tmp = tempfile.mkdtemp(prefix="plenum_obs_pool_")
        specs = setup_pool_dir(tmp, names, trustee_seed)
        procs.extend(subprocess.Popen(
            [sys.executable, "-m", "plenum_tpu_torch.tools.start_node",
             "--name", name, "--base-dir", tmp, "--kv", "memory",
             "--backend", "cpu"],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT) for name in names)
        try:
            _wait_all_started(procs, deadline_s=60.0)
        except BaseException:
            stop(tmp)
            raise
        return tmp, specs

    tmp, specs = retry_port_race(start)
    try:
        yield tmp, names, specs, trustee_seed
    finally:
        stop(tmp)


def _signed_nyms(trustee_seed, tags):
    from plenum_tpu_torch.client.wallet import Wallet
    from plenum_tpu_torch.execution.txn import NYM

    wallet = Wallet("obs-test")
    trustee = wallet.add_identifier(seed=trustee_seed)
    reqs = []
    for tag in tags:
        user = wallet.add_identifier(seed=tag.encode().ljust(32, b"\0")[:32])
        reqs.append(wallet.sign_request(
            {"type": NYM, "dest": user, "verkey": wallet.verkey_of(user)},
            identifier=trustee))
    return reqs


async def _drive(addrs, f, requests):
    from plenum_tpu_torch.client.pipelined import PipelinedPoolClient
    client = PipelinedPoolClient(addrs, f)
    done, _ = await client.drive(requests, window=50, timeout=60.0)
    assert len(done) == len(requests)


async def _wait_for(predicate, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        await asyncio.sleep(0.2)
    return False


def test_observer_follows_live_pool_and_catches_up_after_restart(tcp_pool_4):
    from plenum_tpu_torch.node.observer_node import ObserverNode
    from plenum_tpu_torch.tools.genesis import load_genesis_files

    tmp, names, specs, trustee_seed = tcp_pool_4
    genesis = load_genesis_files(tmp)
    addrs = {name: ("127.0.0.1", spec[3])
             for name, spec in zip(names, specs)}
    obs_dir = tempfile.mkdtemp(prefix="plenum_obs_data_")

    async def scenario():
        # phase 1: observer follows live traffic via pushes
        stop = asyncio.Event()
        obs = ObserverNode("observer1", genesis, addrs, f=1,
                           data_dir=obs_dir, storage_backend="file",
                           crypto_backend="cpu")
        task = asyncio.create_task(obs.run(stop))
        await asyncio.sleep(1.0)                 # registrations land
        await _drive(addrs, 1, _signed_nyms(trustee_seed,
                                            [f"obs-a{i}" for i in range(5)]))
        ledger = obs.observer.c.db.get_ledger(DOMAIN_LEDGER_ID)
        assert await _wait_for(lambda: ledger.size >= 6), \
            f"observer never applied pushes (size={ledger.size})"
        live_root = ledger.root_hash

        # phase 2: kill the observer (no clean shutdown of its stores),
        # order traffic it never sees...
        stop.set()
        await task
        await _drive(addrs, 1, _signed_nyms(trustee_seed,
                                            [f"obs-b{i}" for i in range(5)]))

        # phase 3: restart from its own data dir; the first push after
        # restart carries roots binding the whole gap, which the observer
        # fills with its OWN GET_TXN pulls — no helper callback
        stop2 = asyncio.Event()
        obs2 = ObserverNode("observer1", genesis, addrs, f=1,
                            data_dir=obs_dir, storage_backend="file",
                            crypto_backend="torch")
        ledger2 = obs2.observer.c.db.get_ledger(DOMAIN_LEDGER_ID)
        assert ledger2.size >= 6                 # durable recovery
        task2 = asyncio.create_task(obs2.run(stop2))
        await asyncio.sleep(1.0)
        await _drive(addrs, 1, _signed_nyms(trustee_seed, ["obs-c0"]))
        ok = await _wait_for(lambda: ledger2.size >= 12)
        stop2.set()
        await task2
        assert ok, f"observer did not catch up (size={ledger2.size})"
        assert ledger2.size == 12                # 1 genesis + 5 + 5 + 1
        assert ledger2.root_hash != live_root

    try:
        asyncio.run(scenario())
    finally:
        shutil.rmtree(obs_dir, ignore_errors=True)


def test_gap_vote_buffer_bounded_per_validator():
    """A Byzantine validator minting ever-new seq_no_start values must hold
    at most ONE gap-vote bucket per ledger; honest f+1 quorum still arms."""
    from unittest.mock import MagicMock

    from plenum_tpu_torch.common.node_messages import BatchCommitted
    from plenum_tpu_torch.node.observer_node import ObserverNode

    def mk(start):
        return BatchCommitted(requests=(), ledger_id=1, inst_id=0, view_no=0,
                              pp_seq_no=start, pp_time=0.0,
                              state_root="00" * 32, txn_root="00" * 32,
                              seq_no_start=start, seq_no_end=start)

    obs = ObserverNode.__new__(ObserverNode)
    obs._gap_votes = {}
    inner = MagicMock()
    inner.f = 1
    ledger = MagicMock()
    ledger.size = 0
    inner.c.db.get_ledger.return_value = ledger
    obs.observer = inner

    for start in range(100, 1100):
        obs._gap_quorum("Evil", mk(start))
    assert len(obs._gap_votes) == 1

    assert not obs._gap_quorum("A", mk(50))
    assert obs._gap_quorum("B", mk(50))


def _mk_batch(start, multi_sig=None):
    from plenum_tpu_torch.common.node_messages import BatchCommitted
    return BatchCommitted(requests=(), ledger_id=1, inst_id=0, view_no=0,
                          pp_seq_no=start, pp_time=0.0,
                          state_root="00" * 32, txn_root="00" * 32,
                          seq_no_start=start, seq_no_end=start,
                          multi_sig=multi_sig)


def test_gap_quorum_ignores_multi_sig_variation():
    """Two validators pushing the SAME gapped batch with DIFFERENT
    multi-sig attachments (honest aggregation subsets differ) must still
    arm the f+1 gap-fill — the advisory sig is excluded from the content
    digest."""
    from unittest.mock import MagicMock

    from plenum_tpu_torch.node.observer_node import ObserverNode

    obs = ObserverNode.__new__(ObserverNode)
    obs._gap_votes = {}
    inner = MagicMock()
    inner.f = 1
    ledger = MagicMock()
    ledger.size = 0
    inner.c.db.get_ledger.return_value = ledger
    obs.observer = inner

    ms_a = ("sigA", ["Node1", "Node2", "Node3"],
            [1, "aa" * 32, "bb" * 32, "cc" * 32, 1.0])
    ms_b = ("sigB", ["Node2", "Node3", "Node4"],
            [1, "aa" * 32, "bb" * 32, "cc" * 32, 1.0])
    assert not obs._gap_quorum("A", _mk_batch(50, multi_sig=ms_a))
    assert obs._gap_quorum("B", _mk_batch(50, multi_sig=ms_b))


def test_push_quorum_ignores_multi_sig_variation_in_node_observer():
    """Same property on the live-push path (NodeObserver.process_batch):
    content-identical batches with different multi-sigs converge; a
    batch with DIFFERENT CONTENT still does not."""
    import dataclasses

    from plenum_tpu_torch.client.wallet import Wallet
    from plenum_tpu_torch.execution.txn import NYM
    from plenum_tpu_torch.node.bootstrap import NodeBootstrap
    from plenum_tpu_torch.node.observer import NodeObserver
    from test_torch_pool import make_genesis

    genesis, _trustee = make_genesis(["Alpha", "Beta", "Gamma", "Delta"])
    obs = NodeObserver(NodeBootstrap(
        "obsq", genesis_txns=genesis, crypto_backend="cpu").build(), f=1)

    wallet = Wallet("w")
    trustee_id = wallet.add_identifier(
        seed=b"trustee-seed".ljust(32, b"\0"))
    user = wallet.add_identifier(seed=b"obs-quorum-user".ljust(32, b"\0"))
    req = wallet.sign_request(
        {"type": NYM, "dest": user, "verkey": wallet.verkey_of(user)},
        identifier=trustee_id)

    # derive the true post-batch roots on a TWIN replica: apply
    # uncommitted, read the roots, revert — the pushed batch must cite
    # roots the observer's own recomputation reproduces
    twin = NodeBootstrap("twin", genesis_txns=genesis,
                         crypto_backend="cpu").build()
    roots = twin.write_manager.apply_batch(1, [req], 1.0, 0, 1)[2]
    twin.write_manager.revert_last_batch(1)
    txn_root, state_root = roots["txn_root"], roots["state_root"]

    real = dataclasses.replace(
        _mk_batch(2), requests=(req.to_dict(),), ledger_id=1,
        pp_seq_no=1, pp_time=1.0, txn_root=txn_root,
        state_root=state_root)
    ms_a = ("sigA", ["Alpha", "Beta", "Gamma"],
            [1, state_root, "bb" * 32, txn_root, 1.0])
    ms_b = ("sigB", ["Beta", "Gamma", "Delta"],
            [1, state_root, "bb" * 32, txn_root, 1.0])
    assert not obs.process_batch(
        dataclasses.replace(real, multi_sig=ms_a), frm="Alpha")
    # different content from Beta must NOT complete Alpha's quorum
    assert not obs.process_batch(
        dataclasses.replace(real, pp_time=2.0, multi_sig=ms_a),
        frm="Beta")
    # same content, different multi-sig: quorum completes, batch applies
    assert obs.process_batch(
        dataclasses.replace(real, multi_sig=ms_b), frm="Gamma")
    assert obs.c.db.get_ledger(1).size == 2


def test_observer_node_genesis_bls_keys():
    from plenum_tpu_torch.node.observer_node import ObserverNode
    from test_torch_pool import make_genesis
    genesis, _ = make_genesis(["Alpha", "Beta"])
    keys = ObserverNode._genesis_bls_keys(genesis)
    assert set(keys) == {"Alpha", "Beta"}
    assert all(isinstance(v, str) and v for v in keys.values())
