"""The port's pool runner (plenum_tpu_torch/tools/local_pool.py) on the
CPU: run_load's 4-node pool on the `cpu` backend and on the `torch` ring
(the kernels' plain versions behind every client signature, small
buckets) orders every txn with the ledgers agreeing; build_pool takes
the reference's scale-out arms (the multi-device ring on CPU lanes, the
federated ring failing fast on an unreachable crypto host); `cpu` runs
agree with the reference's runner."""
import json

import pytest

from plenum_tpu_torch.tools import local_pool

from test_torch_pool import one_torch_thread  # noqa: F401 (a fixture)

SMALL_RING = dict(PIPELINE_MIN_BUCKET=8)


def test_run_load_cpu_orders_every_txn():
    r = local_pool.run_load(4, 20, "cpu")
    assert r["backend"] == "cpu" and r["nodes"] == 4
    assert r["txns_ordered"] == r["txns_requested"] == 19   # 1 is warm-up
    assert r["ledger_sizes_agree"]
    assert r["tps"] > 0 and r["p50_latency_ms"] <= r["p99_latency_ms"]
    assert "pipeline" not in r and "crypto_plane" not in r
    assert r["commit_stage"]["apply_ms_p50"] > 0
    assert r["controller"]["batch_size"] >= 1


@pytest.mark.usefixtures("one_torch_thread")
def test_run_load_torch_ring_orders_every_txn():
    """The device arm on the CPU: one supervised ring, warmed and pinned
    outside the clock; nothing falls back and no shape goes unpinned."""
    r = local_pool.run_load(4, 9, "torch", config_overrides=SMALL_RING)
    assert r["txns_ordered"] == r["txns_requested"] == 8
    assert r["ledger_sizes_agree"]
    assert r["backend_state"] == "ok"
    plane = r["crypto_plane"]
    assert plane["fallback_batches"] == plane["deadline_misses"] == 0
    assert plane["device_batches"] >= 1
    pipe = r["pipeline"]
    assert pipe["dispatches"] >= 1 and pipe["unpinned_shapes"] == 0
    assert pipe["pipeline_dedup_ratio"] > 0
    assert pipe["bls"]["batches"] >= 1 and pipe["cmt"]["waves"] >= 1


def test_run_load_traced_assembles_waterfalls():
    r = local_pool.run_load(4, 6, "cpu", trace=True)
    assert r["txns_ordered"] == r["txns_requested"]
    assert r["trace"]["requests_traced"] >= 5
    assert r["trace"]["stage_sum_vs_e2e_p50"] > 0


def test_build_pool_torch_shares_one_ring():
    (names, nodes, _timer, _trustee, _replies, _reply, domain, plane,
     _net) = local_pool.build_pool(4, "torch", config_overrides=SMALL_RING)
    pipe = plane._pipeline
    # the quota product of the reference's arm: 4 nodes x (100 + 100)
    assert pipe.config.PIPELINE_MAX_BUCKET == 4096
    for n in names:
        c = nodes[n].c
        assert c.pipeline is pipe
        assert c.authenticator.core_authenticator.verifier._pipeline is pipe
        assert c.db.get_ledger(domain).tree.hasher._pipeline is pipe
        assert nodes[n].config.crypto_backend == "torch"
    assert type(plane._inner).__name__ == "SupervisedVerifier"
    assert pipe._sha_device


def test_build_pool_without_pipeline_coalesces():
    (names, nodes, *_rest, plane, _net) = local_pool.build_pool(
        4, "torch", config_overrides=dict(CRYPTO_PIPELINE=False))
    assert type(plane).__name__ == "CoalescingVerifier"
    for n in names:
        assert nodes[n].c.pipeline is None
        assert nodes[n].c.authenticator.core_authenticator.verifier is plane


def test_build_pool_starts_every_node_from_copied_rows():
    """genesis and rows: every node starts from a copy of one replica's
    stores (a prefilled domain, no genesis replay) and orders a write on
    top of it."""
    import time

    from plenum_tpu_torch import convert
    from plenum_tpu_torch.common.node_messages import DOMAIN_LEDGER_ID
    from plenum_tpu_torch.common.request import Request
    from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
    from plenum_tpu_torch.execution import txn as txn_lib
    from plenum_tpu_torch.execution.txn import NYM
    from plenum_tpu_torch.node import NodeBootstrap
    names = [f"Node{i + 1}" for i in range(4)]
    genesis, trustee = local_pool.build_genesis(names)
    users = [Ed25519Signer(seed=(b"prefill%d" % i).ljust(32, b"\0"))
             for i in range(6)]
    domain = genesis[DOMAIN_LEDGER_ID]
    for u in users:
        domain.append(txn_lib.new_txn(NYM, {"dest": u.identifier,
                                            "verkey": u.verkey_b58}))
        txn_lib.set_seq_no(domain[-1], len(domain))
    rows = convert.replica_rows(NodeBootstrap(
        names[0], genesis_txns=genesis, crypto_backend="cpu").build())
    (names, nodes, timer, pool_trustee, replies, Reply, domain_id, _plane,
     _net) = local_pool.build_pool(4, "cpu", genesis=(genesis, trustee),
                                   rows=rows)
    assert pool_trustee is trustee
    roots = {nodes[n].c.db.get_state(domain_id).committed_head_hash
             for n in names}
    assert len(roots) == 1
    assert {nodes[n].c.db.get_ledger(domain_id).size for n in names} == {7}
    new = Ed25519Signer(seed=b"copied-rows-user".ljust(32, b"\0"))
    req = Request(trustee.identifier, 1, {"type": NYM, "dest": new.identifier,
                                          "verkey": new.verkey_b58})
    req.signature = trustee.sign_b58(req.signing_bytes())
    for n in names:
        nodes[n].handle_client_message(req.to_dict(), "client")
    deadline = time.perf_counter() + 60
    while time.perf_counter() < deadline:
        if all(any(isinstance(m, Reply) for _, m, _ in replies[n])
               for n in names):
            break
        timer.service()
        for node in nodes.values():
            node.prod()
    assert {nodes[n].c.db.get_ledger(domain_id).size for n in names} == {8}


@pytest.mark.parametrize("overrides", [dict(PIPELINE_DEVICES=2),
                                       dict(PIPELINE_REMOTE_HOSTS="h:1")])
def test_build_pool_takes_the_scale_out_arms(overrides):
    """PIPELINE_DEVICES != 1: the multi-device ring, CPU lanes on "torch";
    a crypto-host roster: the federated ring, which fails fast on a host
    it cannot reach (an operator error, never a silent single-host ring),
    as the reference's does."""
    from plenum_tpu_torch.parallel.pipeline import MultiDeviceCryptoPipeline
    if "PIPELINE_REMOTE_HOSTS" in overrides:
        with pytest.raises((OSError, RuntimeError)):
            local_pool.build_pool(4, "torch", config_overrides=overrides)
        return
    plane = local_pool.build_pool(4, "torch", config_overrides=overrides)[7]
    assert type(plane._pipeline) is MultiDeviceCryptoPipeline
    assert [str(d) for d in (l.inner._device.device
                             for l in plane._pipeline.lanes)] == ["cpu"] * 2


def test_run_load_defaults_to_the_card():
    import inspect
    assert inspect.signature(local_pool.run_load).parameters[
        "backend"].default == "cuda"


def test_main_prints_one_json_line(capsys, monkeypatch):
    monkeypatch.setattr("sys.argv", ["local_pool", "--nodes", "4",
                                     "--txns", "5", "--backend", "cpu",
                                     "--json"])
    local_pool.main()
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    stats = json.loads(out[0])
    assert stats["txns_ordered"] == stats["txns_requested"] == 4


def test_main_refuses_the_reference_backend_names(monkeypatch):
    monkeypatch.setattr("sys.argv", ["local_pool", "--backend", "jax"])
    with pytest.raises(SystemExit):
        local_pool.main()


def test_cpu_pool_matches_the_reference_runner():
    """The same genesis and the same pre-signed requests: both runners
    order every request with the ledgers agreeing (the clock is real, so
    batch boundaries differ from run to run; tests/test_torch_pool_parity.py
    holds the pools byte for byte on a mock clock)."""
    from plenum_tpu.tools import local_pool as ref_pool
    from plenum_tpu_torch.common.node_messages import DOMAIN_LEDGER_ID
    ref = ref_pool.run_load(4, 12, "cpu")
    got = local_pool.run_load(4, 12, "cpu")
    for k in ("txns_ordered", "txns_requested", "ledger_sizes_agree",
              "nodes", "backend"):
        assert got[k] == ref[k], k
    # genesis is byte-equal across the packages
    from plenum_tpu_torch.common.serialization import pack
    g_port, t_port = local_pool.build_genesis(["Node1", "Node2"])
    g_ref, t_ref = ref_pool.build_genesis(["Node1", "Node2"])
    assert pack(g_port[DOMAIN_LEDGER_ID]) == pack(g_ref[DOMAIN_LEDGER_ID])
    assert t_port.verkey_b58 == t_ref.verkey_b58
