"""Deterministic simulated client populations for ingress-scale drives.

The ingress plane's unit of admission and fairness is the CLIENT — a
connection identity, not a keypair. A 10k-client bench therefore needs
10k distinct identities issuing a read:write mix, but NOT 10k Ed25519
keys: real front doors see gateway-style traffic where a bounded signer
set (here the trustee) authors writes on behalf of many end identities.
All draw order rides ``SimRandom(seed)``, so a population replays
exactly (the fuzz/bench contract everything else in the sim world
follows).

    pop = SimClientPopulation(10_000, trustee, read_targets=dids, seed=3)
    for client_id, kind, request in pop.ops(4_000):
        ...   # kind is "read" (GET_NYM query) or "write" (signed NYM)

``burst_writes`` builds flood traffic for overload/fuzz scenarios: many
hot clients, each with a burst of writes, optionally with signatures
that CANNOT verify (a bad-signature flood must die in the ingress auth
batch, not in the pool).
"""
from __future__ import annotations

from typing import Iterator, Optional, Sequence

from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
from plenum_tpu_torch.execution.txn import GET_NYM, NYM
from plenum_tpu_torch.network.sim_random import SimRandom


class SimClientPopulation:
    def __init__(self, n_clients: int, trustee: Ed25519Signer,
                 read_targets: Sequence[str], seed: int = 1,
                 read_ratio: float = 0.95,
                 client_prefix: str = "c"):
        assert n_clients > 0 and read_targets
        self.n_clients = n_clients
        self.trustee = trustee
        self.read_targets = list(read_targets)
        self.read_ratio = read_ratio
        self.client_prefix = client_prefix
        self._rng = SimRandom(seed * 2654435761 % (2 ** 31) + 97)
        self._req_ids = 0
        self.reads_issued = 0
        self.writes_issued = 0

    def _client(self) -> str:
        return f"{self.client_prefix}{self._rng.integer(0, self.n_clients - 1)}"

    def next_op(self) -> tuple[str, str, Request]:
        """-> (client_id, kind, request): one draw from the mix."""
        self._req_ids += 1
        client = self._client()
        if self._rng.float(0.0, 1.0) < self.read_ratio:
            self.reads_issued += 1
            dest = self.read_targets[
                self._rng.integer(0, len(self.read_targets) - 1)]
            return client, "read", Request(
                client, self._req_ids, {"type": GET_NYM, "dest": dest})
        self.writes_issued += 1
        user = Ed25519Signer(
            seed=(b"scp-%08d" % self._req_ids).ljust(32, b"\0")[:32])
        req = Request(self.trustee.identifier, self._req_ids,
                      {"type": NYM, "dest": user.identifier,
                       "verkey": user.verkey_b58})
        req.signature = self.trustee.sign_b58(req.signing_bytes())
        return client, "write", req

    def ops(self, n_ops: int) -> Iterator[tuple[str, str, Request]]:
        for _ in range(n_ops):
            yield self.next_op()


def burst_writes(trustee: Ed25519Signer, n_clients: int, per_client: int,
                 seed: int = 1, bad_sigs: bool = False,
                 client_prefix: str = "hot",
                 req_id_base: int = 1_000_000
                 ) -> list[tuple[str, Request]]:
    """Flood traffic: n_clients hot clients, each bursting `per_client`
    unique writes. With bad_sigs=True every signature is a VALID
    signature over DIFFERENT bytes — well-formed enough to reach the
    batched verifier and fail there (a garbage-encoded sig would be
    host-rejected before the device and prove nothing about shedding
    the verify cost)."""
    out: list[tuple[str, Request]] = []
    req_id = req_id_base + seed * 100_000
    for c in range(n_clients):
        client = f"{client_prefix}{c}"
        for _ in range(per_client):
            req_id += 1
            user = Ed25519Signer(
                seed=(b"burst-%010d" % req_id).ljust(32, b"\0")[:32])
            req = Request(trustee.identifier, req_id,
                          {"type": NYM, "dest": user.identifier,
                           "verkey": user.verkey_b58})
            if bad_sigs:
                req.signature = trustee.sign_b58(b"not the signing bytes")
            else:
                req.signature = trustee.sign_b58(req.signing_bytes())
            out.append((client, req))
    return out
