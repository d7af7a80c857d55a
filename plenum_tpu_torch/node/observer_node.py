"""ObserverNode: a deployable, self-sufficient read follower.

Reference behavior: plenum/server/observer/observer_node.py — a node-like
process with its own storage and transport that receives committed batches
from the validator pool and keeps a full ledger/state copy without taking
part in consensus.

Redesign: instead of subclassing the validator (the reference's observer is
a Node subclass carrying the whole stack), the follower is a small asyncio
process built from three existing parts:

  - NodeBootstrap components (the same ledgers/states/write-manager a
    validator gets — minus consensus, which it never runs);
  - NodeObserver (observer.py): f+1 content-identical push quorum, root
    re-derivation, atomic gap-fill;
  - plain client connections to each validator's client port. One
    OBSERVER_REGISTER op subscribes a connection to BatchCommitted pushes
    (Node._service_client_msgs); gap transactions are pulled with ordinary
    GET_TXN queries over the same connections — no side channel, no
    caller-supplied fetch_txn.

Liveness model: pushes only cover live traffic, so a follower that was down
catches up on the FIRST push after restart — the batch's Merkle/state roots
bind the entire gap below it, and NodeObserver.catch_up stages + verifies
the pulled range before committing anything. A Byzantine validator can
stall (feed nothing) but never corrupt (quorum + root checks).

    obs = ObserverNode("obs1", genesis, addrs, f=1, data_dir=...)
    await obs.run(stop)        # or ObserverNode.main() as a process

crypto_backend names the components' hasher and verifier backend, the
card ("cuda") unless asked for "cpu" or "torch".
"""
from __future__ import annotations

import asyncio
import itertools
import logging
from typing import Any, Optional

from plenum_tpu_torch.common.message_base import MessageValidationError, message_from_dict
from plenum_tpu_torch.common.node_messages import BatchCommitted
from plenum_tpu_torch.common.serialization import pack, unpack
from plenum_tpu_torch.execution.txn import GET_TXN
from plenum_tpu_torch.node.observer import NodeObserver

logger = logging.getLogger(__name__)


# one wire-framing implementation for the whole package: length-prefixed
# frames with the transport's max-frame guard
from plenum_tpu_torch.ingress.observer_reads import FROM_CONFIG
from plenum_tpu_torch.network.tcp_stack import HandshakeError, _read_frame


class ObserverNode:
    RECONNECT_DELAY = 2.0
    QUERY_TIMEOUT = 10.0
    GAP_LIMIT = 10_000

    def __init__(self, name: str, genesis_txns: dict,
                 addrs: dict[str, tuple[str, int]], f: int = 1,
                 data_dir: Optional[str] = None,
                 storage_backend: str = "memory",
                 client_port: Optional[int] = None,
                 client_host: str = "0.0.0.0",
                 anchor_lag_max=FROM_CONFIG,
                 state_commitment: str = "mpt",
                 state_commitment_per_ledger: Optional[dict] = None,
                 verkle_width: Optional[int] = None,
                 crypto_backend: str = "cuda"):
        import time as _time

        from plenum_tpu_torch.ingress.observer_reads import ObserverReadGate
        from plenum_tpu_torch.node.bootstrap import NodeBootstrap
        self.name = name
        self.addrs = dict(addrs)
        # replicated state rides the validators' commitment scheme (the
        # multi-signed anchors are scheme-defined; see SimObserver note)
        components = NodeBootstrap(
            name, genesis_txns=genesis_txns, data_dir=data_dir,
            storage_backend=storage_backend, crypto_backend=crypto_backend,
            state_commitment=state_commitment,
            state_commitment_per_ledger=state_commitment_per_ledger,
            verkle_width=verkle_width).build()
        self.observer = NodeObserver(components, f=f)
        # read fan-out (ROADMAP item 3): serve PR 4 read_proof envelopes
        # from the replicated state at the last VERIFIED BLS anchor;
        # clients dial client_port exactly like a validator's client port
        self.client_port = client_port
        self.client_host = client_host
        self.read_gate = ObserverReadGate(
            components, self._genesis_bls_keys(genesis_txns),
            n_nodes=len(self.addrs), now=_time.time,
            anchor_lag_max=anchor_lag_max)
        self._conns: dict[str, tuple] = {}         # validator -> (reader, writer)
        self._batches: asyncio.Queue = asyncio.Queue(maxsize=1000)
        # (validator, ledger_id, seq_no) -> Future for in-flight GET_TXN
        self._pending: dict[tuple, asyncio.Future] = {}
        self._req_ids = itertools.count(1)
        # gapped batches need their own f+1 push quorum BEFORE gap-fill:
        # NodeObserver.process_batch only votes on gap-free batches, and
        # catch_up applies unconditionally — without this gate a single
        # Byzantine validator could feed a self-consistent fabricated
        # chain through the gap path. (ledger, start) -> {validator: (digest, batch)}
        self._gap_votes: dict[tuple, dict[str, tuple[str, BatchCommitted]]] = {}
        self.batches_applied = 0

    @staticmethod
    def _genesis_bls_keys(genesis_txns: dict) -> dict[str, str]:
        """alias -> BLS verkey from the pool genesis NODE txns — the keys
        the read gate verifies pushed multi-sigs against. (Static genesis
        keys: key-rotation-aware observers would re-derive from their
        replicated pool state; rotation is out of scope here, matching
        the verifying read clients' static key map.)"""
        from plenum_tpu_torch.common.node_messages import POOL_LEDGER_ID
        keys: dict[str, str] = {}
        for txn in genesis_txns.get(POOL_LEDGER_ID, ()):
            try:
                data = txn["txn"]["data"]["data"]
                if data.get("blskey"):
                    keys[data["alias"]] = data["blskey"]
            except (KeyError, TypeError):
                continue
        return keys

    # --- connection management -------------------------------------------

    async def _maintain(self, validator: str, stop: asyncio.Event) -> None:
        """Dial, register, read until drop; repeat until stopped."""
        host, port = self.addrs[validator]
        while not stop.is_set():
            try:
                reader, writer = await asyncio.wait_for(
                    asyncio.open_connection(host, port), 5.0)
            except (OSError, asyncio.TimeoutError):
                await _sleep_or_stop(self.RECONNECT_DELAY, stop)
                continue
            self._conns[validator] = (reader, writer)
            try:
                payload = pack({"op": "OBSERVER_REGISTER"})
                writer.write(len(payload).to_bytes(4, "big") + payload)
                await writer.drain()
                await self._read_loop(validator, reader)
            except (OSError, asyncio.IncompleteReadError):
                pass
            except HandshakeError as e:
                # shared _read_frame rejects oversize/desynced frames; drop
                # the stream and redial rather than killing this
                # validator's maintain task (which would silently shrink
                # the f+1 push quorum)
                logger.warning("%s: bad frame from %s (%s); reconnecting",
                               self.name, validator, e)
            finally:
                self._conns.pop(validator, None)
                try:
                    writer.close()
                except Exception:
                    pass
            await _sleep_or_stop(self.RECONNECT_DELAY, stop)

    async def _read_loop(self, validator: str,
                         reader: asyncio.StreamReader) -> None:
        while True:
            frame = await _read_frame(reader)
            try:
                msg = unpack(frame)
            except Exception:
                return                             # desynced stream: redial
            if not isinstance(msg, dict):
                continue
            op = msg.get("op")
            if op == "BATCH_COMMITTED":
                try:
                    bc = message_from_dict(msg)
                except MessageValidationError:
                    continue
                if isinstance(bc, BatchCommitted):
                    try:
                        self._batches.put_nowait((validator, bc))
                    except asyncio.QueueFull:
                        pass                       # applier behind: drop;
                        # the next push re-triggers gap-fill
            elif op == "REPLY":
                self._resolve_reply(validator, msg.get("result"))

    def _resolve_reply(self, validator: str, result: Any) -> None:
        if not isinstance(result, dict) or result.get("type") != GET_TXN:
            return
        key = (validator, result.get("ledgerId"), result.get("seqNo"))
        fut = self._pending.pop(key, None)
        if fut is not None and not fut.done():
            fut.set_result(result.get("data"))

    # --- pulling gap txns -------------------------------------------------

    async def _get_txn(self, validator: str, ledger_id: int,
                       seq_no: int) -> Optional[dict]:
        conn = self._conns.get(validator)
        if conn is None:
            return None
        _, writer = conn
        key = (validator, ledger_id, seq_no)
        fut = self._pending.setdefault(
            key, asyncio.get_running_loop().create_future())
        query = {"identifier": self.name, "reqId": next(self._req_ids),
                 "operation": {"type": GET_TXN, "ledgerId": ledger_id,
                               "data": seq_no}}
        try:
            payload = pack(query)
            writer.write(len(payload).to_bytes(4, "big") + payload)
            await writer.drain()
            return await asyncio.wait_for(fut, self.QUERY_TIMEOUT)
        except (OSError, asyncio.TimeoutError):
            self._pending.pop(key, None)
            return None

    # --- applying ---------------------------------------------------------

    async def _apply_loop(self, stop: asyncio.Event) -> None:
        while not stop.is_set():
            try:
                validator, batch = await asyncio.wait_for(
                    self._batches.get(), 0.5)
            except asyncio.TimeoutError:
                continue
            ledger = self.observer.c.db.get_ledger(batch.ledger_id)
            if ledger is None:
                continue
            if batch.seq_no_start > ledger.size + 1:
                if self._gap_quorum(validator, batch):
                    await self._fill_gap(validator, batch)
            else:
                applied = self.observer.process_batch(batch, frm=validator)
                if applied:
                    self.batches_applied += 1
                # every push feeds the read gate: applied batches record
                # roots + invalidate cached reads, and ANY push's
                # multi-sig advances the serving anchor once it verifies
                self.read_gate.on_push(batch, applied)

    def _gap_quorum(self, validator: str, batch: BatchCommitted) -> bool:
        """One vote per validator per (ledger, start); f+1 content-identical
        pushes arm the gap-fill (mirrors NodeObserver.process_batch)."""
        import hashlib
        from plenum_tpu_torch.common.serialization import signing_serialize
        key = (batch.ledger_id, batch.seq_no_start)
        # multi_sig excluded, same as NodeObserver.process_batch: honest
        # validators attach different (all-valid) aggregations
        digest = hashlib.sha256(
            signing_serialize(batch.quorum_dict())).hexdigest()
        # one in-flight gap vote per validator per ledger: a new start from
        # the same validator supersedes its old one, so the bucket count is
        # bounded by pool size — a Byzantine pusher minting ever-new starts
        # can no longer grow the buffer without bound
        for other_key, other_votes in list(self._gap_votes.items()):
            if other_key[0] == batch.ledger_id and other_key != key:
                other_votes.pop(validator, None)
                if not other_votes:
                    del self._gap_votes[other_key]
        votes = self._gap_votes.setdefault(key, {})
        votes[validator] = (digest, batch)
        if sum(1 for d, _ in votes.values()
               if d == digest) < self.observer.f + 1:
            return False
        # settled ranges leave the buffer (bounded by in-flight starts)
        ledger = self.observer.c.db.get_ledger(batch.ledger_id)
        self._gap_votes = {k: v for k, v in self._gap_votes.items()
                           if not (k[0] == batch.ledger_id
                                   and k[1] <= max(ledger.size,
                                                   batch.seq_no_start))}
        return True

    async def _fill_gap(self, validator: str, batch: BatchCommitted) -> None:
        """Prefetch the missing range from the pushing validator, then hand
        NodeObserver.catch_up a lookup into it. Verification (roots bind
        the whole chain; nothing commits on mismatch) lives in catch_up."""
        ledger = self.observer.c.db.get_ledger(batch.ledger_id)
        first, last = ledger.size + 1, batch.seq_no_start - 1
        if last - first + 1 > self.GAP_LIMIT:
            logger.warning("%s: gap of %d txns exceeds limit; skipping",
                           self.name, last - first + 1)
            return
        prefetched: dict[int, dict] = {}
        for seq in range(first, last + 1):
            txn = await self._get_txn(validator, batch.ledger_id, seq)
            if txn is None:
                return                             # puller unreachable: the
                # next push retries against whoever sent it
            prefetched[seq] = txn
        if self.observer.catch_up(
                batch, lambda lid, seq: prefetched.get(seq)):
            self.batches_applied += 1
            self.read_gate.on_push(batch, True)

    # --- serving verified reads to clients --------------------------------

    async def _serve_client(self, reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter) -> None:
        """One client connection on the observer's client port: the same
        length-prefixed framing as a validator's client port, answering
        READ queries from the replicated state through the read gate
        (ObserverReadGate.serve — the one serving path the in-process
        SimObserver shares, so the twins cannot diverge)."""
        try:
            while True:
                frame = await _read_frame(reader)
                try:
                    msg = unpack(frame)
                except Exception:
                    return                     # desynced stream: drop it
                if not isinstance(msg, dict):
                    continue
                payload = pack(self.read_gate.serve(msg).to_dict())
                writer.write(len(payload).to_bytes(4, "big") + payload)
                await writer.drain()
        except (OSError, HandshakeError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    # --- lifecycle --------------------------------------------------------

    async def run(self, stop: asyncio.Event) -> None:
        tasks = [asyncio.create_task(self._maintain(v, stop))
                 for v in self.addrs]
        tasks.append(asyncio.create_task(self._apply_loop(stop)))
        server = None
        try:
            # inside the try: a bind failure (port in use) must still
            # cancel the maintain/apply tasks on the way out
            if self.client_port is not None:
                server = await asyncio.start_server(
                    self._serve_client, self.client_host, self.client_port)
            await stop.wait()
        finally:
            if server is not None:
                server.close()
                await server.wait_closed()
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            for _, writer in self._conns.values():
                try:
                    writer.close()
                except Exception:
                    pass
            self._conns.clear()


async def _sleep_or_stop(delay: float, stop: asyncio.Event) -> None:
    try:
        await asyncio.wait_for(stop.wait(), delay)
    except asyncio.TimeoutError:
        pass
