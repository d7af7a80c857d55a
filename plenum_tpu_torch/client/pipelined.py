"""Pipelined pool client: a whole window of requests on the wire at once.

PoolClient.submit (client.py) is one-request-at-a-time — send, await an
f+1 reply quorum, return. Throughput-oriented callers (bulk issuers,
migration tooling, the tcp_pool benchmark) need many requests in flight;
this client keeps one connection per node, one reader task per node, and
counts a request done when f+1 DISTINCT nodes have sent CONTENT-IDENTICAL
replies for its (identifier, reqId) key — same matching-reply quorum as
PoolClient; f non-matching (Byzantine) replies can never complete a
request on their own.

    client = PipelinedPoolClient(addrs, f=1)
    done, submit_times = await client.drive(requests, window=100,
                                            timeout=60.0)
"""
from __future__ import annotations

import asyncio
import hashlib
import time

from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.common.serialization import pack, signing_serialize, unpack


class PipelinedPoolClient:
    def __init__(self, addrs: dict[str, tuple[str, int]], f: int):
        self.addrs = dict(addrs)
        self.f = f
        self.conns: dict[str, tuple] = {}
        self.votes: dict[tuple, set] = {}
        self.done: dict[tuple, float] = {}
        self.done_evt = asyncio.Event()

    CONNECT_TIMEOUT = 5.0       # per node; a SYN-dropping host must not
    DRAIN_TIMEOUT = 10.0        # stall the whole drive (kernel retries
                                # run ~130s), nor a connected-but-not-
                                # reading node wedge a drain forever

    async def connect(self) -> None:
        """Dial every node; unreachable nodes are skipped (the f+1 reply
        quorum covers them) but fewer than f+1 reachable is a hard error."""
        async def dial(name, host, port):
            try:
                self.conns[name] = await asyncio.wait_for(
                    asyncio.open_connection(host, port),
                    self.CONNECT_TIMEOUT)
            except (OSError, asyncio.TimeoutError):
                pass

        # parallel dialing: the connect phase is bounded by ONE timeout,
        # not timeout x n_unreachable
        await asyncio.gather(*(dial(n, h, p)
                               for n, (h, p) in self.addrs.items()))
        if len(self.conns) < self.f + 1:
            await self.close()
            raise ConnectionError(
                f"only {len(self.conns)} of {len(self.addrs)} nodes "
                f"reachable; need at least f+1 = {self.f + 1}")

    def _drop(self, name: str) -> None:
        """Remove AND close a connection — dropped sockets must not leak
        FDs for the process lifetime (bulk issuers reuse this client)."""
        conn = self.conns.pop(name, None)
        if conn is not None:
            try:
                conn[1].close()
            except Exception:
                pass

    async def close(self) -> None:
        for name in list(self.conns):
            self._drop(name)

    async def _reader(self, name: str) -> None:
        reader, _ = self.conns[name]
        try:
            while True:
                hdr = await reader.readexactly(4)
                frame = await reader.readexactly(int.from_bytes(hdr, "big"))
                try:
                    msg = unpack(frame)
                except Exception:
                    # corrupt frame = desynced stream: drop the connection
                    # (narrow scope: a bug in the vote accounting below
                    # must surface as a task exception, not a silent drop)
                    self._drop(name)
                    return
                if not isinstance(msg, dict) or msg.get("op") != "REPLY":
                    continue
                result = msg.get("result", {})
                meta = result.get("txn", {}).get("metadata", {})
                key = (meta.get("from"), meta.get("reqId"))
                # quorum on f+1 EQUAL replies: the vote bucket is keyed by
                # the canonical digest of the whole result, so a Byzantine
                # node's fabricated REPLY lands in its own bucket and can
                # never combine with honest votes
                try:
                    content = hashlib.sha256(
                        signing_serialize(result)).hexdigest()
                except (TypeError, ValueError):
                    continue    # unserializable result: not a valid reply
                seen = self.votes.setdefault((key, content), set())
                seen.add(name)
                if len(seen) >= self.f + 1 and key not in self.done:
                    self.done[key] = time.perf_counter()
                    self.done_evt.set()
        except (asyncio.IncompleteReadError, OSError):
            self._drop(name)

    async def _send(self, payload: bytes) -> None:
        """Broadcast: write to ALL live connections first, then drain all
        (overlapping the TCP flushes); a node dying mid-run is dropped,
        not fatal — the reply quorum covers it (same contract as
        PoolClient._send_one). Drains are bounded so a connected-but-
        stuck peer cannot wedge the pipeline."""
        frame = len(payload).to_bytes(4, "big") + payload
        for name, (_, writer) in list(self.conns.items()):
            try:
                writer.write(frame)
            except OSError:
                self._drop(name)
        for name, (_, writer) in list(self.conns.items()):
            try:
                await asyncio.wait_for(writer.drain(), self.DRAIN_TIMEOUT)
            except (OSError, asyncio.TimeoutError):
                self._drop(name)

    async def drive(self, requests: list[Request], window: int = 100,
                    timeout: float = 120.0) -> tuple[dict, dict]:
        """Submit all requests keeping <= window unresolved in flight.
        -> ({req_key: t_done}, {req_key: t_sent}); missing keys timed out.
        Reusable: every call starts from a clean slate."""
        self.votes.clear()
        self.done.clear()
        self.done_evt = asyncio.Event()
        readers: list[asyncio.Task] = []
        submit_times: dict[tuple, float] = {}
        deadline = time.perf_counter() + timeout
        try:
            await self.connect()
            readers = [asyncio.create_task(self._reader(n))
                       for n in self.conns]
            i = 0
            while len(self.done) < len(requests):
                if time.perf_counter() > deadline:
                    break
                if not self.conns:
                    break   # every connection is gone: nothing can arrive
                    # (NOT "< f+1": votes already collected from since-
                    # dropped nodes can still combine with in-flight
                    # replies from the survivors)
                while i < len(requests) and i - len(self.done) < window:
                    req = requests[i]
                    submit_times[(req.identifier, req.req_id)] = \
                        time.perf_counter()
                    await self._send(pack(req.to_dict()))
                    i += 1
                self.done_evt.clear()
                try:
                    await asyncio.wait_for(self.done_evt.wait(), 0.25)
                except asyncio.TimeoutError:
                    pass
        finally:
            for t in readers:
                t.cancel()
            await self.close()
        return dict(self.done), submit_times
