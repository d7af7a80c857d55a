"""Pool client: submit requests over TCP and await an f+1 reply quorum.

Reference behavior: plenum/client/client.py (Client: submitReqs, quorum'd
reply collection via ReplyQuorum) + pool_transactions genesis bootstrap.
The transport is the framework's length-prefixed msgpack client framing
(plenum_tpu_torch/network/tcp_stack.py ClientStack).
"""
from __future__ import annotations

import asyncio
import hashlib
from typing import Any, Optional

from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.common.serialization import pack, unpack


class PoolClient:
    """Async client over the node client ports.

    node_addrs: {node_name: (host, port)}. A request is sent to EVERY node
    (the reference sends to all and waits for f+1 matching REPLYs — the
    replies carry the same txn, so 'matching' is by txn root content here:
    seqNo + txn payload digest).
    """

    def __init__(self, node_addrs: dict[str, tuple[str, int]], f: int):
        self.node_addrs = dict(node_addrs)
        self.f = f
        self._conns: dict[str, tuple] = {}

    def _addr_of(self, name: str) -> tuple[str, int]:
        """Dial-address lookup seam: subclasses serving extra tiers
        (VerifyingReadClient's observers) widen THIS, not _conn."""
        return self.node_addrs[name]

    async def _conn(self, name: str):
        conn = self._conns.get(name)
        if conn is None:
            host, port = self._addr_of(name)
            conn = await asyncio.open_connection(host, port)
            self._conns[name] = conn
        return conn

    async def close(self) -> None:
        for _, writer in self._conns.values():
            try:
                writer.close()
            except Exception:
                pass
        self._conns.clear()

    async def _send_one(self, name: str, data: bytes) -> None:
        try:
            _, writer = await self._conn(name)
            writer.write(len(data).to_bytes(4, "big") + data)
            await writer.drain()
        except OSError:
            self._conns.pop(name, None)     # node down: quorum covers us

    async def _read_until_reply(self, name: str, req_key: tuple,
                                timeout: float) -> Optional[dict]:
        try:
            reader, _ = await self._conn(name)
            deadline = asyncio.get_running_loop().time() + timeout
            while True:
                remaining = deadline - asyncio.get_running_loop().time()
                if remaining <= 0:
                    return None
                hdr = await asyncio.wait_for(reader.readexactly(4), remaining)
                frame = await reader.readexactly(int.from_bytes(hdr, "big"))
                msg = unpack(frame)
                if not isinstance(msg, dict):
                    continue
                if msg.get("op") == "REPLY":
                    result = msg.get("result", {})
                    meta = result.get("txn", {}).get("metadata", {})
                    if (meta.get("from"), meta.get("reqId")) == req_key:
                        return msg
                    # read replies carry no txn metadata; the read plane
                    # echoes the asker at the result's top level instead
                    if (result.get("identifier"),
                            result.get("reqId")) == req_key:
                        return msg
                elif msg.get("op") in ("REQNACK", "REJECT") and \
                        (msg.get("identifier"),
                         msg.get("req_id")) == req_key:
                    return msg
        except (OSError, asyncio.TimeoutError, asyncio.IncompleteReadError):
            return None

    @staticmethod
    def _vote_key(msg: dict) -> tuple:
        """Quorum bucket for one node's reply. Write replies vote by txn
        identity (seqNo + request digest from the txn metadata). Read
        replies have NO txn metadata — keying them by the (absent)
        metadata would let nodes returning DIFFERENT read data all count
        toward one f+1 bucket, so they vote by a digest of the result's
        DATA content — minus everything that legitimately varies between
        HONEST nodes: the per-request echo fields (vary by asker) and
        every proof attachment (read_proof, state_proof, merkle_proof).
        Proofs are advisory, unsigned-by-this-quorum material that
        honest nodes at different commit points or with different
        aggregated COMMIT-sig subsets produce differently — voting on
        them would split identical answers into separate buckets and
        starve the quorum."""
        if msg.get("op") != "REPLY":
            return (msg.get("op"), msg.get("reason"))
        result = msg.get("result", {})
        meta = result.get("txn", {}).get("metadata", {})
        if meta.get("digest"):
            return ("REPLY", result.get("txnMetadata", {}).get("seqNo"),
                    meta.get("digest"))
        core = {k: v for k, v in result.items()
                if k not in ("identifier", "reqId", "read_proof",
                             "shard_proof", "state_proof", "merkle_proof")}
        return ("REPLY", hashlib.sha256(pack(core)).hexdigest())

    async def submit(self, request: Request, timeout: float = 30.0,
                     to: Optional[list] = None) -> dict:
        """Send to all nodes; resolve when f+1 nodes agree on the outcome.

        Returns the agreed REPLY (or NACK/REJECT) dict. Raises TimeoutError
        if no f+1 agreement arrives in time.

        to: restrict the broadcast to a node subset (a sharded pool's
        quorum lives INSIDE the owning shard — broadcasting to foreign
        shards could only add votes about state they don't hold).
        """
        targets = [n for n in (to or self.node_addrs) if n in self.node_addrs]
        data = pack(request.to_dict())
        req_key = (request.identifier, request.req_id)
        await asyncio.gather(*(self._send_one(n, data) for n in targets))
        results = await asyncio.gather(*(
            self._read_until_reply(n, req_key, timeout)
            for n in targets))
        votes: dict[Any, tuple[int, dict]] = {}
        for msg in results:
            if msg is None:
                continue
            key = self._vote_key(msg)
            count, _ = votes.get(key, (0, msg))
            votes[key] = (count + 1, msg)
        for count, msg in votes.values():
            if count >= self.f + 1:
                return msg
        raise TimeoutError(
            f"no f+1 reply quorum for {req_key}; votes="
            f"{ {k: c for k, (c, _) in votes.items()} }")
