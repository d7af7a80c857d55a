"""Real network transport: authenticated-encrypted TCP behind the
ExternalBus seam.

Reference behavior being replaced: stp_zmq/zstack.py:52 (ROUTER/DEALER
sockets with CurveZMQ encryption), zstack.py:322 (ZAP allowlist
authenticator), zstack.py:520 (per-cycle receive quotas),
stp_zmq/kit_zstack.py:28 (maintain-connections retry loop) and
plenum/common/batched.py:20 (per-peer outbox coalescing into one wire
frame per flush).

Redesign, not a port: instead of ZMQ + CurveCP this is asyncio TCP with an
explicit Noise-style handshake built from the primitives already in the
image's `cryptography` package:

  dialer  -> acceptor : magic || eph_A                      (32B X25519)
  acceptor-> dialer   : eph_B || vk_B || sig_B("resp"||eph_A||eph_B)
  dialer  -> acceptor : vk_A || sig_A("init"||eph_A||eph_B)

Both sides sign the ephemeral transcript with their long-lived Ed25519 node
key (the same key the pool ledger registers), so peer identity = ledger
identity and the allowlist is exactly the node registry — the reference
reuses its CurveZMQ keys the same way. Session keys are
HKDF(X25519(eph, eph'), salt=transcript) split per direction; frames are
length-prefixed ChaCha20-Poly1305 with a counter nonce (replay-safe: a
counter never repeats under a session key, and sessions never resume).

Wire frames carry a msgpack LIST of message dicts — the outbox batching the
reference does in common/batched.py — so one TCP segment typically carries a
whole prod cycle's traffic to a peer.

Dialer rule: for each pair the lexicographically SMALLER name dials; the
other side accepts. The dialer owns the retry loop (kit_zstack semantics).
"""
from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from typing import Any, Callable, Optional

try:
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey, Ed25519PublicKey)
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey, X25519PublicKey)
    from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305
    from cryptography.hazmat.primitives.kdf.hkdf import HKDF
    _HAVE_CRYPTOGRAPHY = True
except Exception:  # pragma: no cover — gated again in TcpStack.__init__
    _HAVE_CRYPTOGRAPHY = False

from plenum_tpu_torch.common.backoff import ExponentialBackoff
from plenum_tpu_torch.common.event_bus import ExternalBus
from plenum_tpu_torch.common.message_base import MessageBase, message_from_dict
from plenum_tpu_torch.common.serialization import pack, unpack

logger = logging.getLogger(__name__)

MAGIC = b"PTPU\x01\x00\x00\x00"
MAX_FRAME = 8 * 1024 * 1024          # reference caps ZMQ frames similarly
OUTBOX_CAP = 10_000                  # queued msgs per disconnected peer
WRITE_HWM = 8 * 1024 * 1024          # drop a peer that stops reading (ZMQ HWM)
# dialer backoff (kit_zstack retries). RETRY_MAX bounds how long a
# transient drop stays down: it must sit BELOW the pool's
# PRIMARY_DISCONNECT_TIMEOUT (config.py) or a blip at max backoff could
# outlast the tolerance on every peer at once and force a needless view
# change. A down peer being redialed every second by n-1 nodes is noise.
# The doubling is JITTERED per (dialer, peer) — see _retry_backoff: the
# bare min->max doubling is the same deterministic sequence on every
# node, so a pool-wide restart had n-1 dialers arriving at each
# recovering acceptor in synchronized waves (a reconnect stampede, worst
# exactly when the pool is weakest).
RETRY_MIN, RETRY_MAX = 0.1, 1.0
RETRY_JITTER = 0.5


def _retry_backoff(dialer: str, peer: str) -> ExponentialBackoff:
    """Dial-loop retry schedule: truncated doubling with deterministic
    seeded jitter, decorrelated per (dialer, peer) pair so simultaneous
    losers spread their retries instead of stampeding in lockstep."""
    return ExponentialBackoff(base=RETRY_MIN, cap=RETRY_MAX,
                              jitter=RETRY_JITTER,
                              salt=f"dial/{dialer}->{peer}")


class HandshakeError(Exception):
    pass


class NodeRegistry:
    """name -> (host, port, ed25519 verkey bytes); the transport allowlist.

    Mutable on purpose: pool-ledger NODE txns update membership at runtime
    (ref pool_manager reconnect semantics)."""

    def __init__(self, entries: Optional[dict] = None):
        self._entries: dict[str, tuple[str, int, bytes]] = dict(entries or {})

    def set(self, name: str, host: str, port: int, verkey: bytes) -> None:
        self._entries[name] = (host, port, bytes(verkey))

    def remove(self, name: str) -> None:
        self._entries.pop(name, None)

    def get(self, name: str):
        return self._entries.get(name)

    def name_by_verkey(self, verkey: bytes) -> Optional[str]:
        for name, (_, _, vk) in self._entries.items():
            if vk == verkey:
                return name
        return None

    def names(self) -> list[str]:
        return list(self._entries)


def _derive_keys(eph_priv: X25519PrivateKey, eph_peer_pub: bytes,
                 transcript: bytes) -> tuple[bytes, bytes]:
    """-> (dialer->acceptor key, acceptor->dialer key)."""
    shared = eph_priv.exchange(X25519PublicKey.from_public_bytes(eph_peer_pub))
    okm = HKDF(algorithm=hashes.SHA256(), length=64, salt=transcript,
               info=b"plenum-tpu transport v1").derive(shared)
    return okm[:32], okm[32:]


class _Session:
    """One established, authenticated, encrypted peer connection."""

    def __init__(self, peer: str, writer: asyncio.StreamWriter,
                 send_key: bytes, recv_key: bytes):
        self.peer = peer
        self.writer = writer
        self._send_aead = ChaCha20Poly1305(send_key)
        self._recv_aead = ChaCha20Poly1305(recv_key)
        self._send_ctr = 0
        self._recv_ctr = 0

    def encrypt_frame(self, plaintext: bytes) -> bytes:
        nonce = b"\x00" * 4 + self._send_ctr.to_bytes(8, "little")
        self._send_ctr += 1
        ct = self._send_aead.encrypt(nonce, plaintext, None)
        return len(ct).to_bytes(4, "big") + ct

    def decrypt(self, ciphertext: bytes) -> bytes:
        nonce = b"\x00" * 4 + self._recv_ctr.to_bytes(8, "little")
        self._recv_ctr += 1
        return self._recv_aead.decrypt(nonce, ciphertext, None)


async def _read_exact(reader: asyncio.StreamReader, n: int) -> bytes:
    data = await reader.readexactly(n)
    return data


async def _read_frame(reader: asyncio.StreamReader) -> bytes:
    hdr = await _read_exact(reader, 4)
    length = int.from_bytes(hdr, "big")
    if length > MAX_FRAME:
        raise HandshakeError(f"frame too large: {length}")
    return await _read_exact(reader, length)


class TcpStack:
    """Node-to-node transport; owns an ExternalBus facing the Node.

    Lifecycle: construct -> (optionally bind() to learn the real port)
    -> start() -> ... -> stop(). All I/O runs on one asyncio loop; the
    owning Looper calls drain() each prod cycle to hand queued inbound
    messages to the bus (per-cycle quota, like zstack.py:520).
    """

    def __init__(self, name: str, host: str, port: int,
                 registry: NodeRegistry, seed: bytes,
                 max_inbound_per_drain: int = 1000):
        if not _HAVE_CRYPTOGRAPHY:
            # the handshake needs X25519 + ChaCha20-Poly1305; unlike the
            # request-signing seam there is no pure-Python fallback here
            raise ImportError(
                "the `cryptography` package is required for the TCP node "
                "stack (sim fabric and client stack run without it)")
        self.name = name
        self.host, self.port = host, port
        self.registry = registry
        self._sk = Ed25519PrivateKey.from_private_bytes(seed)
        self.verkey = self._sk.public_key().public_bytes(
            serialization.Encoding.Raw, serialization.PublicFormat.Raw)
        self.bus = ExternalBus(self._enqueue_send)
        self._sessions: dict[str, _Session] = {}
        self._outboxes: dict[str, list[bytes]] = {}
        self._inbound: deque[tuple[Any, str]] = deque()
        self._server: Optional[asyncio.AbstractServer] = None
        self._dial_tasks: dict[str, asyncio.Task] = {}
        self._reader_tasks: set[asyncio.Task] = set()
        self._flush_scheduled = False
        self._quota = max_inbound_per_drain
        self._stopped = False
        # dropped_frames/dropped_sessions: silent-loss accounting — outbox
        # trimming and HWM disconnects previously discarded traffic with no
        # trace (surfaced via tools.metrics_report through the node's
        # metrics store). tx/rx maps: per-message-type [count, bytes] so
        # wire-cost claims (digest-gossip) are measured, not asserted.
        self.stats = {"sent_frames": 0, "recv_frames": 0, "rejected": 0,
                      "dropped_frames": 0, "dropped_sessions": 0,
                      "tx_msgs": {}, "rx_msgs": {}}

    @staticmethod
    def _count_msg(table: dict, op: str, nbytes: int, n: int = 1) -> None:
        row = table.get(op)
        if row is None:
            row = table[op] = [0, 0]
        row[0] += n
        row[1] += nbytes * n

    # --- lifecycle -------------------------------------------------------

    async def bind(self) -> int:
        """Start the listener; returns the actual port (use port=0 to let
        the OS pick — the tests and the local-pool runner do)."""
        if self._server is None:
            self._server = await asyncio.start_server(
                self._on_accept, self.host, self.port)
            self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def start(self) -> None:
        await self.bind()
        self.maintain_connections()

    def maintain_connections(self) -> None:
        """(Re)start dial loops for every registry peer we should dial."""
        for peer in self.registry.names():
            if peer == self.name or not self._is_dialer(peer):
                continue
            task = self._dial_tasks.get(peer)
            if task is None or task.done():
                self._dial_tasks[peer] = asyncio.get_running_loop(
                ).create_task(self._dial_loop(peer))

    async def stop(self) -> None:
        self._stopped = True
        for task in list(self._dial_tasks.values()):
            task.cancel()
        for task in list(self._reader_tasks):
            task.cancel()
        for sess in list(self._sessions.values()):
            try:
                sess.writer.close()
            except Exception:
                pass
        self._sessions.clear()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    def _is_dialer(self, peer: str) -> bool:
        return self.name < peer

    # --- outgoing --------------------------------------------------------

    def _enqueue_send(self, msg: Any, dst) -> None:
        # pack ONCE per message, even for a broadcast — the per-peer loop
        # below only appends the shared bytes (guarded by the wire-fuzz
        # pack-once test; a per-peer pack() here is the n^2 serde tax the
        # reference pays in its per-remote serialization)
        if isinstance(msg, MessageBase):
            d = msg.to_dict()
            data = pack(d)
            op = d.get("op", type(msg).__name__)
        else:
            data = pack(msg)
            op = msg.get("op", "?") if isinstance(msg, dict) else "?"
        targets = dst if dst is not None else [
            p for p in self.registry.names() if p != self.name]
        self._count_msg(self.stats["tx_msgs"], op, len(data), len(targets))
        for peer in targets:
            box = self._outboxes.setdefault(peer, [])
            box.append(data)
            if len(box) > OUTBOX_CAP:          # quota: drop oldest
                trimmed = len(box) - OUTBOX_CAP
                del box[:trimmed]
                self.stats["dropped_frames"] += trimmed
                logger.warning(
                    "outbox to %s over cap: dropped %d oldest queued "
                    "messages (%d total dropped)", peer, trimmed,
                    self.stats["dropped_frames"])
        self._schedule_flush()

    def _schedule_flush(self) -> None:
        if self._flush_scheduled or self._stopped:
            return
        self._flush_scheduled = True
        try:
            asyncio.get_running_loop().call_soon(self._flush)
        except RuntimeError:
            self._flush_scheduled = False      # no loop yet; flushed on start

    def _flush(self) -> None:
        """Coalesce each peer's queued messages into ONE encrypted frame
        (common/batched.py flushOutBoxes equivalent)."""
        self._flush_scheduled = False
        for peer, box in self._outboxes.items():
            sess = self._sessions.get(peer)
            if sess is None or not box:
                continue                       # keep queued until connected
            frame_payload = pack(box)
            n_msgs = len(box)
            box.clear()
            try:
                # backpressure: a peer that stopped reading is dead to us —
                # unbounded transport buffering would OOM the node (the
                # reference's ZMQ high-water mark drops slow peers the same
                # way; the dialer's retry loop gives it a fresh start)
                if sess.writer.transport.get_write_buffer_size() > WRITE_HWM:
                    raise ConnectionError("peer write buffer over HWM")
                sess.writer.write(sess.encrypt_frame(frame_payload))
                self.stats["sent_frames"] += 1
            except Exception:
                # the cleared box's messages die with the session — count
                # them; silent loss here cost a debugging session once
                self.stats["dropped_sessions"] += 1
                self.stats["dropped_frames"] += n_msgs
                logger.warning(
                    "dropping session to %s (write failed or over HWM); "
                    "%d queued messages lost", peer, n_msgs)
                self._drop_session(peer)

    # --- incoming --------------------------------------------------------

    def drain(self) -> int:
        """Deliver up to the per-cycle quota of inbound messages to the bus."""
        n = 0
        while self._inbound and n < self._quota:
            msg, frm = self._inbound.popleft()
            n += 1
            try:
                self.bus.process_incoming(msg, frm)
            except Exception:
                logger.exception("handler failed for %s from %s",
                                 type(msg).__name__, frm)
        return n

    @property
    def connected(self) -> set[str]:
        return set(self._sessions)

    # --- handshake: dialer side -----------------------------------------

    async def _dial_loop(self, peer: str) -> None:
        backoff = _retry_backoff(self.name, peer)
        while not self._stopped:
            if peer in self._sessions:
                await asyncio.sleep(RETRY_MAX)
                continue
            entry = self.registry.get(peer)
            if entry is None:
                return
            host, port, expect_vk = entry
            writer = None
            try:
                reader, writer = await asyncio.open_connection(host, port)
                # a wedged acceptor must not hang the dial loop forever:
                # same 5s budget the acceptor gives us
                sess = await asyncio.wait_for(
                    self._handshake_dialer(peer, expect_vk, reader, writer),
                    timeout=5.0)
                self._install_session(peer, sess, reader)
                backoff.reset()
            except (OSError, HandshakeError, asyncio.IncompleteReadError,
                    asyncio.TimeoutError):
                if writer is not None:       # failed handshake: free the fd
                    try:
                        writer.close()
                    except Exception:
                        pass
                await asyncio.sleep(backoff.next())

    async def _handshake_dialer(self, peer: str, expect_vk: bytes,
                                reader, writer) -> _Session:
        eph = X25519PrivateKey.generate()
        eph_pub = eph.public_key().public_bytes(
            serialization.Encoding.Raw, serialization.PublicFormat.Raw)
        writer.write(MAGIC + eph_pub)
        await writer.drain()
        resp = await _read_exact(reader, 32 + 32 + 64)
        eph_b, vk_b, sig_b = resp[:32], resp[32:64], resp[64:]
        if vk_b != expect_vk:
            raise HandshakeError(f"{peer}: unexpected verkey")
        transcript = eph_pub + eph_b
        try:
            Ed25519PublicKey.from_public_bytes(vk_b).verify(
                sig_b, b"resp" + transcript)
        except InvalidSignature:
            raise HandshakeError(f"{peer}: bad responder signature")
        sig_a = self._sk.sign(b"init" + transcript)
        writer.write(self.verkey + sig_a)
        await writer.drain()
        k_d2a, k_a2d = _derive_keys(eph, eph_b, transcript)
        return _Session(peer, writer, send_key=k_d2a, recv_key=k_a2d)

    # --- handshake: acceptor side ---------------------------------------

    async def _on_accept(self, reader, writer) -> None:
        try:
            sess = await asyncio.wait_for(
                self._handshake_acceptor(reader, writer), timeout=5.0)
        except Exception:
            self.stats["rejected"] += 1
            writer.close()
            return
        self._install_session(sess.peer, sess, reader)

    async def _handshake_acceptor(self, reader, writer) -> _Session:
        hello = await _read_exact(reader, len(MAGIC) + 32)
        if hello[:len(MAGIC)] != MAGIC:
            raise HandshakeError("bad magic")
        eph_a = hello[len(MAGIC):]
        eph = X25519PrivateKey.generate()
        eph_pub = eph.public_key().public_bytes(
            serialization.Encoding.Raw, serialization.PublicFormat.Raw)
        transcript = eph_a + eph_pub
        sig_b = self._sk.sign(b"resp" + transcript)
        writer.write(eph_pub + self.verkey + sig_b)
        await writer.drain()
        fin = await _read_exact(reader, 32 + 64)
        vk_a, sig_a = fin[:32], fin[32:]
        peer = self.registry.name_by_verkey(vk_a)
        if peer is None:                       # ZAP allowlist: unknown key
            raise HandshakeError("verkey not in registry")
        try:
            Ed25519PublicKey.from_public_bytes(vk_a).verify(
                sig_a, b"init" + transcript)
        except InvalidSignature:
            raise HandshakeError(f"{peer}: bad initiator signature")
        k_d2a, k_a2d = _derive_keys(eph, eph_a, transcript)
        return _Session(peer, writer, send_key=k_a2d, recv_key=k_d2a)

    # --- session plumbing -----------------------------------------------

    def _install_session(self, peer: str, sess: _Session, reader) -> None:
        old = self._sessions.get(peer)
        if old is not None:
            # restarted peer: the new connection supersedes the old one
            try:
                old.writer.close()
            except Exception:
                pass
        self._sessions[peer] = sess
        task = asyncio.get_running_loop().create_task(
            self._read_loop(peer, sess, reader))
        self._reader_tasks.add(task)
        task.add_done_callback(self._reader_tasks.discard)
        self.bus.update_connecteds(self.connected)
        self._schedule_flush()                 # release queued outbox

    def _drop_session(self, peer: str) -> None:
        sess = self._sessions.pop(peer, None)
        if sess is not None:
            try:
                sess.writer.close()
            except Exception:
                pass
            self.bus.update_connecteds(self.connected)

    async def _read_loop(self, peer: str, sess: _Session, reader) -> None:
        try:
            while not self._stopped:
                ct = await _read_frame(reader)
                payload = sess.decrypt(ct)
                self.stats["recv_frames"] += 1
                # frame payload = packed list of per-message packed dicts
                # (messages are serialized once at enqueue, even for
                # broadcasts, then batched per peer at flush)
                for raw in unpack(payload):
                    try:
                        d = unpack(raw)
                        msg = message_from_dict(d)
                    except Exception:
                        logger.warning("undecodable message from %s", peer)
                        continue
                    self._count_msg(
                        self.stats["rx_msgs"],
                        d.get("op", "?") if isinstance(d, dict) else "?",
                        len(raw))
                    self._inbound.append((msg, peer))
        except (asyncio.IncompleteReadError, ConnectionError, OSError,
                asyncio.CancelledError, Exception):
            pass
        finally:
            if self._sessions.get(peer) is sess:
                self._drop_session(peer)


class ClientStack:
    """Client-facing listener.

    Plaintext length-prefixed msgpack frames: client requests are themselves
    Ed25519-signed at the request layer (client_authn), which is what
    authenticates them — transport encryption for clients is TLS-termination
    territory, out of scope the same way the reference leaves client CurveZMQ
    keys unauthenticated (any client key is accepted, zstack.py:322).

    on_request(msg_dict, client_id) is wired to Node.handle_client_message;
    send(msg, client_id) is the Node's client_send callback.

    Connection budget (ref plenum/config.py:285-292 MAX_CONNECTED_CLIENTS_NUM
    + client-stack restart): at most `max_connections` concurrent client
    sockets. The reference restarts the whole ZMQ stack to shed dead
    connections because ZMQ cannot enumerate them; an asyncio listener can,
    so a full stack first sweeps connections idle past `idle_timeout`
    (activity = any frame in OR any push/reply out) and only rejects the
    new connection if every slot is genuinely live — validator traffic is
    untouched either way (separate node stack).
    """

    INBOUND_CAP = 10_000          # queued requests across all clients

    def __init__(self, name: str, host: str, port: int,
                 on_request: Callable[[dict, str], None],
                 max_inbound_per_drain: int = 500,
                 max_connections: int = 400,
                 idle_timeout: float = 300.0):
        self.name = name
        self.host, self.port = host, port
        self._on_request = on_request
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: dict[str, asyncio.StreamWriter] = {}
        self._next_id = 0
        self._inbound: deque[tuple[dict, str]] = deque()
        self._quota = max_inbound_per_drain
        self.max_connections = max_connections
        self.idle_timeout = idle_timeout
        self._last_activity: dict[str, float] = {}
        self.rejected_connections = 0

    async def bind(self) -> int:
        if self._server is None:
            self._server = await asyncio.start_server(
                self._on_accept, self.host, self.port)
            self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def stop(self) -> None:
        for w in self._conns.values():
            try:
                w.close()
            except Exception:
                pass
        self._conns.clear()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    def drain(self) -> int:
        """Per-cycle quota, like the node stack (ref zstack.py:520) — one
        fast client must not stall a whole prod cycle."""
        n = 0
        while self._inbound and n < self._quota:
            msg, cid = self._inbound.popleft()
            n += 1
            try:
                self._on_request(msg, cid)
            except Exception:
                logger.exception("client request failed")
        return n

    def send(self, msg: Any, client_id: str) -> None:
        if self._conns.get(client_id) is None:
            return                             # client gone; reply dropped
        self._send_packed(
            pack(msg.to_dict() if isinstance(msg, MessageBase) else msg),
            client_id)

    def send_many(self, msg: Any, client_ids) -> None:
        """Broadcast to several clients packing the message ONCE (mirror of
        the node stack's pack-once broadcast): the observer push previously
        re-serialized the same BatchCommitted per registered observer."""
        data = None
        for cid in client_ids:
            if self._conns.get(cid) is None:
                continue
            if data is None:
                data = pack(msg.to_dict()
                            if isinstance(msg, MessageBase) else msg)
            self._send_packed(data, cid)

    def _send_packed(self, data: bytes, client_id: str) -> None:
        writer = self._conns.get(client_id)
        if writer is None:
            return
        try:
            if writer.transport.get_write_buffer_size() > WRITE_HWM:
                raise ConnectionError("client write buffer over HWM")
            writer.write(len(data).to_bytes(4, "big") + data)
            self._last_activity[client_id] = time.monotonic()
        except Exception:
            self._drop_client(client_id)

    def _drop_client(self, client_id: str) -> None:
        writer = self._conns.pop(client_id, None)
        self._last_activity.pop(client_id, None)
        if writer is not None:
            try:
                writer.close()
            except Exception:
                pass

    def _sweep_idle(self) -> int:
        """Close connections with no traffic in either direction for
        idle_timeout; returns number closed."""
        now = time.monotonic()
        stale = [cid for cid, ts in self._last_activity.items()
                 if now - ts > self.idle_timeout]
        for cid in stale:
            self._drop_client(cid)
        return len(stale)

    async def _on_accept(self, reader, writer) -> None:
        if len(self._conns) >= self.max_connections:
            self._sweep_idle()
        if len(self._conns) >= self.max_connections:
            # every slot is live within the idle window: shed the newcomer
            # (bounded memory/FDs beat fairness here, as in the reference's
            # MAX_CONNECTED_CLIENTS_NUM)
            self.rejected_connections += 1
            try:
                writer.close()
            except Exception:
                pass
            return
        cid = f"client-{self._next_id}"
        self._next_id += 1
        self._conns[cid] = writer
        self._last_activity[cid] = time.monotonic()
        try:
            while True:
                frame = await _read_frame(reader)
                msg = unpack(frame)
                self._last_activity[cid] = time.monotonic()
                if isinstance(msg, dict) and \
                        len(self._inbound) < self.INBOUND_CAP:
                    self._inbound.append((msg, cid))
        except (asyncio.IncompleteReadError, ConnectionError, OSError,
                Exception):
            pass
        finally:
            self._drop_client(cid)
