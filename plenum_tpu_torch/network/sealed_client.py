"""Sealed client connections: a node's client port with the encryption of
its node stack.

Reference behavior: the reference's client stack is a CurveZMQ socket
(stp_zmq/zstack.py:52): each client knows the node's public key from the
pool genesis, every frame is encrypted, and any client key is accepted
(zstack.py:322), since a request's own signature is what authenticates it.

The port's `ClientStack` (tcp_stack.py) speaks length-prefixed msgpack in
the clear. `SealedClientStack` serves that framing unchanged and, besides,
seals any connection whose client opens with CLIENT_MAGIC, by a one-round
handshake built like the node stack's:

  client -> node   : CLIENT_MAGIC || eph_C                   (32B X25519)
  node   -> client : eph_N || vk_N || sig_N("client"||transcript)

where transcript = CLIENT_MAGIC || eph_C || eph_N and vk_N is the node's
Ed25519 key, the one its pool ledger entry registers. The client checks
vk_N against that entry and the signature over both ephemerals; the node
takes any client, as the reference does. Session keys and frames are the
node stack's (`_derive_keys`, `_Session`): HKDF over the X25519 secret,
salted with the transcript, one key a direction, and length-prefixed
ChaCha20-Poly1305 frames under a counter nonce.

CLIENT_MAGIC read as a plaintext frame's length is over MAX_FRAME, so the
first four bytes of a connection tell the two framings apart.

    conn = await connect_sealed(host, port, node_verkey)
    conn.send_packed(pack(request))
    reply = unpack(await conn.recv())
"""
from __future__ import annotations

import asyncio
import time

from cryptography.exceptions import InvalidSignature
from cryptography.hazmat.primitives import serialization
from cryptography.hazmat.primitives.asymmetric.ed25519 import (
    Ed25519PrivateKey, Ed25519PublicKey)
from cryptography.hazmat.primitives.asymmetric.x25519 import X25519PrivateKey

from plenum_tpu_torch.network.tcp_stack import (WRITE_HWM, ClientStack,
                                                HandshakeError,
                                                _derive_keys, _read_frame,
                                                _Session)

CLIENT_MAGIC = b"PTPC"     # as a frame length: 1.35 GB, over MAX_FRAME
HANDSHAKE_S = 5.0          # the node stack's budget for a handshake


def _raw(public_key) -> bytes:
    return public_key.public_bytes(serialization.Encoding.Raw,
                                   serialization.PublicFormat.Raw)


class _Replay:
    """A stream reader that gives back the bytes already read first."""

    def __init__(self, reader: asyncio.StreamReader, head: bytes):
        self._reader, self._head = reader, head

    async def readexactly(self, n: int) -> bytes:
        head, self._head = self._head[:n], self._head[n:]
        if len(head) == n:
            return head
        return head + await self._reader.readexactly(n - len(head))


class _Opened:
    """A stream reader over a sealed connection that reads as the
    plaintext framing: each sealed frame opened (`stack._open`) and given
    back with its length in front."""

    def __init__(self, reader, sess: _Session, stack: "SealedClientStack"):
        self._reader, self._sess, self._stack = reader, sess, stack
        self._buf = b""

    async def readexactly(self, n: int) -> bytes:
        while len(self._buf) < n:
            payload = self._stack._open(self._sess,
                                        await _read_frame(self._reader))
            self._buf += len(payload).to_bytes(4, "big") + payload
        out, self._buf = self._buf[:n], self._buf[n:]
        return out


class SealedClientStack(ClientStack):
    """ClientStack that also serves sealed connections, under the node's
    Ed25519 key (`seed`, the node stack's)."""

    def __init__(self, name: str, host: str, port: int, on_request,
                 seed: bytes, **kw):
        super().__init__(name, host, port, on_request, **kw)
        self._sk = Ed25519PrivateKey.from_private_bytes(seed)
        self.verkey = _raw(self._sk.public_key())
        self._seals: dict = {}          # writer -> _Session

    def _open(self, sess: _Session, ciphertext: bytes) -> bytes:
        return sess.decrypt(ciphertext)

    def _send_packed(self, data: bytes, client_id: str) -> None:
        writer = self._conns.get(client_id)
        sess = self._seals.get(writer)
        if sess is None:
            return super()._send_packed(data, client_id)
        try:
            if writer.transport.get_write_buffer_size() > WRITE_HWM:
                raise ConnectionError("client write buffer over HWM")
            writer.write(sess.encrypt_frame(data))
            self._last_activity[client_id] = time.monotonic()
        except Exception:
            self._drop_client(client_id)

    async def _handshake(self, reader, writer) -> _Session:
        eph_c = await reader.readexactly(32)
        eph = X25519PrivateKey.generate()
        eph_n = _raw(eph.public_key())
        transcript = CLIENT_MAGIC + eph_c + eph_n
        writer.write(eph_n + self.verkey
                     + self._sk.sign(b"client" + transcript))
        await writer.drain()
        k_c2n, k_n2c = _derive_keys(eph, eph_c, transcript)
        return _Session("client", writer, send_key=k_n2c, recv_key=k_c2n)

    async def _on_accept(self, reader, writer) -> None:
        try:
            # a connection silent for idle_timeout is closed, as the idle
            # sweep closes one that has spoken
            head = await asyncio.wait_for(
                reader.readexactly(len(CLIENT_MAGIC)), self.idle_timeout)
            if head != CLIENT_MAGIC:
                # the plaintext framing: the head is its first length
                return await super()._on_accept(_Replay(reader, head),
                                                 writer)
            sess = await asyncio.wait_for(self._handshake(reader, writer),
                                          HANDSHAKE_S)
        except Exception:
            writer.close()
            return
        self._seals[writer] = sess
        try:
            await super()._on_accept(_Opened(reader, sess, self), writer)
        finally:
            self._seals.pop(writer, None)


class SealedConnection:
    """A client's sealed connection to one node's client port."""

    def __init__(self, reader, writer, sess: _Session):
        self.reader, self.writer, self._sess = reader, writer, sess

    def send_packed(self, data: bytes) -> None:
        self.writer.write(self._sess.encrypt_frame(data))

    async def recv(self) -> bytes:
        return self._sess.decrypt(await _read_frame(self.reader))

    async def drain(self) -> None:
        await self.writer.drain()

    def close(self) -> None:
        self.writer.close()


async def connect_sealed(host: str, port: int, node_verkey: bytes,
                         timeout: float = HANDSHAKE_S) -> SealedConnection:
    """Dial a node's client port and seal the connection; the node must
    sign with `node_verkey` (raw Ed25519, its pool ledger entry's)."""
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(host, port), timeout)
    try:
        eph = X25519PrivateKey.generate()
        eph_c = _raw(eph.public_key())
        writer.write(CLIENT_MAGIC + eph_c)
        await writer.drain()
        resp = await asyncio.wait_for(reader.readexactly(32 + 32 + 64),
                                      timeout)
        eph_n, vk_n, sig_n = resp[:32], resp[32:64], resp[64:]
        if vk_n != bytes(node_verkey):
            raise HandshakeError(f"{host}:{port}: unexpected verkey")
        transcript = CLIENT_MAGIC + eph_c + eph_n
        try:
            Ed25519PublicKey.from_public_bytes(vk_n).verify(
                sig_n, b"client" + transcript)
        except InvalidSignature:
            raise HandshakeError(f"{host}:{port}: bad node signature")
    except BaseException:
        writer.close()
        raise
    k_c2n, k_n2c = _derive_keys(eph, eph_n, transcript)
    return SealedConnection(reader, writer,
                            _Session("node", writer, send_key=k_c2n,
                                     recv_key=k_n2c))


def node_verkeys(pool_genesis) -> dict[str, bytes]:
    """Pool genesis txns -> {node alias: raw Ed25519 verkey}, what
    connect_sealed checks a node against."""
    out: dict[str, bytes] = {}
    for txn in pool_genesis:
        data = txn["txn"]["data"]["data"]
        out[data["alias"]] = bytes.fromhex(data["verkey"])
    return out

