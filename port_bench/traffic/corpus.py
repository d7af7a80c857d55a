"""Signed requests made from the seed, the same for the same seed.

Every byte is drawn from SHA-256 of the seed and the item's index, so a
worker process can make any slice of a corpus alone, and the harness can
make again any item it needs. Signing is OpenSSL's (`cryptography`),
spread over the host's cores; it is input, not the system under test,
and the plain reference verifies what the checks sample.
"""
from __future__ import annotations

import hashlib
import multiprocessing
import os
import random

from port_bench.reference import codec
from port_bench.reference.ed25519 import L

NYM = "1"
# how a corrupted item is spoiled, drawn per item: a bit of R, a bit of
# S, S + L (the malleable twin a strict verifier refuses), or the signed
# bytes changed after signing
CORRUPTIONS = ("r_bit", "s_bit", "s_plus_l", "content")


def seeded(seed: int, tag: str, i: int) -> bytes:
    return hashlib.sha256(f"{seed}|{tag}|{i}".encode()).digest()


def corrupted_indices(seed: int, n: int, per_1000: int) -> set[int]:
    """per_1000 indices of every block of 1,000, drawn from the seed."""
    out: set[int] = set()
    for block in range(0, n, 1000):
        rng = random.Random(seeded(seed, "corrupt", block))
        out.update(block + j for j in rng.sample(range(1000), per_1000)
                   if block + j < n)
    return out


def _key(secret: bytes):
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric.ed25519 import \
        Ed25519PrivateKey
    sk = Ed25519PrivateKey.from_private_bytes(secret)
    vk = sk.public_key().public_bytes(serialization.Encoding.Raw,
                                      serialization.PublicFormat.Raw)
    return sk, vk


def verkey_of(secret: bytes) -> bytes:
    return _key(secret)[1]


def nym_payload(identifier: str, req_id: int, seed: int, i: int) -> dict:
    """A NYM's signed payload: a fresh DID and verkey drawn from the seed."""
    dest = codec.b58encode(seeded(seed, "dest", i)[:16])
    return {"identifier": identifier,
            "operation": {"dest": dest, "type": NYM,
                          "verkey": codec.b58encode(seeded(seed, "vk", i))},
            "protocolVersion": 2, "reqId": req_id}


def _spoil_sig(sig: bytes, kind: str, draw: bytes) -> bytes:
    if kind == "r_bit":
        bit = draw[0] % 255          # never R's sign bit alone
        r = bytearray(sig[:32])
        r[bit // 8] ^= 1 << (bit % 8)
        return bytes(r) + sig[32:]
    s = int.from_bytes(sig[32:], "little")
    if kind == "s_bit":
        s ^= 1 << (draw[0] % 248)
    else:                            # s_plus_l
        s += L
    return sig[:32] + s.to_bytes(32, "little")


def pool_slice(seed: int, trustee_secret: bytes, lo: int, hi: int,
               corrupted: frozenset) -> list:
    """Requests lo..hi-1 of a pool corpus, all by the trustee: ->
    [(request dict, digest, valid)]. reqId is the index plus one."""
    sk, vk = _key(trustee_secret)
    did = codec.did_of(vk)
    out = []
    for i in range(lo, hi):
        payload = nym_payload(did, i + 1, seed, i)
        sig = sk.sign(codec.signing_bytes(payload))
        valid = i not in corrupted
        if not valid:
            draw = seeded(seed, "spoil", i)
            kind = CORRUPTIONS[draw[1] % len(CORRUPTIONS)]
            if kind == "content":
                payload = dict(payload, operation=dict(
                    payload["operation"],
                    dest=codec.b58encode(seeded(seed, "forged", i)[:16])))
            else:
                sig = _spoil_sig(sig, kind, draw)
        req = dict(payload, signature=codec.b58encode(sig))
        out.append((req, codec.request_digest(req), valid))
    return out


def _call(job):
    fn, args = job
    return fn(*args)


class Making:
    """A corpus being made by spawned worker processes; get() waits for
    it, and the workers have ended when get() or stop() returns."""

    def __init__(self, fn, n: int, corrupted: set, args: tuple,
                 workers: int = 0, chunk: int = 4096):
        workers = workers or os.cpu_count() or 1
        self._jobs = [(fn, (*args, lo, min(n, lo + chunk),
                            frozenset(c for c in corrupted
                                      if lo <= c < lo + chunk)))
                      for lo in range(0, n, chunk)]
        self._pool = self._async = None
        if workers > 1 and len(self._jobs) > 1:
            ctx = multiprocessing.get_context("spawn")
            self._pool = ctx.Pool(min(workers, len(self._jobs)))
            self._async = self._pool.map_async(_call, self._jobs)

    def get(self) -> list:
        if self._pool is None:
            parts = [_call(j) for j in self._jobs]
        else:
            try:
                parts = self._async.get()
                self._pool.close()
            finally:
                self.stop()
        return [x for part in parts for x in part]

    def stop(self) -> None:
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()


def make(fn, n: int, corrupted: set, args: tuple, workers: int = 0,
         chunk: int = 4096) -> list:
    """fn(*args, lo, hi, corrupted-in-slice) over 0..n-1, in slices spread
    over `workers` spawned processes (0: the host's cores; 1: inline)."""
    return Making(fn, n, corrupted, args, workers, chunk).get()
