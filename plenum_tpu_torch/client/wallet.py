"""Client wallet: identifier/key management + request signing.

Reference behavior: plenum/client/wallet.py:51 (Wallet: addIdentifier,
signMsg/signRequest with per-identifier signers, pending request ids) and
stp_core/crypto/signer.py. The DID convention matches the rest of this
framework: identifier = base58 of the first 16 verkey bytes, verkey
published in full (node/client_authn.py resolution rules).
"""
from __future__ import annotations

import os
import time
from typing import Optional

from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer


class Wallet:
    """Holds signers by identifier; signs requests; tracks req ids."""

    def __init__(self, name: str = "wallet"):
        self.name = name
        self._signers: dict[str, Ed25519Signer] = {}
        self.default_id: Optional[str] = None
        self._req_id = int(time.time() * 1000)

    # --- keys -------------------------------------------------------------

    def add_identifier(self, seed: Optional[bytes] = None) -> str:
        """Create (or import from a 32-byte seed) an identifier; returns its
        DID. The first identifier becomes the default."""
        signer = Ed25519Signer(seed=seed)
        did = signer.identifier
        self._signers[did] = signer
        if self.default_id is None:
            self.default_id = did
        return did

    def identifiers(self) -> list[str]:
        return list(self._signers)

    def verkey_of(self, identifier: str) -> str:
        return self._signers[identifier].verkey_b58

    def signer_of(self, identifier: str) -> Ed25519Signer:
        return self._signers[identifier]

    # --- signing ----------------------------------------------------------

    def next_req_id(self) -> int:
        self._req_id += 1
        return self._req_id

    def sign_request(self, operation: dict,
                     identifier: Optional[str] = None) -> Request:
        """Build + sign a write/read request for an operation dict
        (e.g. {"type": NYM, "dest": ..., "verkey": ...})."""
        idr = identifier or self.default_id
        if idr is None:
            raise ValueError("wallet has no identifiers")
        signer = self._signers[idr]
        req = Request(idr, self.next_req_id(), dict(operation))
        req.signature = signer.sign_b58(req.signing_bytes())
        return req

    def sign_message(self, msg: bytes, identifier: Optional[str] = None) -> str:
        idr = identifier or self.default_id
        return self._signers[idr].sign_b58(msg)

    # --- persistence ------------------------------------------------------
    # Seeds on disk, 0600, one file — the reference pickles wallets via
    # ClientWalletPersistence; a key file is the minimal durable equivalent.

    def save(self, path: str) -> None:
        from plenum_tpu_torch.common.serialization import pack
        data = pack({"name": self.name, "default": self.default_id,
                     "seeds": {did: s.seed for did, s in self._signers.items()}})
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "wb") as f:
            f.write(data)

    @classmethod
    def load(cls, path: str) -> "Wallet":
        from plenum_tpu_torch.common.serialization import unpack
        with open(path, "rb") as f:
            data = unpack(f.read())
        wallet = cls(data["name"])
        for did, seed in data["seeds"].items():
            got = wallet.add_identifier(seed=seed)
            assert got == did, "wallet file corrupt: seed/did mismatch"
        wallet.default_id = data["default"]
        return wallet
