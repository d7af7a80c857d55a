"""Client request authentication — the primary Ed25519 hot spot, batch-first.

Reference behavior: plenum/server/client_authn.py (NaclAuthNr:82 scalar verify
per signer, CoreAuthNr:273 resolving DID→verkey from domain state) and
req_authenticator.py:11 — every node verifies every propagated request
(node.py:2624), which is why SURVEY.md §3.2 marks this n×-per-request path as
the throughput ceiling.

Device-first design difference: the API is batch-shaped end to end.
`authenticate_batch` collects every (message, signature, verkey) triple across
a whole quota of requests and issues ONE device dispatch through the
Ed25519Verifier seam (by default the cuda backend's kernels); per-request verdicts map back to accept/reject exactly
like the reference's per-message path (SURVEY.md §7 hard part 1).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from plenum_tpu_torch.common.host_spans import AUTH, RECORDER
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.crypto.ed25519 import Ed25519Verifier, make_verifier
from plenum_tpu_torch.utils.base58 import b58decode


class AuthError(Exception):
    pass


class MissingSignature(AuthError):
    pass


class InvalidSignature(AuthError):
    pass


class UnknownIdentifier(AuthError):
    pass


class CoreAuthNr:
    """Verifies request signatures against DID verkeys from domain state.

    get_verkey(did) -> base58 verkey or None; abbreviated verkeys ("~xxx")
    are completed with the DID prefix bytes, as indy DIDs do. Without a
    verifier it verifies on the card (make_verifier("cuda")), and raises
    when there is none.
    """

    def __init__(self, verifier: Optional[Ed25519Verifier] = None,
                 get_verkey=None):
        self.verifier = verifier or make_verifier("cuda")
        self._get_verkey = get_verkey or (lambda did: None)

    def _resolve_verkey(self, idr: str) -> Optional[bytes]:
        vk = self._get_verkey(idr)
        if vk is None:
            # self-certifying DID: identifier IS the verkey (or its prefix)
            try:
                raw = b58decode(idr)
            except Exception:
                return None
            return raw if len(raw) == 32 else None
        try:
            if vk.startswith("~"):     # abbreviated: DID bytes || suffix
                return b58decode(idr) + b58decode(vk[1:])
            return b58decode(vk)
        except Exception:
            return None

    def collect_items(self, request: Request) -> Optional[list[tuple[bytes, bytes, bytes]]]:
        """(msg, sig, vk) per signer, or None if any signer is unresolvable.
        Raises MissingSignature when no signature is present at all."""
        sigs = request.all_signatures()
        if not sigs:
            raise MissingSignature(f"request {request.req_id} is unsigned")
        # a named endorser MUST be a signer: authorization will count the
        # endorser's role, so an unsigned endorsement would let anyone
        # borrow a trustee's permissions by just naming them
        if request.endorser is not None and request.endorser not in sigs:
            return None
        msg = request.signing_bytes()
        items = []
        for idr, sig_b58 in sigs.items():
            vk = self._resolve_verkey(idr)
            if vk is None:
                return None
            try:
                sig = b58decode(sig_b58)
            except Exception:
                return None
            items.append((msg, sig, vk))
        return items

    def authenticate(self, request: Request) -> list[str]:
        """-> list of verified identifiers; raises on failure."""
        verdicts = self.authenticate_batch([request])
        if not verdicts[0]:
            raise InvalidSignature(f"request {request.req_id} failed auth")
        return list(request.all_signatures())

    @RECORDER.spanning(AUTH)
    def submit_batch(self, requests: Sequence[Request]):
        """Stage ONE device dispatch for all signatures of all requests;
        returns an opaque token for collect_batch. The dispatch is
        asynchronous on the cuda backend — callers can overlap the device
        round-trip with other work (the node's pipelined prod loop does)."""
        spans: list[tuple[int, int]] = []       # [start, end) into items
        items: list[tuple[bytes, bytes, bytes]] = []
        hard_fail = np.zeros(len(requests), dtype=bool)
        for i, req in enumerate(requests):
            try:
                got = self.collect_items(req)
            except MissingSignature:
                got = None
            if got is None:
                hard_fail[i] = True
                spans.append((len(items), len(items)))
                continue
            spans.append((len(items), len(items) + len(got)))
            items.extend(got)
        vtoken = self.verifier.submit_batch(items) if items else None
        return (spans, hard_fail, vtoken, len(requests))

    @RECORDER.spanning(AUTH)
    def collect_batch(self, token, wait: bool = True) -> Optional[np.ndarray]:
        """-> bool[N] verdicts, or None if wait=False and the device is
        still computing. A request passes only if EVERY signer's signature
        verifies (multi-sig endorsement, ref authenticate_multi:84)."""
        spans, hard_fail, vtoken, n = token
        if vtoken is not None:
            ok = self.verifier.collect_batch(vtoken, wait=wait)
            if ok is None:
                return None
        else:
            ok = np.zeros(0, dtype=bool)
        out = np.zeros(n, dtype=bool)
        for i, (start, end) in enumerate(spans):
            out[i] = (not hard_fail[i]) and bool(ok[start:end].all()) \
                and end > start
        return out

    def authenticate_batch(self, requests: Sequence[Request]) -> np.ndarray:
        return self.collect_batch(self.submit_batch(requests), wait=True)

    @staticmethod
    def token_item_count(token) -> int:
        """Signature items staged behind one submit_batch token — the
        measured auth batch size (in device-verify items, which exceeds
        the request count for multi-signed requests)."""
        spans, _hard_fail, _vtoken, _n = token
        return spans[-1][1] if spans else 0


class ReqAuthenticator:
    """Registry of authenticators; all registered must accept
    (ref req_authenticator.py:23)."""

    def __init__(self):
        self._authnrs: list[CoreAuthNr] = []

    def register_authenticator(self, authnr: CoreAuthNr) -> None:
        self._authnrs.append(authnr)

    @property
    def core_authenticator(self) -> CoreAuthNr:
        return self._authnrs[0]

    def authenticate(self, request: Request) -> list[str]:
        out: list[str] = []
        for a in self._authnrs:
            out = a.authenticate(request)
        return out

    def authenticate_batch(self, requests: Sequence[Request]) -> np.ndarray:
        verdict = np.ones(len(requests), dtype=bool)
        for a in self._authnrs:
            verdict &= a.authenticate_batch(requests)
        return verdict

    def submit_batch(self, requests: Sequence[Request]):
        return [a.submit_batch(requests) for a in self._authnrs]

    def token_item_count(self, tokens) -> int:
        """Device-verify items staged by the FIRST (core) authenticator's
        dispatch for a submit_batch token list — the figure the ingress
        plane publishes as its measured auth batch size."""
        if not tokens:
            return 0
        return CoreAuthNr.token_item_count(tokens[0])

    def collect_batch(self, tokens, wait: bool = True) -> Optional[np.ndarray]:
        """None while ANY registered authenticator's device is busy."""
        verdicts = []
        for a, token in zip(self._authnrs, tokens):
            v = a.collect_batch(token, wait=wait)
            if v is None:
                return None
            verdicts.append(v)
        out = verdicts[0]
        for v in verdicts[1:]:
            out &= v
        return out
