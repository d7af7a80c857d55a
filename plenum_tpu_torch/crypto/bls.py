"""BLS multi-signatures over BN254.

Reference behavior: crypto/bls/bls_crypto.py (BlsCryptoSigner/BlsCryptoVerifier
ABCs) + crypto/bls/indy_crypto/bls_crypto_indy_crypto.py (Ursa impl: sign :68,
verify :79, verify_multi_sig :94, aggregate MultiSignature.new :101, PoP :107).
Scheme: signatures in G1, verkeys in G2; aggregation is plain point addition,
multi-sig verification is a 2-pairing product check. Proof-of-possession binds
a verkey to its secret key under a separate hash domain, defeating rogue-key
attacks exactly as the reference's PoP does.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

from plenum_tpu_torch.utils.base58 import b58decode, b58encode

from . import bn254 as c

_MSG_DOMAIN = b"plenum_tpu/bls/msg/v1"
_POP_DOMAIN = b"plenum_tpu/bls/pop/v1"


# --- point serialization (uncompressed, infinity-flagged) --------------------

def g1_to_bytes(pt: c.G1Point) -> bytes:
    if pt is None:
        return b"\x00" * 64
    return pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")


def g1_from_bytes(data: bytes) -> c.G1Point:
    if len(data) != 64:
        raise ValueError("G1 point must be 64 bytes")
    if data == b"\x00" * 64:
        return None
    pt = (int.from_bytes(data[:32], "big"), int.from_bytes(data[32:], "big"))
    if not c.g1_is_on_curve(pt):
        raise ValueError("G1 point not on curve")
    return pt


def g2_to_bytes(pt: c.G2Point) -> bytes:
    if pt is None:
        return b"\x00" * 128
    (x0, x1), (y0, y1) = pt
    return b"".join(v.to_bytes(32, "big") for v in (x0, x1, y0, y1))


def g2_from_bytes(data: bytes) -> c.G2Point:
    if len(data) != 128:
        raise ValueError("G2 point must be 128 bytes")
    if data == b"\x00" * 128:
        return None
    vals = [int.from_bytes(data[i:i + 32], "big") for i in range(0, 128, 32)]
    pt = ((vals[0], vals[1]), (vals[2], vals[3]))
    if not c.g2_is_on_curve(pt):
        raise ValueError("G2 point not on curve")
    return pt


# --- keys and signatures -----------------------------------------------------

class BlsSignKey:
    def __init__(self, seed: Optional[bytes] = None):
        seed = seed if seed is not None else os.urandom(32)
        if len(seed) != 32:
            raise ValueError("seed must be 32 bytes")
        self.seed = seed
        self.sk = (int.from_bytes(seed, "big") % (c.R - 1)) + 1
        self._pk = c.g2_mul(c.G2_GEN, self.sk)

    @property
    def verkey(self) -> str:
        return b58encode(g2_to_bytes(self._pk))

    def sign(self, message: bytes) -> str:
        sig = c.g1_mul(c.hash_to_g1(message, _MSG_DOMAIN), self.sk)
        return b58encode(g1_to_bytes(sig))

    def generate_pop(self) -> str:
        """Proof of possession: sign the verkey bytes under the PoP domain."""
        h = c.hash_to_g1(g2_to_bytes(self._pk), _POP_DOMAIN)
        return b58encode(g1_to_bytes(c.g1_mul(h, self.sk)))


def _decode_sig(signature: str) -> c.G1Point:
    return g1_from_bytes(b58decode(signature))


def _decode_vk(verkey: str) -> c.G2Point:
    pt = g2_from_bytes(b58decode(verkey))
    if pt is None or not c.g2_in_subgroup(pt):
        raise ValueError("verkey not in G2 subgroup")
    return pt


def verify(signature: str, message: bytes, verkey: str) -> bool:
    """e(σ, G2) == e(H(m), pk)  ⇔  e(σ, G2)·e(-H(m), pk)... — done as one
    2-pair product check with a shared final exponentiation."""
    try:
        sig = _decode_sig(signature)
        pk = _decode_vk(verkey)
    except (ValueError, KeyError):
        return False
    h = c.hash_to_g1(message, _MSG_DOMAIN)
    return c.pairing_check([(c.G2_GEN, c.g1_neg(sig)), (pk, h)])


def verify_pop(pop: str, verkey: str) -> bool:
    try:
        sig = _decode_sig(pop)
        pk = _decode_vk(verkey)
    except (ValueError, KeyError):
        return False
    h = c.hash_to_g1(b58decode(verkey), _POP_DOMAIN)
    return c.pairing_check([(c.G2_GEN, c.g1_neg(sig)), (pk, h)])


def aggregate_sigs(signatures: Sequence[str]) -> str:
    agg: c.G1Point = None
    for s in signatures:
        agg = c.g1_add(agg, _decode_sig(s))
    return b58encode(g1_to_bytes(agg))


def aggregate_verkeys(verkeys: Sequence[str]) -> c.G2Point:
    agg: c.G2Point = None
    for v in verkeys:
        agg = c.g2_add(agg, _decode_vk(v))
    return agg


def batch_coefficients(n: int) -> list[int]:
    """n fresh 128-bit odd (hence nonzero) scalars for the random-linear-
    combination batch check. They MUST be unpredictable and freshly drawn
    per batch: under a fixed or replayable combination an adversary who
    learns the coefficients can submit a signature pair whose errors cancel
    under exactly that combination and have both accepted. 128 bits keeps
    the cheat probability at 2^-127 while the G1/G2 ladders stay half the
    length of full-width R scalars."""
    return [int.from_bytes(os.urandom(16), "big") | 1 for _ in range(n)]


def _combined_pairs(entries: Sequence[tuple]) -> list:
    """THE random-linear-combination construction, shared by every batch
    check (soundness-critical — one copy only): decoded (sig_pt, msg_bytes,
    pk_pt) triples -> the pairing_check pair list
    [(G2, -Σrᵢσᵢ)] + [(Σ_{mᵢ=m} rᵢpkᵢ, H(m)) per distinct m], under fresh
    coefficients."""
    coeffs = batch_coefficients(len(entries))
    agg_sig: c.G1Point = None
    by_msg: dict[bytes, c.G2Point] = {}
    for (sig, msg, pk), r in zip(entries, coeffs):
        agg_sig = c.g1_add(agg_sig, c.g1_mul(sig, r))
        by_msg[msg] = c.g2_add(by_msg.get(msg), c.g2_mul(pk, r))
    return [(c.G2_GEN, c.g1_neg(agg_sig))] + \
        [(pk, c.hash_to_g1(msg, _MSG_DOMAIN)) for msg, pk in by_msg.items()]


def batch_verify_combined(items: Sequence[tuple[str, bytes, str]]) -> bool:
    """ONE pairing_check over n (signature, message, verkey) triples.

    Random linear combination (Benitez-Correa et al., arXiv:2302.00418 —
    batched verification is the deciding factor for committee-consensus
    throughput): draw fresh rᵢ, then every σᵢ is simultaneously valid
    (w.p. 1 - 2^-127) iff

        e(-Σ rᵢσᵢ, G2) · ∏_m e(H(m), Σ_{i: mᵢ=m} rᵢ·pkᵢ) == 1.

    Grouping by distinct message means the commit path — n signatures over
    ONE state-root value — costs 2 pairings total (amortized O(1) in n),
    plus n short half-width scalar ladders. Unlike plain aggregation
    (Σσᵢ vs Σpkᵢ), a passing combined check certifies each signature
    INDIVIDUALLY: a pair of bad signatures whose errors cancel under plain
    addition cannot cancel under unknown fresh coefficients.

    False on any malformed input (same contract as verify); raises nothing.
    """
    items = list(items)
    if not items:
        return True
    try:
        entries = [(_decode_sig(s), m, _decode_vk(v)) for s, m, v in items]
    except (ValueError, KeyError):
        return False
    return c.pairing_check(_combined_pairs(entries))


def verify_multi_sig(signature: str, message: bytes,
                     verkeys: Sequence[str]) -> bool:
    """Verify an aggregated signature by all of `verkeys` over one message
    (ref Bls.verify_multi_sig :94 — PoP model, so plain key aggregation)."""
    if not verkeys:
        return False
    try:
        sig = _decode_sig(signature)
        pk = aggregate_verkeys(verkeys)
    except (ValueError, KeyError):
        return False
    h = c.hash_to_g1(message, _MSG_DOMAIN)
    return c.pairing_check([(c.G2_GEN, c.g1_neg(sig)), (pk, h)])


# --- provider seam (ref crypto/bls/bls_crypto.py ABCs) ----------------------

class BlsCryptoSigner:
    """Holds this node's BLS secret; signs state roots during COMMIT."""

    def __init__(self, seed: Optional[bytes] = None):
        self._key = BlsSignKey(seed)

    @property
    def pk(self) -> str:
        return self._key.verkey

    def sign(self, message: bytes) -> str:
        return self._key.sign(message)

    def generate_pop(self) -> str:
        return self._key.generate_pop()

    @staticmethod
    def generate_keys(seed: Optional[bytes] = None) -> tuple[str, str]:
        """(verkey, pop) for key-distribution txns (ref bls_key_manager)."""
        key = BlsSignKey(seed)
        return key.verkey, key.generate_pop()


# Process-wide verdict cache for the per-batch pairing checks, shared by
# every BlsCryptoVerifier: in a co-hosted topology each node runs the
# IDENTICAL aggregate check (same multi-sig, same state root, same
# participant set) at order time, and a pairing costs ~4 ms. One shared
# digest/eviction implementation (crypto/ed25519.py) serves every
# verdict cache in the package.
from plenum_tpu_torch.crypto.ed25519 import (content_digest as _bls_verdict_key,
                                             verdict_cache_put as _cache_put)

_BLS_VERDICTS: dict[bytes, bool] = {}
_BLS_VERDICTS_MAX = 16384

# Process-wide named counters for the BLS batch-verify plane: how often
# the one-pairing combined fast path settled a batch vs fell back to
# per-signature culprit naming (malformed input or a failing combined
# check). Sampled by the node's metric flush as cumulative gauges — a
# rising fallback rate is the operator's first sign of a bad signer (or
# a bug) long before throughput moves.
BATCH_STATS = {"batches": 0, "combined_ok": 0, "fallbacks": 0,
               "per_sig_checks": 0}


def _bls_cache_put(key: bytes, verdict: bool) -> bool:
    return _cache_put(_BLS_VERDICTS, _BLS_VERDICTS_MAX, key, verdict)


class BlsCryptoVerifier:
    """Stateless verification provider; caches decoded verkeys."""

    def __init__(self):
        self._vk_cache: dict[str, c.G2Point] = {}

    def _pk(self, verkey: str) -> c.G2Point:
        pt = self._vk_cache.get(verkey)
        if pt is None:
            pt = _decode_vk(verkey)
            self._vk_cache[verkey] = pt
        return pt

    def evict_key(self, verkey) -> None:
        """Key rotation: drop the rotated-out verkey's decoded point from
        the key table (node._on_pool_changed calls this for every BLS
        rotation it observes). Verdict caches are content-keyed — they
        cannot return a wrong answer for the new key — but a dead key's
        warm decode row is cache budget a Byzantine signer leans on."""
        if isinstance(verkey, str):
            self._vk_cache.pop(verkey, None)

    def is_wellformed_sig(self, signature: str) -> bool:
        """Structural check only (b58 + on-curve): the cheap gate used by
        deferred COMMIT validation; the pairing runs later in aggregate."""
        try:
            _decode_sig(signature)
            return True
        except (ValueError, KeyError):
            return False

    def verify_sig(self, signature: str, message: bytes, verkey: str) -> bool:
        key = _bls_verdict_key(b"sig", signature.encode(), message,
                               verkey.encode())
        hit = _BLS_VERDICTS.get(key)
        if hit is not None:
            return hit
        try:
            sig = _decode_sig(signature)
            pk = self._pk(verkey)
        except (ValueError, KeyError):
            return _bls_cache_put(key, False)
        h = c.hash_to_g1(message, _MSG_DOMAIN)
        return _bls_cache_put(key, c.pairing_check(
            [(c.G2_GEN, c.g1_neg(sig)), (pk, h)]))

    def verify_multi_sig(self, signature: str, message: bytes,
                         verkeys: Sequence[str]) -> bool:
        if not verkeys:
            return False
        key = _bls_verdict_key(b"multi", signature.encode(), message,
                               *sorted(v.encode() for v in verkeys))
        hit = _BLS_VERDICTS.get(key)
        if hit is not None:
            return hit
        try:
            sig = _decode_sig(signature)
            pk: c.G2Point = None
            for v in verkeys:
                pk = c.g2_add(pk, self._pk(v))
        except (ValueError, KeyError):
            return _bls_cache_put(key, False)
        h = c.hash_to_g1(message, _MSG_DOMAIN)
        return _bls_cache_put(key, c.pairing_check(
            [(c.G2_GEN, c.g1_neg(sig)), (pk, h)]))

    def batch_verify(self, items: Sequence[tuple[str, bytes, str]]
                     ) -> list[bool]:
        """Verdicts for n (signature, message, verkey) triples.

        Happy path — every signature honest — is ONE combined pairing_check
        (2 pairings when all messages agree, as Commit sigs do; see
        batch_verify_combined). Only when the combined check fails (or an
        input is malformed) does it fall back to per-signature 2-pairing
        checks, which name the culprit(s) exactly; those verdicts ride the
        process-wide cache, so re-checking a batch after evicting a bad
        signer costs one fresh combined check, not n pairings."""
        items = list(items)
        if not items:
            return []
        # A passing combined check certifies each signature INDIVIDUALLY
        # (unlike plain aggregation), so per-signature verdicts are shared
        # with verify_sig through the process-wide cache: co-hosted nodes
        # batch-checking the identical COMMIT set (sim pools, multi-replica
        # hosts) pay the pairings once per host, dict hits after.
        verdicts: list[Optional[bool]] = []
        cache_keys: list[bytes] = []
        for sig_b58, msg, vk_b58 in items:
            k = _bls_verdict_key(b"sig", sig_b58.encode(), msg,
                                 vk_b58.encode())
            cache_keys.append(k)
            verdicts.append(_BLS_VERDICTS.get(k))
        todo = [i for i, vd in enumerate(verdicts) if vd is None]
        if not todo:
            return [bool(v) for v in verdicts]
        BATCH_STATS["batches"] += 1
        decoded: dict[int, tuple] = {}
        malformed = False
        for i in todo:
            sig_b58, msg, vk_b58 = items[i]
            try:
                decoded[i] = (_decode_sig(sig_b58), msg, self._pk(vk_b58))
            except (ValueError, KeyError):
                malformed = True
        if not malformed:
            if c.pairing_check(_combined_pairs([decoded[i] for i in todo])):
                BATCH_STATS["combined_ok"] += 1
                for i in todo:
                    _bls_cache_put(cache_keys[i], True)
                    verdicts[i] = True
                return [bool(v) for v in verdicts]
        # combined check failed or input malformed: per-signature culprit
        # naming — counted, never silent (a rising rate flags a bad signer)
        BATCH_STATS["fallbacks"] += 1
        BATCH_STATS["per_sig_checks"] += len(todo)
        for i in todo:
            s, m, v = items[i]
            verdicts[i] = (i in decoded) and self.verify_sig(s, m, v)
        return [bool(v) for v in verdicts]

    def create_multi_sig(self, signatures: Sequence[str]) -> str:
        return aggregate_sigs(signatures)

    def verify_key_proof_of_possession(self, pop: str, verkey: str) -> bool:
        return verify_pop(pop, verkey)
