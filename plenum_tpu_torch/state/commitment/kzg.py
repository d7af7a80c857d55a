"""KZG polynomial commitments over BN254 for the wide-branching state
commitment (TS-Verkle shape, PAPERS.md).

A tree node of width W is a polynomial f over the evaluation domain
{0..W-1}: f(i) = the i-th child's scalar. The node's commitment is
C = [f(tau)]_1; opening slot z to value y is the standard KZG check

    e(C - y*G1, G2) == e(pi, [tau - z]_2),

and a SET of openings across many nodes aggregates into ONE (D, pi)
pair via the Verkle multiproof (random r folds the quotients, a second
challenge t reduces everything to a single opening at t) — which is what
makes a 16-key client page cost two pairings and ~one commitment per
path node instead of 16 sibling chains.

## Trust model — read this before comparing to production Verkle

The SRS here is a *transparent toy*: tau is derived from a public
nothing-up-my-sleeve seed, NOT from a multi-party ceremony. Anyone who
reads this file can compute tau and forge openings. That is acceptable
for this reproduction because (a) the pool's Byzantine model for reads
is already "a lying node tampers with replies", and every tamper/fuzz
rung exercises exactly that, and (b) the VERIFIER is oblivious to how
the SRS was made — its cost profile (the TS-Verkle verifier-side cost
model: one small MSM + two pairings per aggregated proof) and its wire
format are the real thing, so the bytes-per-read and verify-time
numbers published by the bench transfer. A production deployment swaps
`TAU`-derived shortcuts for a ceremony SRS + Lagrange-basis MSM; the
prover entry points below are the seam (and the pipeline's commitment
wave kind is where a device MSM would slot).

Knowing tau also makes the honest prover O(1) group ops: f(tau) is
computed in the scalar field by barycentric evaluation, so commit =
one G1 mul and a whole multiproof = two G1 muls. Verification performs
the genuine group arithmetic (per-opening MSM terms + pairing check) —
the side millions of WAN clients actually pay.
"""
from __future__ import annotations

import hashlib
from typing import Optional, Sequence

from plenum_tpu_torch.crypto import bn254
from plenum_tpu_torch.crypto.bn254 import (G1_GEN, G2_GEN, R, g1_add, g1_mul,
                                           g1_neg, g2_add, g2_mul, g2_neg,
                                           pairing_check)

# the public toy-SRS secret (see module docstring trust model)
TAU = int.from_bytes(
    hashlib.sha256(b"plenum_tpu-kzg-transparent-srs-v1").digest(),
    "big") % R
TAU_G2 = g2_mul(G2_GEN, TAU)

# G1 point encoding: bn254's fixed 64-byte affine form (zeros = infinity)
enc_g1 = bn254._enc_g1
dec_g1 = bn254._dec_g1

_DOMAIN_SEP = b"plenum-verkle-mp-v1"


def _inv_r(a: int) -> int:
    return pow(a, -1, R)


def hash_to_scalar(data: bytes) -> int:
    return int.from_bytes(hashlib.sha256(data).digest(), "big") % R


class KzgEngine:
    """Per-width commitment engine. Widths are powers of two <= 256; the
    evaluation domain is {0..width-1}. One instance is cached per width
    (`engine_for`) because the barycentric weights cost O(W^2) to build.
    """

    def __init__(self, width: int):
        if width < 2 or width > 256 or width & (width - 1):
            raise ValueError(f"width must be a power of two in [2,256], "
                             f"got {width}")
        self.width = width
        # l_j(tau) = prod_{k!=j}(tau-k) / prod_{k!=j}(j-k), all mod R.
        # P = prod_k (tau-k); l_j = P * inv(tau-j) * inv(denom_j)
        p_all = 1
        for k in range(width):
            p_all = p_all * ((TAU - k) % R) % R
        fact = [1] * (width + 1)
        for i in range(1, width + 1):
            fact[i] = fact[i - 1] * i % R
        self._l_tau = []
        for j in range(width):
            denom = fact[j] * fact[width - 1 - j] % R
            if (width - 1 - j) % 2:
                denom = R - denom
            self._l_tau.append(
                p_all * _inv_r((TAU - j) % R) % R * _inv_r(denom) % R)

    # --- prover side -------------------------------------------------------

    def f_tau(self, evals) -> int:
        """f(tau) from a sparse evaluation map {slot: scalar} (or a dense
        sequence) via the precomputed Lagrange-at-tau weights."""
        acc = 0
        items = evals.items() if isinstance(evals, dict) \
            else enumerate(evals)
        for j, v in items:
            if v:
                acc = (acc + v * self._l_tau[j]) % R
        return acc

    def commit(self, evals) -> tuple[int, bytes]:
        """-> (f_tau, enc(C)) for one node's child-scalar vector."""
        ft = self.f_tau(evals)
        return ft, enc_g1(g1_mul(G1_GEN, ft))


_ENGINES: dict[int, KzgEngine] = {}


def engine_for(width: int) -> KzgEngine:
    eng = _ENGINES.get(width)
    if eng is None:
        eng = _ENGINES[width] = KzgEngine(width)
    return eng


# --- aggregated multiproof ---------------------------------------------------
#
# openings (prover): sequence of (c_enc, f_tau, z, y)
# openings (verifier): sequence of (c_enc, z, y)
# with z in [0, width) and y the claimed evaluation. The transcript binds
# (C, z, y) triples in order, so prover and verifier must present the
# SAME canonical ordering (the Verkle backend sorts by (c_enc, z)).


def _transcript_r(openings) -> tuple[int, bytes]:
    h = hashlib.sha256(_DOMAIN_SEP)
    h.update(len(openings).to_bytes(4, "big"))
    for op in openings:
        c_enc, z, y = op[0], op[-2], op[-1]
        h.update(c_enc)
        h.update(int(z).to_bytes(2, "big"))
        h.update(int(y).to_bytes(32, "big"))
    seed = h.digest()
    return (int.from_bytes(seed, "big") % R) or 1, seed


def _transcript_t(seed: bytes, d_enc: bytes) -> int:
    return (int.from_bytes(
        hashlib.sha256(b"t" + seed + d_enc).digest(), "big") % R) or 1


def prove_multi(openings: Sequence[tuple]) -> tuple[bytes, bytes]:
    """openings: [(c_enc, f_tau, z, y)] -> (enc(D), enc(pi)).

    Every honest opening satisfies f(z) = y; the caller is responsible
    for that (the Verkle backend derives y from the same node vector it
    committed). Cost: O(n) field ops + 2 G1 muls (toy-SRS shortcut)."""
    if not openings:
        raise ValueError("empty opening set")
    r, seed = _transcript_r(openings)
    g_tau = 0
    r_pow = 1
    for _, ft, z, y in openings:
        g_tau = (g_tau + r_pow * ((ft - y) % R)
                 % R * _inv_r((TAU - z) % R)) % R
        r_pow = r_pow * r % R
    d_enc = enc_g1(g1_mul(G1_GEN, g_tau))
    t = _transcript_t(seed, d_enc)
    h_tau = 0
    y_t = 0
    r_pow = 1
    for _, ft, z, y in openings:
        w = _inv_r((t - z) % R)
        h_tau = (h_tau + r_pow * ft % R * w) % R
        y_t = (y_t + r_pow * y % R * w) % R
        r_pow = r_pow * r % R
    q = ((h_tau - g_tau - y_t) % R) * _inv_r((TAU - t) % R) % R
    return d_enc, enc_g1(g1_mul(G1_GEN, q))


def verify_multi(openings: Sequence[tuple], d_enc: bytes,
                 pi_enc: bytes) -> bool:
    """openings: [(c_enc, z, y)] -> bool. The real verifier: a small MSM
    over the cited commitments + one 2-pairing check. Never raises —
    malformed points/values verify False (fail closed)."""
    try:
        if not openings:
            return False
        r, seed = _transcript_r(openings)
        t = _transcript_t(seed, d_enc)
        # fold per-commitment scalars first: a page's openings repeat the
        # same upper-path commitments, and one mul per DISTINCT point is
        # the verifier-side cost model the bench publishes
        coef: dict[bytes, int] = {}
        y_t = 0
        r_pow = 1
        for c_enc, z, y in openings:
            z, y = int(z), int(y) % R
            if not 0 <= z < 256:
                return False
            w = _inv_r((t - z) % R)        # t == z has ~2^-248 probability
            coef[bytes(c_enc)] = (coef.get(bytes(c_enc), 0)
                                  + r_pow * w) % R
            y_t = (y_t + r_pow * y % R * w) % R
            r_pow = r_pow * r % R
        e_pt = None
        for c_enc, k in coef.items():
            pt = dec_g1(c_enc)
            if pt is not None and not bn254.g1_is_on_curve(pt):
                return False
            e_pt = g1_add(e_pt, g1_mul(pt, k))
        d_pt = dec_g1(bytes(d_enc))
        pi_pt = dec_g1(bytes(pi_enc))
        for pt in (d_pt, pi_pt):
            if pt is not None and not bn254.g1_is_on_curve(pt):
                return False
        # A = E - D - y_t*G1 must equal pi * (tau - t)
        a_pt = g1_add(g1_add(e_pt, g1_neg(d_pt)),
                      g1_neg(g1_mul(G1_GEN, y_t)))
        q2 = g2_add(TAU_G2, g2_neg(g2_mul(G2_GEN, t)))   # (tau - t)*G2
        return pairing_check([(G2_GEN, a_pt), (q2, g1_neg(pi_pt))])
    except Exception:
        return False
