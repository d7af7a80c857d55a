"""Ed25519 provider seam: sign + batched verify with cpu, torch and cuda backends.

Reference behavior: stp_core/crypto/nacl_wrappers.py:179,212 (Signer/Verifier
over libsodium) and plenum/server/client_authn.py:273 (CoreAuthNr verifying
every propagated request on every node — the primary hot spot).

The seam's contract is batch-first (SURVEY.md §7 stage 2): callers hand a
vector of (message, signature, verkey) and get a verdict vector back. The cpu
backend loops over the C library (or the pure-Python verifier where
`cryptography` is absent); the cuda backend stages the whole batch into one
launch of each of the two Ed25519 kernels (plenum_tpu_torch/ops/ed25519.py);
the torch backend runs the kernels' plain PyTorch versions on the CPU, for
tests. Malformed items and S >= L are rejected host-side and never reach the
device; invalid keys are rejected by the key kernel's validity mask.
"""
from __future__ import annotations

import hashlib
import time
from abc import ABC, abstractmethod
from typing import Optional, Sequence

import numpy as np
import torch

from plenum_tpu_torch import ops
from plenum_tpu_torch.common.host_spans import AUTH, RECORDER
from plenum_tpu_torch.common.metrics import MetricsName
from plenum_tpu_torch.utils.base58 import b58encode

try:
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey, Ed25519PublicKey)
    _HAVE_CRYPTOGRAPHY = True
except Exception:  # pragma: no cover
    _HAVE_CRYPTOGRAPHY = False

from plenum_tpu_torch.ops import ed25519 as _ops

VerifyItem = tuple[bytes, bytes, bytes]   # (message, signature64, verkey32)


class _DeviceToken:
    """In-flight device verification: the launched verdict tensor, the
    event recorded after it (None on the CPU), and the mapping back to the
    caller's item order."""

    __slots__ = ("ok", "event", "idxs", "n")

    def __init__(self, ok, event, idxs, n):
        self.ok = ok
        self.event = event
        self.idxs = idxs
        self.n = n


class Ed25519Signer:
    """Deterministic Ed25519 signing from a 32-byte seed.

    Uses the C library when `cryptography` is importable; otherwise falls
    back to the package's own RFC 8032 implementation (ops/ed25519
    extended-coordinate ladder, ~4 ms/sign) so nothing above this seam
    needs the dependency."""

    def __init__(self, seed: Optional[bytes] = None):
        import os
        self._seed = seed if seed is not None else os.urandom(32)
        assert len(self._seed) == 32
        if _HAVE_CRYPTOGRAPHY:
            self._sk = Ed25519PrivateKey.from_private_bytes(self._seed)
            from cryptography.hazmat.primitives import serialization
            self._vk = self._sk.public_key().public_bytes(
                serialization.Encoding.Raw, serialization.PublicFormat.Raw)
        else:
            self._sk = None
            h = hashlib.sha512(self._seed).digest()
            a = int.from_bytes(h[:32], "little")
            a &= (1 << 254) - 8
            a |= 1 << 254
            self._pp_scalar, self._pp_prefix = a, h[32:]
            self._vk = _ops.compress(
                _ops.ext_scalar_mul(a, (_ops.BX, _ops.BY)))

    @property
    def seed(self) -> bytes:
        return self._seed

    @property
    def verkey(self) -> bytes:
        return self._vk

    @property
    def verkey_b58(self) -> str:
        return b58encode(self._vk)

    @property
    def identifier(self) -> str:
        """DID-style identifier: base58 of the first 16 verkey bytes (as indy)."""
        return b58encode(self._vk[:16])

    def sign(self, msg: bytes) -> bytes:
        if self._sk is not None:
            return self._sk.sign(msg)
        r = int.from_bytes(hashlib.sha512(self._pp_prefix + msg).digest(),
                           "little") % _ops.L
        r_enc = _ops.compress(_ops.ext_scalar_mul(r, (_ops.BX, _ops.BY)))
        k = int.from_bytes(hashlib.sha512(r_enc + self._vk + msg).digest(),
                           "little") % _ops.L
        s = (r + k * self._pp_scalar) % _ops.L
        return r_enc + s.to_bytes(32, "little")

    def sign_b58(self, msg: bytes) -> str:
        return b58encode(self.sign(msg))


class Ed25519Verifier(ABC):
    @abstractmethod
    def verify_batch(self, items: Sequence[VerifyItem]) -> np.ndarray:
        """-> bool[N] verdicts; NEVER raises on malformed input."""

    def verify(self, msg: bytes, sig: bytes, vk: bytes) -> bool:
        return bool(self.verify_batch([(msg, sig, vk)])[0])

    # --- async pipelining seam -------------------------------------------
    # The device backend overrides these so a caller can overlap the device
    # round-trip with other work (accumulate-then-flush, SURVEY.md §7):
    # submit returns immediately after dispatch; collect(wait=False) returns
    # None while the device is still computing. The default (CPU) behavior
    # computes at submit, so collect is always immediately ready.

    def submit_batch(self, items: Sequence[VerifyItem]):
        return self.verify_batch(items)

    def collect_batch(self, token, wait: bool = True) -> Optional[np.ndarray]:
        return token


_VK_VALID_CACHE: dict[bytes, bool] = {}
# verkey -> decompressible. The modular sqrt inside decompress costs ~140 us
# of pure Python per call — more than the OpenSSL verify itself — and real
# traffic re-uses verkeys heavily (every request from a client carries the
# same key). The verdict is a pure function of the 32 bytes, so caching can
# never change a verdict, only skip recomputation. Bounded: reset at 8192
# entries (a pool sees far fewer distinct signers between resets).


def _vk_decompressible(vk: bytes) -> bool:
    got = _VK_VALID_CACHE.get(vk)
    if got is None:
        if len(_VK_VALID_CACHE) >= 8192:
            _VK_VALID_CACHE.clear()
        got = _VK_VALID_CACHE[vk] = _ops.decompress(vk) is not None
    return got


def _precheck(msg, sig, vk) -> bool:
    """Canonicality checks shared by BOTH backends so they can never disagree
    (a backend-verdict split on the same bytes would fork a BFT pool):
    reject non-canonical point encodings (y >= p) and S >= L, which OpenSSL
    accepts but RFC 8032 strict verification rejects."""
    try:
        if len(sig) != 64 or len(vk) != 32 or not isinstance(
                msg, (bytes, bytearray, memoryview)):
            return False
        if not _vk_decompressible(bytes(vk)):
            return False
        # R is deliberately NOT validated here: both backends resolve a bad R
        # by the recomputed-R' byte compare (ref10 semantics), so the verdicts
        # still agree and the hot path skips a per-signature modular sqrt.
        return int.from_bytes(bytes(sig[32:]), "little") < _ops.L
    except Exception:
        return False


def content_digest(*parts: bytes) -> bytes:
    """THE length-prefixed content digest for every verdict cache in the
    package (this module, crypto/bls.py, parallel/crypto_service.py).
    The prefixes are load-bearing: without them an attacker could shift
    bytes between adjacent fields ((msg, sig+vk[:1], vk[1:]) would hash
    like the honest triple), pre-poison a False verdict, and make every
    cache user reject a validly signed input."""
    h = hashlib.sha256()
    for part in parts:
        h.update(len(part).to_bytes(4, "big"))
        h.update(part)
    return h.digest()


def verdict_cache_put(cache: dict, maxsize: int, key: bytes,
                      verdict: bool) -> bool:
    """Bounded FIFO insert shared by the verdict caches (attacker-supplied
    content must never grow them without bound); returns the verdict.
    Tolerates concurrent callers (the crypto service verifies BLS in
    executor threads): a key another thread already evicted is skipped,
    not raised."""
    if len(cache) >= maxsize:
        for k in list(cache)[:maxsize // 8]:
            cache.pop(k, None)
    cache[key] = verdict
    return verdict


# Process-wide verdict cache shared by every CpuEd25519Verifier: in a
# co-hosted topology (the in-process pool, or several nodes embedded in
# one OS process) each node verifies the same client signature once —
# identical content, identical verdict — so the 2nd..nth node rides the
# 1st's result. Single-node processes pay one sha256 (~1 us) against a
# ~110 us verify.
_CPU_VERDICTS: dict[bytes, bool] = {}
_CPU_VERDICTS_MAX = 65536


class CpuEd25519Verifier(Ed25519Verifier):
    """Scalar loop over the C library — the measured CPU baseline. Without
    `cryptography` it degrades to the package's own RFC 8032 verifier
    (ops.pure_python_verify, ~2 ms/sig): slower, but verdict-identical —
    both run strict checks behind the shared _precheck, so a mixed pool
    cannot fork on backend choice."""

    def __init__(self):
        # verkey bytes -> parsed OpenSSL key object; parsing costs ~12 us
        # per call and keys repeat per client. Bounded like _VK_VALID_CACHE.
        self._pk_cache: dict = {}

    def _pk(self, vk: bytes) -> Ed25519PublicKey:
        pk = self._pk_cache.get(vk)
        if pk is None:
            if len(self._pk_cache) >= 8192:
                self._pk_cache.clear()
            pk = self._pk_cache[vk] = \
                Ed25519PublicKey.from_public_bytes(vk)
        return pk

    def evict_key(self, vk) -> None:
        """Key rotation: drop the rotated-out key's parsed object."""
        if isinstance(vk, bytes):
            self._pk_cache.pop(vk, None)

    def verify_batch(self, items: Sequence[VerifyItem]) -> np.ndarray:
        out = np.zeros(len(items), dtype=bool)
        for i, (msg, sig, vk) in enumerate(items):
            try:
                msg, sig, vk = bytes(msg), bytes(sig), bytes(vk)
            except Exception:
                continue      # contract: malformed input is a False verdict
            key = content_digest(msg, sig, vk)
            hit = _CPU_VERDICTS.get(key)
            if hit is not None:
                out[i] = hit
                continue
            ok = False
            if _precheck(msg, sig, vk):
                if _HAVE_CRYPTOGRAPHY:
                    try:
                        self._pk(vk).verify(sig, msg)
                        ok = True
                    except Exception:
                        ok = False
                else:
                    ok = _ops.pure_python_verify(msg, sig, vk)
            out[i] = verdict_cache_put(_CPU_VERDICTS, _CPU_VERDICTS_MAX,
                                       key, ok)
        return out


class TorchEd25519Verifier(Ed25519Verifier):
    """Batched device verification (the JAX package's JaxEd25519Verifier).

    Two dispatches, as in the reference, chosen by `_compressed_dispatch`:

    - bytes (the default): host prep per item is split sig into (R, S),
      reject S >= L, h = SHA512(R||A||M) mod L, and dedup the verkeys
      into a key table plus an index per signature. Everything ships as
      raw bytes (32 B S + 32 B h + 32 B R + 4 B key index per signature,
      32 B per distinct verkey); the device decompresses each distinct
      key once and builds its window tables (K3), then runs one ladder
      per signature (K4). R is never decompressed — the kernel compares
      the recomputed R' as bytes (ref10 semantics).
    - limbs: the host decompresses each new verkey and stages -A's
      quarter points as 13-bit limb rows (`ext_quarters`, ~1 ms of
      pure Python per key, cached FIFO-bounded in `_pt_cache`), and the
      signature's digit arrays; the device builds the tables from the
      rows (K5) and runs the same ladder on the staged digits (K6).

    Both give the same verdict on every input. `device` is where the
    batch runs: a CUDA device launches the kernels, "cpu" runs their
    plain versions; None means the card, and raises when there is none.
    Batches are not padded (`_pad` does nothing here): without an
    XLA-style compile per shape, padding would only add work. The
    sharded verifier pads, since its grid must tile.
    """

    _compressed_dispatch = True

    def __init__(self, device=None, cache_size: int = 65536):
        self.device = ops.resolve_device(device)
        # verkeys are attacker-supplied; the cache must be bounded (FIFO
        # evict). value: int32[4, 4, 20] quarter-point rows, or None for
        # invalid keys
        self._pt_cache: dict[bytes, Optional[np.ndarray]] = {}
        self._cache_size = cache_size

    # --- the limb path's key cache ----------------------------------------

    def _neg_a_limbs(self, vk: bytes) -> Optional[np.ndarray]:
        if vk in self._pt_cache:
            return self._pt_cache[vk]
        a = _ops.decompress(vk)
        if a is None:
            rows = None
        else:
            neg = ((_ops.P - a[0]) % _ops.P, a[1])         # -A = (-x, y)
            rows = _ops.ext_quarters(neg)
        if len(self._pt_cache) >= self._cache_size:
            self._pt_cache.pop(next(iter(self._pt_cache)))
        self._pt_cache[vk] = rows
        return rows

    def _decompress_cached(self, vk: bytes):
        """Cached decompression of a verkey -> affine A, or None."""
        rows = self._neg_a_limbs(vk)
        if rows is None:
            return None
        x = _ops.limbs_to_int(rows[0, 0])
        y = _ops.limbs_to_int(rows[0, 1])
        return ((_ops.P - x) % _ops.P, y)

    def evict_key(self, vk) -> None:
        """Key rotation: drop a rotated-out verkey's staged rows."""
        if isinstance(vk, bytes):
            self._pt_cache.pop(vk, None)

    def rewarm(self) -> None:
        """Drop the staged key material so the next dispatch re-stages
        it (after a device restart the host cache describes uploads the
        device no longer holds)."""
        self._pt_cache.clear()

    def _pad(self, per_sig: list, keys: list) -> None:
        """Hook to pad the staged per-signature lists and the key list in
        place; the sharded verifier pads, this one does not."""

    # --- staging ------------------------------------------------------------

    @RECORDER.spanning(AUTH)
    def stage_bytes(self, items: Sequence[VerifyItem]):
        """Host staging: per item one sha512 + one mod-L reduction.
        -> (idxs, tensors): the positions of the items that reach the
        device and the kernels' inputs (s, h, keys, idx, r) on
        self.device, or None when no item does. Invalid verkeys are NOT
        screened here — the device's decompression validity mask forces
        their verdicts False (the verdict the cpu backend's host precheck
        gives, so backends can never disagree)."""
        idxs: list[int] = []
        s_vals: list[bytes] = []
        h_vals: list[bytes] = []
        r_enc: list[bytes] = []
        uniq: dict[bytes, int] = {}
        u_keys: list[bytes] = []
        a_idx: list[int] = []
        for i, (msg, sig, vk) in enumerate(items):
            try:
                msg, sig, vk = bytes(msg), bytes(sig), bytes(vk)
                if len(sig) != 64 or len(vk) != 32:
                    continue
                if int.from_bytes(sig[32:], "little") >= _ops.L:
                    continue
                h = int.from_bytes(
                    hashlib.sha512(sig[:32] + vk + msg).digest(),
                    "little") % _ops.L
            except Exception:
                continue    # contract: malformed input is a False verdict
            u = uniq.get(vk)
            if u is None:
                u = uniq[vk] = len(u_keys)
                u_keys.append(vk)
            idxs.append(i)
            s_vals.append(sig[32:])
            h_vals.append(h.to_bytes(32, "little"))
            r_enc.append(sig[:32])
            a_idx.append(u)
        if not idxs:
            return idxs, None
        self._pad([s_vals, h_vals, r_enc, a_idx], u_keys)
        return idxs, (self._rows(s_vals), self._rows(h_vals),
                      self._rows(u_keys),
                      torch.tensor(a_idx, dtype=torch.int32).to(self.device),
                      self._rows(r_enc))

    def stage_limbs(self, items: Sequence[VerifyItem]):
        """Host staging of the limb dispatch (the reference's
        `_dispatch_limbs`): -> (idxs, arrays), arrays the numpy inputs
        (s_digits int32[32, M], h_digits int32[16, 4, M], aq_unique
        int32[U, 4, 4, 20], idx int32[M], ry int32[M, 20], r_sign
        int32[M]), or None when no item reaches the device. Items under
        an invalid verkey are screened here, on the host."""
        idxs, s_vals, h_vals, r_enc = [], [], [], []
        # verkeys repeat heavily in pool traffic: ship one row per
        # DISTINCT key plus an index vector, gathered on device
        uniq: dict[bytes, int] = {}
        u_rows: list[np.ndarray] = []
        a_idx: list[int] = []
        for i, (msg, sig, vk) in enumerate(items):
            try:
                msg, sig, vk = bytes(msg), bytes(sig), bytes(vk)
                if len(sig) != 64 or len(vk) != 32:
                    continue
                rows = self._neg_a_limbs(vk)
                if rows is None:
                    continue
                s = int.from_bytes(sig[32:], "little")
                if s >= _ops.L:
                    continue
                h = int.from_bytes(
                    hashlib.sha512(sig[:32] + vk + msg).digest(),
                    "little") % _ops.L
            except Exception:
                continue    # contract: malformed input is a False verdict
            u = uniq.get(vk)
            if u is None:
                u = uniq[vk] = len(u_rows)
                u_rows.append(rows)
            idxs.append(i)
            s_vals.append(s)
            h_vals.append(h)
            a_idx.append(u)
            r_enc.append(sig[:32])
        if not idxs:
            return idxs, None
        self._pad([s_vals, h_vals, a_idx, r_enc], u_rows)
        qmask = (1 << _ops.QUARTER_SHIFT) - 1
        s_digits = _ops.scalar_windows(s_vals, _ops.N_COMB, _ops.CBITS)
        h_digits = np.stack([
            _ops.scalar_windows(
                [(h >> (_ops.QUARTER_SHIFT * q)) & qmask for h in h_vals],
                _ops.N_WIN)
            for q in range(_ops.N_QUARTERS)], axis=1)   # [N_WIN, 4, m]
        ry, r_sign = _ops.r_bytes_to_limbs(r_enc)
        return idxs, (s_digits, h_digits, np.stack(u_rows),
                      np.asarray(a_idx, dtype=np.int32), ry, r_sign)

    # --- dispatch -------------------------------------------------------------

    def _dispatch(self, items: Sequence[VerifyItem]):
        if self._compressed_dispatch:
            return self._dispatch_bytes(items)
        return self._dispatch_limbs(items)

    def _dispatch_bytes(self, items: Sequence[VerifyItem]):
        idxs, staged = self.stage_bytes(items)
        return self._launch(len(items), idxs, staged,
                            self._device_verify_bytes)

    def _dispatch_limbs(self, items: Sequence[VerifyItem]):
        idxs, staged = self.stage_limbs(items)
        return self._launch(len(items), idxs, staged, self._device_verify)

    @staticmethod
    def _launch(n: int, idxs, staged, device_verify):
        if staged is None:
            return np.zeros(n, dtype=bool)     # all malformed: ready
        ok = device_verify(*staged)
        event = None
        if ok.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(ok.device))
        return _DeviceToken(ok, event, idxs, n)

    def _device_verify_bytes(self, s_u8, h_u8, k_u8, idx, r_u8):
        """Staged byte tensors -> flat verdicts (K3 then K4)."""
        return _ops.verify_kernel_bytes(s_u8, h_u8, k_u8, idx, r_u8)

    def _device_verify(self, s_digits, h_digits, aq_unique, idx, ry, r_sign):
        """Staged limb arrays -> flat verdicts (K5 then K6). Subclasses
        re-route the dispatch (the sharded verifier cuts it over a mesh);
        the host staging is the same either way."""
        return _ops.verify_kernel_indexed(
            *_ops.stage_on(self.device, s_digits, h_digits, aq_unique, idx,
                           ry, r_sign))

    def _rows(self, rows: list[bytes]) -> torch.Tensor:
        raw = np.frombuffer(b"".join(rows), np.uint8).reshape(len(rows), 32)
        return torch.from_numpy(raw.copy()).to(self.device)

    # verify_batch = submit + blocking collect; submit_batch returns right
    # after the (asynchronous) kernel launches
    def submit_batch(self, items: Sequence[VerifyItem]):
        return self._dispatch(items)

    def collect_batch(self, token, wait: bool = True) -> Optional[np.ndarray]:
        if isinstance(token, np.ndarray):
            return token                       # empty/hard-fail fast path
        if not wait and token.event is not None and not token.event.query():
            return None
        ok = token.ok.cpu().numpy()
        verdict = np.zeros(token.n, dtype=bool)
        verdict[token.idxs] = ok[:len(token.idxs)]     # pad rows dropped
        return verdict

    def verify_batch(self, items: Sequence[VerifyItem]) -> np.ndarray:
        return self.collect_batch(self.submit_batch(items), wait=True)


# the coalescing plane's verdict cache is SEPARATE from _CPU_VERDICTS so
# cpu-vs-device differential tests never settle a device query from a
# cpu-computed verdict
_PLANE_VERDICTS: dict[bytes, bool] = {}
_PLANE_VERDICTS_MAX = 65536


class CoalescingVerifier(Ed25519Verifier):
    """Process-wide crypto plane for CO-HOSTED nodes: coalesces the
    signature batches of every node sharing this host's device into ONE
    kernel dispatch per flush.

    Rationale (SURVEY.md §2.3): the verify kernel is serial-depth
    bound, so its cost is nearly flat in batch size — four nodes dispatching
    128-item batches pay 4x the wall-clock of one 512-item dispatch. In a
    production pool each node runs on its own host and owns its device, but
    a multi-replica host (or the 4-nodes-1-chip bench topology) should share
    one plane, exactly like co-located RBFT instances share one device
    program. Each node still verifies independently — only the DISPATCH is
    shared; verdict spans map back per submitter.

    Protocol: submit_batch stages items and returns a queued token;
    the next collect_batch (or flush()) with the device idle dispatches
    everything staged. One dispatch in flight at a time — while busy, new
    submissions stage for the next flush (natural backpressure, same as
    the per-node pipeline).
    """

    class _Token:
        __slots__ = ("items", "verdicts", "inner")

        def __init__(self, items):
            self.items = items
            self.verdicts = None    # np.ndarray once resolved
            # per-item plan set by flush(): ("k", verdict, None) for a
            # cache/malformed verdict, ("d", dispatch_idx, key) for an
            # item riding the device dispatch
            self.inner = None

    def __init__(self, inner: "TorchEd25519Verifier"):
        self._inner = inner
        self._staged: list[CoalescingVerifier._Token] = []
        self._in_flight: Optional[tuple] = None   # (tok, [tokens], t_disp)
        # perf observability (VERDICT r2 item 9): the node that most
        # recently attached its collector reports the plane's stats —
        # fill latency, dispatch wall time, batch size
        self.metrics = None
        self._first_staged_at: Optional[float] = None

    def flush(self) -> bool:
        """Dispatch everything staged if the device is idle. -> dispatched?

        Content dedup before the device: co-hosted nodes stage the SAME
        client signatures (one copy per node), so each unique triple is
        dispatched once per flush and verdicts are remembered across
        flushes in a process-wide cache — identical semantics (a verdict
        is a pure function of content), n× less device work."""
        if self._in_flight is not None or not self._staged:
            return False
        batch = self._staged
        self._staged = []
        items: list[VerifyItem] = []
        todo: dict[bytes, int] = {}          # key -> dispatch index
        for tok in batch:
            entries = []
            for it in tok.items:
                try:
                    m, s, v = bytes(it[0]), bytes(it[1]), bytes(it[2])
                except Exception:
                    entries.append(("k", False, None))   # malformed: False
                    continue
                key = content_digest(m, s, v)
                hit = _PLANE_VERDICTS.get(key)
                if hit is not None:
                    entries.append(("k", hit, None))
                elif key in todo:
                    entries.append(("d", todo[key], key))
                else:
                    todo[key] = len(items)
                    entries.append(("d", len(items), key))
                    items.append((m, s, v))
            tok.inner = entries
        now = time.perf_counter()
        first_staged_at = self._first_staged_at
        self._first_staged_at = None
        if not items:
            # everything rode the cache: resolve now, nothing in flight,
            # and no batch-size/fill events — those track real dispatches
            for tok in batch:
                tok.verdicts = np.array(
                    [e[1] for e in tok.inner], dtype=bool)
            return False
        if self.metrics is not None:
            self.metrics.add_event(MetricsName.SIG_BATCH_SIZE, len(items))
            if first_staged_at is not None:
                self.metrics.add_event(MetricsName.SIG_BATCH_FILL_TIME,
                                       now - first_staged_at)
        inner_tok = self._inner.submit_batch(items)
        self._in_flight = (inner_tok, batch, now)
        return True

    def _resolve_in_flight(self, wait: bool) -> bool:
        if self._in_flight is None:
            return True
        inner_tok, batch, t_disp = self._in_flight
        ok = self._inner.collect_batch(inner_tok, wait=wait)
        if ok is None:
            return False
        if self.metrics is not None:
            self.metrics.add_event(MetricsName.SIG_DISPATCH_TIME,
                                   time.perf_counter() - t_disp)
        filled: set = set()
        for tok in batch:
            verdicts = np.zeros(len(tok.inner), dtype=bool)
            for i, (kind, val, key) in enumerate(tok.inner):
                if kind == "k":
                    verdicts[i] = val
                else:
                    verdicts[i] = bool(ok[val])
                    if key is not None and key not in filled:
                        filled.add(key)
                        verdict_cache_put(_PLANE_VERDICTS,
                                          _PLANE_VERDICTS_MAX, key,
                                          bool(ok[val]))
            tok.verdicts = verdicts
        self._in_flight = None
        return True

    def submit_batch(self, items: Sequence[VerifyItem]):
        tok = CoalescingVerifier._Token(list(items))
        if not self._staged:
            self._first_staged_at = time.perf_counter()
        self._staged.append(tok)
        return tok

    def collect_batch(self, token, wait: bool = True) -> Optional[np.ndarray]:
        while token.verdicts is None:
            if self._in_flight is not None:
                # resolve whatever is flying (ours or an earlier flush);
                # a not-ready async dispatch surfaces as None to the poller
                if not self._resolve_in_flight(wait):
                    return None
            elif wait:
                # blocking collect must make progress: flush the stage
                # (our token included) and resolve it
                self.flush()
            else:
                # non-blocking poll of a still-staged token does NOT flush —
                # coalescing depends on every co-hosted node staging its
                # cycle's batch before the shared flush() fires (a node's
                # pipelined submit+poll would otherwise dispatch solo)
                return None
        return token.verdicts

    def verify_batch(self, items: Sequence[VerifyItem]) -> np.ndarray:
        return self.collect_batch(self.submit_batch(items), wait=True)


def make_verifier(backend: str = "cuda", min_batch: int = 1,
                  supervised: Optional[bool] = None) -> Ed25519Verifier:
    """The verifier for a backend name:

      "cuda"          the kernels on the card (the default); raises
                      without a GPU
      "cuda-sharded"  the sharded crypto plane over every CUDA device
                      (parallel/crypto_plane.py; "jax-sharded" in the
                      reference); raises without a GPU
      "torch"         the kernels' plain PyTorch versions on the CPU (tests)
      "torch-sharded" the sharded plane's plain versions over four
                      explicit CPU shards (tests)
      "cpu"           the host baseline: the C library, or the
                      pure-Python RFC 8032 verifier where `cryptography`
                      is absent
      "service"       the cross-process crypto plane: batches go to the
                      one process that owns the card
                      (parallel/crypto_service.py; socket from
                      PLENUM_CRYPTO_SOCKET), supervised by default

    min_batch: the sharded backends pad every batch to at least this
    power of two (and to one that tiles their mesh); the single-device
    ones do not pad and take no min_batch.

    supervised: wrap the verifier in the plane supervisor
    (parallel/supervisor.py: circuit breaker, hedged dispatch and
    backpressure, each routing work to the CPU verifier). None, the
    default, wraps the CPU backends ("torch", "torch-sharded") as the
    reference wraps its device verifiers, and leaves the card's bare: a
    failed launch raises instead of turning into CPU verdicts. A caller
    that opts in on the card must read the supervisor's counters.
    "service" is wrapped too, as the reference wraps it: the card lies
    in another process, and a node must outlive that process by
    degrading to CPU verdicts (the service reports its own faults in its
    stats). A cuda verifier finds its device and builds its kernels
    here, before any wrapping, so a missing card or a failed nvcc build
    raises from make_verifier, never inside submit_batch."""
    if backend == "cuda":
        v = TorchEd25519Verifier(device="cuda")
    elif backend == "torch":
        v = TorchEd25519Verifier(device="cpu")
    elif backend in ("cuda-sharded", "torch-sharded"):
        # deferred: parallel/ is not needed by the single-device backends
        from plenum_tpu_torch.parallel.crypto_plane import \
            make_sharded_verifier
        v = make_sharded_verifier(
            min_batch=min_batch,
            devices=None if backend == "cuda-sharded" else ["cpu"] * 4)
    elif backend == "cpu":
        return CpuEd25519Verifier()
    elif backend == "service":
        # cross-process crypto plane: the card has ONE owner process and
        # co-hosted nodes ship batches to it
        from plenum_tpu_torch.parallel.crypto_service import \
            ServiceEd25519Verifier
        v = ServiceEd25519Verifier()
        if supervised is False:
            return v
        from plenum_tpu_torch.parallel.supervisor import supervise
        return supervise(v)
    else:
        raise ValueError(f"unknown Ed25519 backend {backend!r} (want 'cuda', "
                         "'cuda-sharded', 'torch', 'torch-sharded', 'cpu' "
                         "or 'service')")
    on_card = v.device.type == "cuda"
    if on_card:
        # build and load now (one nvcc per source, all at once); the
        # sharded plane also reduces Merkle roots (sha256.cu)
        names = ("ed25519",) if backend == "cuda" else ("sha256", "ed25519")
        for name in ops.build(names):
            ops.lib(name)
    if supervised is False or (supervised is None and on_card):
        return v
    from plenum_tpu_torch.parallel.supervisor import supervise
    return supervise(v)


def warm_up(verifier: Ed25519Verifier) -> Ed25519Verifier:
    """-> verifier, after one verify of a signature made here on the
    verifier beneath any plane supervisor. A verifier on the card pays
    its CUDA context and its kernels' module load at its first dispatch
    (seconds in a fresh process), which a supervisor's cold deadline
    (0.5 s plus 20 ms an item) would count as a miss and hedge on the
    CPU: a process that serves verifies warms its verifier before it
    takes work. Raises if the signature is refused."""
    from plenum_tpu_torch.parallel.supervisor import find_supervisor
    sup = find_supervisor(verifier)
    device = verifier if sup is None else sup._device
    signer = Ed25519Signer(seed=b"warm-up".ljust(32, b"\0"))
    item = (b"warm-up", signer.sign(b"warm-up"), signer.verkey)
    if not device.verify_batch([item]).all():
        raise RuntimeError("the verifier refused a valid signature at "
                           "warm-up")
    return verifier
