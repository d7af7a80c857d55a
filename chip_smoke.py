"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            (from the root of the repository)

Builds the port's CUDA kernels from plenum_tpu_torch/csrc/ with nvcc and
drives the port's paths on the card:

  1. kernels vs plain versions: each kernel's wrapper (K1-K8) on CUDA
     tensors at the main paths' shapes, held bit for bit against its
     plain PyTorch version on the same inputs (tolerance: none — integer
     arithmetic); K5's tables also hold the same points as K3's; K3-K6
     also at 1, 5 and 33 keys or signatures (a lone quad, a partial warp,
     a tail block), with invalid keys and out-of-range key indices; K1
     also at the batch's 992 leaves and at 1, 5 and 33 messages of 1-9
     blocks, against hashlib too; K2's wave at N = 2 ... 262,144 under
     five offset patterns, one k_merkle_wave launch up to 1,024 leaves
     and one k_merkle_wave_tiled launch beyond, no k_merkle_level; K7 at
     N = 2 ... 262,144 (one launch up to 512 leaves, two beyond); then
     the wave at alternating sizes queued back to back (a stale arrival
     counter would show as a wrong level);
  2. path A, slice 1, end to end: 1,000 signed NYM requests
     (Max3PCBatchSize) from 1,000 DIDs, 8 of them corrupted,
     authenticated through make_verifier("cuda"); the accepted requests'
     txns staged, rooted and committed on a domain ledger pre-filled to
     100,003 txns; then one catchup-scale append_batch of 65,536 txns at
     default thresholds (one k_merkle_wave_tiled launch), and one of
     4,096 txns on a hasher that declines the fused wave (its two widest
     levels one k_merkle_level launch each). Roots must equal a hashlib
     ledger's fed the same txns, proofs must verify; each batch must take
     2 K1 and 2 k_merkle_wave launches and no other SHA-256 launch, the
     path 4 K1, 2 k_merkle_wave, 1 k_merkle_wave_tiled and 2
     k_merkle_level;
  3. path B, the sharded crypto plane (slice 2): the same 1,000 requests
     through make_verifier("cuda-sharded") by the byte dispatch and by the
     limb dispatch (cold, then warm key cache); ShardedCryptoPlane over a
     4-shard roster wrapped onto the card at grid [2, 1,024] (the batch
     padded to 1,024 lanes, once per RBFT instance) with 1,024 leaf
     digests, by step_bytes and step; then graft_entry.dryrun_multichip(4).
     Verdicts must be exactly the expected ones and roots hashlib's;
  4. path C, the field-chain probe: x^(2^64) over 2,048 columns;
  5. times: per kernel, the median of CUDA-event-timed launches after
     warm-up, its plain version's time, and its bound on this card (K3-K6,
     one quad of four threads per item, at 32, 64 and 128 threads per
     block, each result held to the default's; the plane's steps also
     with every kernel's plain version in its place); for the SHA-256 kernels
     also the device time that torch.profiler traces and the chain floor
     (the device time of one message alone; for K2 and K7 one level's
     device time plus, per further level, the slope of device time over
     waves of 1-5 levels); the tiled wave at 2,048 and 65,536 leaves; a
     wave as one k_merkle_level launch per level;
     the inversion's share of K4; the plane's steps and the sharded
     batches.

Each path runs with the launch counters set to 0 just before it and read
just after; the run fails if a kernel of that path was never launched.
Prints JSON lines (kernels, paths, device) and, last, one JSON object
{"ok": true, "device": {...}}. Exits non-zero, with no result line, when
there is no CUDA device or any phase fails. Imports nothing of JAX.

    python3 chip_smoke.py --sha-device-times

only prints the device time and the CUDA-event time of the SHA-256
kernels of the package beside the script (K1, K2's wave at 1,024, 2,048
and 65,536 leaves and its level, K7 at 1,024 and 65,536) at the paths'
shapes, through
wrappers every version of the port has: a copy of the script in another
checkout times that checkout's kernels, so two trees compare in one call.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time


def _smi(query: str) -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""


# --- instruction counts from the built library's SASS --------------------
# Pipes of an SM of compute capability 9.0 (four sub-partitions, each
# issuing one warp instruction per clock): the integer ALU pipe and the
# FMA-heavy pipe (IMAD, IMUL) each retire 64 thread-instructions per clock
# per SM; all instructions together issue at most 128 per clock per SM.
# An opcode in neither set below is counted only against the issue rate,
# so every count errs low and the bound stays a lower bound.
_ALU = {"LOP3", "LOP", "PLOP3", "SHF", "IADD3", "ISETP", "SEL", "LEA",
        "PRMT", "IMNMX", "IABS", "BMSK"}
_FMA = {"IMAD", "IMUL", "IDP", "FFMA", "FMUL", "FADD"}
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P(?:T|\d+)\s+)?"
                   r"([A-Z][A-Z0-9_.]*)([^;]*);")


def _cuobjdump() -> str:
    cands = [shutil.which("cuobjdump"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "cuobjdump")]
    spec = importlib.util.find_spec("triton")
    if spec and spec.origin:
        cands.append(os.path.join(os.path.dirname(spec.origin), "backends",
                                  "nvidia", "bin", "cuobjdump"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("cuobjdump not found: the SHA-256 bound is counted "
                       "from the kernels' SASS")


def sass_profile(lib_path: str, kernel: str) -> dict:
    """Instruction counts of one __global__ function of a built library,
    per pipe ("alu", "fma", "all"), split into one pass of its outermost
    loop's body, inner loops counted once ("body", empty when it has no
    loop), and everything else ("rest"); "loops" is the number of loops.
    Raises unless every loop lies inside one outermost loop."""
    out = subprocess.run([_cuobjdump(), "-sass", lib_path], check=True,
                         capture_output=True, text=True, timeout=120).stdout
    insns, name = [], None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            continue
        m = _INSN.search(line)
        if m and name and kernel in name:
            insns.append((int(m.group(1), 16), m.group(2), m.group(3)))
    if not insns:
        raise RuntimeError(f"no SASS for {kernel} in {lib_path}")

    def target(op, args):
        hexes = re.findall(r"0x[0-9a-f]+", args) if op.startswith("BRA") else []
        return int(hexes[-1], 16) if hexes else None

    # drop the end-of-function spin (a branch to itself) and the padding
    real = [(a, op, args) for a, op, args in insns
            if op != "NOP" and target(op, args) != a]
    loops = [(target(op, args), a) for a, op, args in real
             if target(op, args) is not None and target(op, args) < a]
    lo, hi = (min(a for a, _ in loops), max(b for _, b in loops)) \
        if loops else (1, 0)
    if loops and (lo, hi) not in loops:
        raise RuntimeError(f"{kernel}: {len(loops)} loops in its SASS, "
                           f"not nested in one")
    prof = {"body": {"alu": 0, "fma": 0, "all": 0},
            "rest": {"alu": 0, "fma": 0, "all": 0}, "opcodes": {},
            "loops": len(loops)}
    for a, op, _ in real:
        base = op.split(".")[0]
        part = prof["body" if lo <= a <= hi else "rest"]
        part["all"] += 1
        if base in _ALU:
            part["alu"] += 1
        elif base in _FMA:
            part["fma"] += 1
        prof["opcodes"][base] = prof["opcodes"].get(base, 0) + 1
    prof["opcodes"] = dict(sorted(prof["opcodes"].items(),
                                  key=lambda kv: -kv[1])[:12])
    return prof


def device_ms(fn, reps: int = 20, tries: int = 3):
    """Device time of one call of fn from what torch.profiler traces over
    reps calls (after one warm call): per kernel name, the mean time of
    its launches times its launches per call, summed, so that an event
    the trace drops does not bias the sum low; a trace with no kernel is
    taken again, up to tries times. "not measured: ..." where the
    profiler cannot trace the card."""
    import torch
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        for _ in range(tries):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            by_name: dict[str, list[float]] = {}
            for ev in prof.events():
                if ev.device_type == DeviceType.CUDA and \
                        not ev.name.startswith(("Memcpy", "Memset")):
                    by_name.setdefault(ev.name, []).append(
                        ev.time_range.elapsed_us())
            if by_name:
                return sum(statistics.fmean(us) * max(1, round(len(us) / reps))
                           for us in by_name.values()) / 1e3
    except (ImportError, RuntimeError) as exc:
        return f"not measured: {type(exc).__name__}: {exc}"
    return "not measured: the profiler traced no kernel"


def median_ms(fn, reps: int, warm: int = 2) -> float:
    """Median CUDA-event time of one call of fn, ms, after warm calls."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def sha_device_times() -> int:
    """The --sha-device-times mode (module docstring): two passes of each
    kernel's device time and of its event time (the median of 20 calls),
    ms per call, on inputs made from a seed."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import numpy as np

    from plenum_tpu_torch.ops import sha256 as sha
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)

    def words(n):
        return torch.from_numpy(rng.integers(-2**31, 2**31, size=(n, 8),
                                             dtype=np.int64).astype(np.int32)).to(dev)
    msgs = sha.to_tensor(np.stack([sha.pad_to_words(rng.bytes(340))
                                   for _ in range(992)]), dev)   # 6 blocks
    wave0, pairs, bounds, leaves = words(1024), words(1024), words(16), \
        words(65536)
    offs = torch.tensor([1, 0, 1, 1, 0, 0, 1, 0, 1, 0, 1, 1, 0, 1, 0, 0],
                        dtype=torch.int32, device=dev)
    cases = {"k1_992_msgs_6_blocks": lambda: sha.sha256_words(msgs),
             "k2_wave_1024": lambda: sha.merkle_wave(wave0, bounds[:10],
                                                     offs[:10]),
             "k2_wave_2048": lambda: sha.merkle_wave(leaves[:2048],
                                                     bounds[:11], offs[:11]),
             "k2_wave_65536": lambda: sha.merkle_wave(leaves, bounds, offs),
             "k2_level_1024_pairs": lambda: sha.hash_interior(wave0, pairs),
             "k7_1024": lambda: sha.merkle_reduce_pow2(wave0),
             "k7_65536": lambda: sha.merkle_reduce_pow2(leaves)}
    times = {k: [device_ms(fn) for _ in range(2)] for k, fn in cases.items()}
    events = {k: [median_ms(fn, 20) for _ in range(2)]
              for k, fn in cases.items()}
    print(json.dumps({"sha_device_ms": times, "sha_event_ms": events,
                      "tree": root, "gpu": _smi("name,power.limit")}))
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from plenum_tpu_torch import graft_entry, ops
    from plenum_tpu_torch.common.request import Request
    from plenum_tpu_torch.common.serialization import pack
    from plenum_tpu_torch.convert import ledger_from_rows
    from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer, make_verifier
    from plenum_tpu_torch.execution.txn import NYM, new_txn
    from plenum_tpu_torch.ledger.compact_merkle_tree import CompactMerkleTree
    from plenum_tpu_torch.ledger.hash_store import HashStore
    from plenum_tpu_torch.ledger.ledger import Ledger, txn_to_leaf
    from plenum_tpu_torch.ledger.merkle_verifier import MerkleVerifier
    from plenum_tpu_torch.ledger.tree_hasher import TreeHasher, make_tree_hasher
    from plenum_tpu_torch.node.client_authn import CoreAuthNr, ReqAuthenticator
    from plenum_tpu_torch.ops import ed25519 as ed
    from plenum_tpu_torch.ops import sha256 as sha
    from plenum_tpu_torch.ops.field_chain import field_chain, field_chain_torch
    from plenum_tpu_torch.parallel.crypto_plane import (
        ShardedCryptoPlane, ShardedTorchEd25519Verifier)
    from plenum_tpu_torch.parallel.mesh import lane_roster, make_mesh
    from plenum_tpu_torch.utils.base58 import b58decode, b58encode

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    print(json.dumps({"python": sys.version.split()[0], "torch": torch.__version__,
                      "cuda": torch.version.cuda,
                      "gpu": torch.cuda.get_device_name(0)}))

    # --- build -------------------------------------------------------------
    t0 = time.perf_counter()
    lib_paths = ops.build()
    build_s = time.perf_counter() - t0
    # per kernel: ptxas's register, stack and spill lines
    ptxas: dict[str, list[str]] = {}
    kernel = None
    for name in ("sha256", "ed25519"):
        for ln in ops.build_log(name).splitlines():
            m = re.search(r"Function properties for _Z(\d+)(\w+)", ln)
            if m:       # the mangled name: _Z<length><name><arguments>
                kernel = m.group(2)[:int(m.group(1))]
            elif kernel and ("registers" in ln or "spill" in ln):
                ptxas.setdefault(kernel, []).append(
                    ln.split(":", 1)[-1].strip())
    print(json.dumps({"build_s": build_s, "ptxas": ptxas}))

    rng = np.random.default_rng(20261017)
    max_err: dict[str, int] = {k: 0 for k in ops.LAUNCHES}

    def require_launched(path: str, counts: dict, kernels) -> None:
        unlaunched = [k_ for k_ in kernels if counts[k_] == 0]
        if unlaunched:
            raise AssertionError(f"kernels never launched on the {path} "
                                 f"path: {unlaunched}")

    def bit_equal(kernel: str, got: torch.Tensor, want: torch.Tensor) -> None:
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{kernel}: {got.dtype}{list(got.shape)} vs "
                                 f"{want.dtype}{list(want.shape)}")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        max_err[kernel] = max(max_err[kernel], err)
        if err:
            raise AssertionError(f"{kernel} disagrees with its plain version "
                                 f"(max abs err {err})")

    def signer(i: int) -> Ed25519Signer:
        return Ed25519Signer(hashlib.sha256(b"chip-smoke-did-%d" % i).digest())

    def nym_request(s: Ed25519Signer, req_id: int) -> Request:
        req = Request(identifier=s.identifier, req_id=req_id,
                      operation={"type": NYM, "dest": s.identifier,
                                 "verkey": s.verkey_b58})
        req.signature = s.sign_b58(req.signing_bytes())
        return req

    # --- the slice's requests (signed on the host, pure Python) -----------
    t0 = time.perf_counter()
    n_req = 1000
    signers = [signer(i) for i in range(n_req)]
    reqs = [nym_request(s, i + 1) for i, s in enumerate(signers)]
    expect = np.ones(n_req, dtype=bool)
    bad = [int(i) for i in rng.choice(n_req, size=8, replace=False)]
    for k, i in enumerate(bad):
        r, s = reqs[i], signers[i]
        if k < 3:       # one bit of the signature flipped
            sig = bytearray(b58decode(r.signature))
            sig[int(rng.integers(64))] ^= 1 << int(rng.integers(8))
            r.signature = b58encode(bytes(sig))
        elif k < 5:     # operation changed after signing
            forged = Request(identifier=r.identifier, req_id=r.req_id,
                             operation={**r.operation, "role": "0"})
            forged.signature = r.signature
            reqs[i] = forged
        elif k < 7:     # signed by another key
            r.signature = signers[(i + 1) % n_req].sign_b58(r.signing_bytes())
        else:           # S >= L
            sig = b58decode(r.signature)
            r.signature = b58encode(sig[:32] + (ed.L + 7).to_bytes(32, "little"))
        expect[i] = False
    verkeys = {s.identifier: s.verkey_b58 for s in signers}
    sign_s = time.perf_counter() - t0

    # --- phase 1: every kernel vs its plain version, bit for bit ----------
    # K1: 1,024 NYM-txn leaves (0x00 || pack(txn)), one launch per block count
    leaves = [txn_to_leaf(new_txn(NYM, dict(r.operation), request=r))
              for r in reqs] + [txn_to_leaf(new_txn(NYM, {"dest": "x" * i}))
                                for i in range(1024 - n_req)]
    buckets: dict[int, list[bytes]] = {}
    for leaf in leaves:
        buckets.setdefault(sha.n_blocks_for(len(leaf) + 1), []).append(leaf)
    for nb, group in sorted(buckets.items()):
        words = np.stack([sha.pad_to_words(b"\x00" + m) for m in group])
        w = sha.to_tensor(words, dev)
        got = sha.sha256_words(w)
        bit_equal("sha256_words", got, sha.sha256_words_torch(w))
        if sha.digests_to_bytes(got) != [hashlib.sha256(b"\x00" + m).digest()
                                         for m in group]:
            raise AssertionError("sha256_words disagrees with hashlib")

    def k1_check(msgs: list, what: str) -> None:
        """One K1 launch over msgs (one block count), bit for bit against
        the plain version and hashlib."""
        w = sha.to_tensor(np.stack([sha.pad_to_words(m) for m in msgs]), dev)
        before = ops.LAUNCHES["sha256_words"]
        got = sha.sha256_words(w)
        if ops.LAUNCHES["sha256_words"] != before + 1:
            raise AssertionError(f"sha256_words {what}: not one launch")
        bit_equal("sha256_words", got, sha.sha256_words_torch(w))
        if sha.digests_to_bytes(got) != [hashlib.sha256(m).digest()
                                         for m in msgs]:
            raise AssertionError(f"sha256_words {what} disagrees with hashlib")

    # K1 at the batch's 992 leaves (the accepted requests' txns), and at
    # 1, 5 and 33 messages (a lone group, a partial warp, a tail block) of
    # 1-9 blocks (9: more than a group of 8 lanes expands in one turn)
    k1_check([b"\x00" + txn_to_leaf(new_txn(NYM, dict(r.operation), request=r))
              for r, ok in zip(reqs, expect) if ok], "at the batch's leaves")
    for n_e in (1, 5, 33):
        for nb in range(1, 10):
            lo, hi = max(64 * (nb - 1) - 8, 0), 64 * nb - 9
            k1_check([rng.bytes(int(rng.integers(lo, hi + 1)))
                      for _ in range(n_e)], f"at {n_e} x {nb} blocks")

    # K2: k_merkle_level on 1,024 pairs, and the wave at N = 2 ... 262,144
    # under five offset patterns: one k_merkle_wave launch up to 1,024
    # leaves, one k_merkle_wave_tiled launch beyond
    def rand_words(n):
        return torch.from_numpy(rng.integers(-2**31, 2**31, size=(n, 8),
                                             dtype=np.int64).astype(np.int32)).to(dev)
    left, right = rand_words(1024), rand_words(1024)
    bit_equal("sha256_interior", sha.hash_interior(left, right),
              sha.hash_interior_torch(left, right))
    bounds18 = rand_words(18)
    for n_w in (2, 4, 32, 512, 1024, 2048, 4096, 65536, 262144):
        depth = n_w.bit_length() - 1
        new_w = left if n_w == 1024 else rand_words(n_w)
        for pattern in ([0] * depth, [1] * depth, ([0, 1] * depth)[:depth],
                        ([1, 0] * depth)[:depth],
                        rng.integers(0, 2, depth).tolist()):
            offs = torch.tensor(pattern, dtype=torch.int32, device=dev)
            before = dict(ops.LAUNCHES)
            got = sha.merkle_wave(new_w, bounds18[:depth], offs)
            tiled = n_w > 2 * sha.WAVE_THREADS
            if tuple(ops.LAUNCHES[k_] - before[k_] for k_ in (
                    "merkle_wave", "merkle_wave_tiled", "sha256_interior")) \
                    != (int(not tiled), int(tiled), 0):
                raise AssertionError(f"merkle_wave at N = {n_w}: launches "
                                     f"off the plan {sha.wave_plan(n_w)}")
            want = sha.merkle_wave_torch(new_w, bounds18[:depth], offs)
            if len(got) != len(want):
                raise AssertionError(f"merkle_wave at N = {n_w}: levels")
            for g, w_ in zip(got, want):
                bit_equal("merkle_wave_tiled" if tiled else "merkle_wave",
                          g, w_)
    # K3: 1,024 keys, including y >= p, off-curve and (x = 0, sign = 1)
    key_signers = [signer(10_000 + i) for i in range(1016)]
    P = ed.P
    bad_keys = [(P + 1).to_bytes(32, "little"), (P + 5).to_bytes(32, "little"),
                (2).to_bytes(32, "little"), (5).to_bytes(32, "little"),
                (1 | (1 << 255)).to_bytes(32, "little"),
                ((P - 1) | (1 << 255)).to_bytes(32, "little"),
                b"\xff" * 32, bytes(32)]
    keys = [s.verkey for s in key_signers] + bad_keys
    keys_u8 = torch.from_numpy(np.frombuffer(b"".join(keys), np.uint8)
                               .reshape(-1, 32).copy()).to(dev)
    got3 = ed.decompress_kernel(keys_u8)
    want3 = ed.decompress_torch(keys_u8)
    for g, w_ in zip(got3, want3):
        bit_equal("ed25519_decompress", g, w_)
    host_valid = [ed.decompress(k) is not None for k in keys]
    if got3[2].cpu().tolist() != host_valid:
        raise AssertionError("ed25519_decompress validity != host decompress")
    # K4: 1,024 signatures over 256 keys (U < N), single-bit corruptions
    # of S, R, A and M
    items, want4 = [], []
    for i in range(1024):
        s = key_signers[i % 256]
        msg = b"chip smoke message %d" % i
        sig, vk = s.sign(msg), s.verkey
        kind = i % 8
        bit = 1 << int(rng.integers(8))
        if kind == 1:      # S
            b = bytearray(sig); b[32 + int(rng.integers(31))] ^= bit; sig = bytes(b)
        elif kind == 2:    # R
            b = bytearray(sig); b[int(rng.integers(32))] ^= bit; sig = bytes(b)
        elif kind == 3:    # A
            b = bytearray(vk); b[int(rng.integers(32))] ^= bit; vk = bytes(b)
        elif kind == 4:    # M
            b = bytearray(msg); b[int(rng.integers(len(b)))] ^= bit; msg = bytes(b)
        items.append((msg, sig, vk))
        want4.append(kind == 0 or kind >= 5)
    verifier = make_verifier("cuda")
    idxs4, staged4 = verifier.stage_bytes(items)
    s_u8, h_u8, k_u8, idx4, r_u8 = staged4
    _, tables4, valid4 = ed.decompress_kernel(k_u8)
    ok4 = ed.verify_tables(s_u8, h_u8, r_u8, idx4, tables4, valid4)
    bit_equal("ed25519_verify", ok4,
              ed.verify_tables_torch(s_u8, h_u8, r_u8, idx4, tables4, valid4))
    got4 = np.zeros(len(items), dtype=bool)
    got4[idxs4] = ok4.cpu().numpy()
    if got4.tolist() != want4:
        raise AssertionError("ed25519_verify verdicts differ from the expected")
    # K5: tables from the slice's keys as the limb dispatch stages them
    # (ext_quarters rows), and the same points as K3's from the key bytes
    collector = CoreAuthNr(verifier, verkeys.get)
    auth_items = []
    for r in reqs:
        auth_items.extend(collector.collect_items(r) or [])
    limb_v = make_verifier("cuda")
    limb_v._compressed_dispatch = False
    idxs5, staged5 = limb_v.stage_limbs(auth_items)
    sd5, hd5, aq5, ix5, ry5, rs5 = ed.stage_on(dev, *staged5)
    tables5 = ed.quarter_tables(aq5)
    bit_equal("ed25519_quarter_tables", tables5, ed.quarter_tables_torch(aq5))
    _, (_, _, keys5_u8, _, _) = verifier.stage_bytes(auth_items)
    _, tables3, valid3 = ed.decompress_kernel(keys5_u8)
    if keys5_u8.shape[0] != aq5.shape[0] or not bool(valid3.all()):
        raise AssertionError("limb and byte staging disagree on the keys")
    # affine equality mod p, cross-multiplied: X5 Z3 = X3 Z5, likewise Y
    # and 2dT (the two chains reach different projective Z)
    t5, t3 = tables5.long(), tables3.long()
    for c in (0, 1, 3):
        if not torch.equal(
                ed.fe_canon(ed.fe_mul(t5[..., c, :], t3[..., 2, :])),
                ed.fe_canon(ed.fe_mul(t3[..., c, :], t5[..., 2, :]))):
            raise AssertionError("K5's tables hold other points than K3's")
    del t5, t3
    # K6: the slice's batch staged by the limb dispatch
    ok6 = ed.verify_staged(sd5, hd5, ry5, rs5, ix5, tables5)
    bit_equal("ed25519_verify_staged", ok6,
              ed.verify_staged_torch(sd5, hd5, ry5, rs5, ix5, tables5))
    got6 = np.zeros(len(auth_items), dtype=bool)
    got6[idxs5] = ok6.cpu().numpy()
    if got6.tolist() != expect.tolist():
        raise AssertionError("ed25519_verify_staged verdicts differ from the "
                             "expected ones")
    # K3-K6 at edge sizes (one quad per item: a lone quad, a partial warp,
    # a tail past a full block), invalid keys and out-of-range indices
    # included
    edge_keys = [k_ for pair in zip(keys, bad_keys) for k_ in pair] + keys[8:]

    def edge_items(n: int) -> list:
        out = []
        for i in range(n):
            s = key_signers[i % max(1, (n + 2) // 3)]      # fewer keys than sigs
            msg = b"edge %d %d" % (n, i)
            sig = s.sign(msg)
            if i % 4 == 1:
                b = bytearray(sig); b[40] ^= 4; sig = bytes(b)
            out.append((msg, sig, s.verkey))
        return out

    for n_e in (1, 5, 33):
        k_e = torch.from_numpy(np.frombuffer(b"".join(edge_keys[:n_e]), np.uint8)
                               .reshape(-1, 32).copy()).to(dev)
        for g, w_ in zip(ed.decompress_kernel(k_e), ed.decompress_torch(k_e)):
            bit_equal("ed25519_decompress", g, w_)
        aq_e = aq5[:n_e].clone()
        aq_e[-1] = torch.from_numpy(rng.integers(-2, 8196, size=aq_e[-1].shape)
                                    .astype(np.int32)).to(dev)   # no point
        bit_equal("ed25519_quarter_tables", ed.quarter_tables(aq_e),
                  ed.quarter_tables_torch(aq_e))
        items_e = edge_items(n_e)
        _, st_e = limb_v.stage_limbs(items_e)      # K6: exactly n_e sigs
        if n_e > 3:
            items_e[3] = items_e[3][:2] + (bad_keys[1],)       # y >= p
        want_e = [ed.pure_python_verify(*it) for it in items_e]
        _, (s_e, h_e, kk_e, ix_e, r_e) = verifier.stage_bytes(items_e)
        _, tab_e, val_e = ed.decompress_kernel(kk_e)
        ok_e = ed.verify_tables(s_e, h_e, r_e, ix_e, tab_e, val_e)
        bit_equal("ed25519_verify", ok_e, ed.verify_tables_torch(
            s_e, h_e, r_e, ix_e, tab_e, val_e))
        if ok_e.cpu().tolist() != want_e:
            raise AssertionError(f"ed25519_verify at N = {n_e}: verdicts "
                                 f"differ from the expected ones")
        sd_e, hd_e, aqu_e, ixl_e, ry_e, rs_e = ed.stage_on(dev, *st_e)
        tab6_e = ed.quarter_tables(aqu_e)
        bit_equal("ed25519_quarter_tables", tab6_e,
                  ed.quarter_tables_torch(aqu_e))
        if n_e > 3:       # a signature whose key row is outside the table
            ixl_e[-1] = aqu_e.shape[0]
            ix_e[-1] = kk_e.shape[0]
            oor = ed.verify_tables(s_e, h_e, r_e, ix_e, tab_e, val_e).cpu()
            if oor[-1] or oor[:-1].tolist() != want_e[:-1]:
                raise AssertionError("ed25519_verify: a key index outside "
                                     "the table must give False alone")
        bit_equal("ed25519_verify_staged",
                  ed.verify_staged(sd_e, hd_e, ry_e, rs_e, ixl_e, tab6_e),
                  ed.verify_staged_torch(sd_e, hd_e, ry_e, rs_e, ixl_e, tab6_e))
    # K7: one launch at N = 2 and 512 (one block); two at 1,024, 65,536
    # and 262,144 (2, 128 and 512 blocks, then one over their roots)
    for n_leaves in (2, 512, 1024, 65536, 262144):
        w = rand_words(n_leaves)
        before = ops.LAUNCHES["merkle_reduce"]
        got = sha.merkle_reduce_pow2(w)
        if ops.LAUNCHES["merkle_reduce"] - before != 1 + (n_leaves > 512):
            raise AssertionError(f"merkle_reduce at N = {n_leaves}: "
                                 f"launches off the plan")
        bit_equal("merkle_reduce", got, sha.merkle_reduce_pow2_torch(w))
    # the tiled wave's arrival counter on this stream: waves at
    # alternating sizes queued back to back, each held to its plain
    # version only after all of them were launched
    queued = []
    for n_leaves in (65536, 2048, 262144, 1024, 65536):
        depth = n_leaves.bit_length() - 1
        w = rand_words(n_leaves)
        offs = torch.from_numpy(
            rng.integers(0, 2, depth).astype(np.int32)).to(dev)
        queued.append((w, offs,
                       sha.merkle_wave_flat(w, bounds18[:depth], offs)))
    for w, offs, flat in queued:
        bit_equal("merkle_wave_tiled" if w.shape[0] > 2 * sha.WAVE_THREADS
                  else "merkle_wave", flat, torch.cat(sha.merkle_wave_torch(
                      w, bounds18[:offs.shape[0]], offs)))
    # K8: the probe's shape, N = 2,048 columns, k = 64
    chain_vals = [int.from_bytes(rng.bytes(32), "little") % ed.P
                  for _ in range(2048)]
    chain_x = torch.from_numpy(np.ascontiguousarray(np.stack(
        [ed.int_to_limbs(v) for v in chain_vals]).T)).to(dev)
    bit_equal("field_chain", field_chain(chain_x, 64),
              field_chain_torch(chain_x, 64))
    torch.cuda.synchronize()
    phase1_s = time.perf_counter() - t0 - sign_s

    # --- the ledger's state: 100,003 txns, built on the host ---------------
    t0 = time.perf_counter()
    n_pre = 100_003
    pre_leaves = [pack(new_txn(NYM, {"dest": "did:%d" % i, "role": "2"}))
                  for i in range(n_pre)]
    base = CompactMerkleTree(TreeHasher(), HashStore())
    base.extend_batch(pre_leaves)
    txn_rows = [(i.to_bytes(8, "big"), leaf)
                for i, leaf in enumerate(pre_leaves, start=1)]
    hash_rows = list(base.hash_store.kv.iterator())
    domain = ledger_from_rows(txn_rows, hash_rows,
                              make_tree_hasher("cuda", min_batch=512,
                                               fuse_min=512))
    reference = ledger_from_rows(txn_rows, hash_rows, TreeHasher())
    if domain.root_hash != base.root_hash or domain.size != n_pre:
        raise AssertionError("carried-over ledger lost its root")
    prefill_s = time.perf_counter() - t0

    # --- phase 2: the slice, end to end -----------------------------------
    ops.reset_counts()
    torch.cuda.synchronize()
    t_main = time.perf_counter()
    authnr = ReqAuthenticator()
    authnr.register_authenticator(
        CoreAuthNr(verifier=make_verifier("cuda"), get_verkey=verkeys.get))
    verdicts = authnr.authenticate_batch(reqs)
    t_auth = time.perf_counter()
    if verdicts.tolist() != expect.tolist():
        raise AssertionError("authenticate_batch verdicts differ from the "
                             "expected ones")
    txns = [new_txn(NYM, dict(r.operation), request=r)
            for r, ok in zip(reqs, verdicts) if ok]
    old_root = domain.root_hash
    root_u, size_u = domain.append_txns_to_uncommitted(txns)
    if domain.uncommitted_root_hash != root_u:
        raise AssertionError("uncommitted root unstable")
    _, infos = domain.commit_txns(len(txns))
    t_commit = time.perf_counter()
    batch_counts = dict(ops.LAUNCHES)
    reference.append_batch(txns)
    if not (domain.root_hash == root_u == reference.root_hash
            and size_u == domain.size == n_pre + len(txns)):
        raise AssertionError("committed root differs from the hashlib ledger's")
    verifier_m = MerkleVerifier()
    k = len(txns) // 2
    path = [bytes.fromhex(h) for h in infos[k]["auditPath"]]
    if not verifier_m.verify_inclusion(txn_to_leaf(txns[k]), n_pre + k,
                                       domain.size, path, domain.root_hash):
        raise AssertionError("inclusion proof does not verify")
    cons = [bytes.fromhex(h) for h in domain.consistency_proof(n_pre)]
    if not verifier_m.verify_consistency(n_pre, domain.size, old_root,
                                         domain.root_hash, cons):
        raise AssertionError("consistency proof does not verify")
    # catchup-scale append at default thresholds, same ledger state
    catchup = Ledger(tree=CompactMerkleTree(make_tree_hasher("cuda"),
                                            domain.tree.hash_store),
                     txn_log=domain.txn_log)
    bulk = [new_txn(NYM, {"dest": "bulk:%d" % i, "role": "2"})
            for i in range(65_536)]
    t_bulk = time.perf_counter()
    catchup.append_batch(bulk)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    # 4,096 txns more on a hasher that declines the fused wave: the
    # per-level route, hash_children_batch on each level of at least
    # min_batch pairs (2,048, then 1,024: two k_merkle_level launches)
    per_level = Ledger(
        tree=CompactMerkleTree(make_tree_hasher("cuda", min_batch=1024,
                                                fuse_min=1 << 30),
                               catchup.tree.hash_store),
        txn_log=catchup.txn_log)
    more = [new_txn(NYM, {"dest": "level:%d" % i, "role": "2"})
            for i in range(4096)]
    t_level = time.perf_counter()
    per_level.append_batch(more)
    torch.cuda.synchronize()
    t_level_end = time.perf_counter()
    main_counts = dict(ops.LAUNCHES)
    reference.append_batch(bulk)
    if catchup.root_hash != reference.root_hash:
        raise AssertionError("65,536-append root differs from the hashlib "
                             "ledger's")
    reference.append_batch(more)
    if per_level.root_hash != reference.root_hash:
        raise AssertionError("per-level 4,096-append root differs from the "
                             "hashlib ledger's")
    require_launched("slice", main_counts,
                     ("sha256_words", "merkle_wave", "merkle_wave_tiled",
                      "sha256_interior", "ed25519_decompress",
                      "ed25519_verify"))
    # each batch wave (staged, then committed) is one k_merkle_wave launch;
    # the 65,536-txn wave one k_merkle_wave_tiled launch; the per-level
    # append one K1 and two k_merkle_level launches
    sha_counts = {k_: (batch_counts[k_], main_counts[k_])
                  for k_ in ("sha256_words", "merkle_wave",
                             "merkle_wave_tiled", "sha256_interior")}
    if sha_counts != {"sha256_words": (2, 4), "merkle_wave": (2, 2),
                      "merkle_wave_tiled": (0, 1),
                      "sha256_interior": (0, 2)}:
        raise AssertionError(f"SHA-256 launches (per batch, on the path) "
                             f"off the plan: {sha_counts}")
    print(json.dumps({"slice": {
        "requests": n_req, "accepted": int(verdicts.sum()),
        "ledger_size_before": n_pre, "ledger_size_after": catchup.size,
        "authenticate_s": t_auth - t_main,
        "stage_root_commit_s": t_commit - t_auth,
        "append_65536_s": t_end - t_bulk,
        "append_4096_per_level_s": t_level_end - t_level,
        "launches_per_1000_txn_batch": batch_counts,
        "launches_main_path": main_counts,
        "sign_s": sign_s, "phase1_s": phase1_s, "prefill_s": prefill_s}}))

    # --- path B: the sharded crypto plane ---------------------------------
    def hashlib_root(digests: list) -> bytes:
        while len(digests) > 1:
            digests = [hashlib.sha256(b"\x01" + digests[i] + digests[i + 1])
                       .digest() for i in range(0, len(digests), 2)]
        return digests[0]

    def sync_s(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    ops.reset_counts()
    torch.cuda.synchronize()
    t_sharded = time.perf_counter()
    sharded = make_verifier("cuda-sharded")
    authnr_s = ReqAuthenticator()
    authnr_s.register_authenticator(
        CoreAuthNr(verifier=sharded, get_verkey=verkeys.get))
    auth_s = {}
    for run, compressed in (("bytes", True), ("limbs_cold", False),
                            ("limbs_warm", False)):
        sharded._compressed_dispatch = compressed
        got, auth_s[run] = sync_s(lambda: authnr_s.authenticate_batch(reqs))
        if got.tolist() != expect.tolist():
            raise AssertionError(f"cuda-sharded {run} verdicts differ from "
                                 f"the expected ones")
    if sharded.dispatches != 3 or len(sharded._pt_cache) != n_req:
        raise AssertionError("cuda-sharded: dispatches or key cache off")
    # the plane at grid [2, 1,024] over a 4-shard roster on this card
    roster = lane_roster(4)
    plane = ShardedCryptoPlane(make_mesh(4, roster))
    pad_v = ShardedTorchEd25519Verifier(plane, min_batch=1024)
    leaf_digests = [hashlib.sha256(b"\x00" + m).digest() for m in leaves]
    want_root = hashlib_root(leaf_digests)
    plane_leaves = sha.to_tensor(sha.bytes_to_digests(leaf_digests), dev)
    idxs_pb, staged_pb = pad_v.stage_bytes(auth_items)
    s_g, h_g, k_g, ix_g, r_g = staged_pb
    args_pb = (torch.stack([s_g, s_g]), torch.stack([h_g, h_g]), k_g,
               torch.stack([ix_g, ix_g]), torch.stack([r_g, r_g]),
               plane_leaves)
    idxs_pl, staged_pl = pad_v.stage_limbs(auth_items)
    sd_g, hd_g, aq_g, ixl_g, ry_g, rs_g = ed.stage_on(dev, *staged_pl)
    args_pl = (torch.stack([sd_g, sd_g], dim=1),
               torch.stack([hd_g, hd_g], dim=2), aq_g,
               torch.stack([ixl_g, ixl_g]), torch.stack([ry_g, ry_g]),
               torch.stack([rs_g, rs_g]), plane_leaves)
    plane_out = {}
    for step, idxs_g, args in (("step_bytes", idxs_pb, args_pb),
                               ("step", idxs_pl, args_pl)):
        (ok_g, root_g, n_ok_g), plane_s = sync_s(
            lambda: getattr(plane, step)(*args))
        if tuple(ok_g.shape) != (2, 1024):
            raise AssertionError(f"{step}: ok shape {list(ok_g.shape)}")
        for inst in range(2):
            got = np.zeros(n_req, dtype=bool)
            got[idxs_g] = ok_g[inst, :len(idxs_g)].cpu().numpy()
            if got.tolist() != expect.tolist():
                raise AssertionError(f"{step}: instance {inst} verdicts "
                                     f"differ from the expected ones")
        if sha.digests_to_bytes(root_g[None]) != [want_root]:
            raise AssertionError(f"{step}: root differs from hashlib's")
        if int(n_ok_g) != int(ok_g.sum()):
            raise AssertionError(f"{step}: n_ok is not the verdict count")
        plane_out[step] = {"lanes_staged": len(idxs_g),
                           "n_ok": int(n_ok_g), "first_call_s": plane_s}
    graft_entry.dryrun_multichip(4)
    torch.cuda.synchronize()
    t_sharded_end = time.perf_counter()
    sharded_counts = dict(ops.LAUNCHES)
    require_launched("sharded", sharded_counts,
                     ("ed25519_decompress", "ed25519_verify",
                      "ed25519_quarter_tables", "ed25519_verify_staged",
                      "merkle_reduce"))
    print(json.dumps({"sharded_path": {
        "roster": [str(d) for d in roster], "mesh": plane.mesh.shape,
        "cuda_sharded_mesh": sharded._plane.mesh.shape,
        "authenticate_s": auth_s, "plane": plane_out,
        "path_s": t_sharded_end - t_sharded,
        "launches": sharded_counts}}))

    # --- path C: the field-chain probe (its own microbench entry) ---------
    ops.reset_counts()
    torch.cuda.synchronize()
    chain_out = field_chain(chain_x, 64)
    torch.cuda.synchronize()
    probe_counts = dict(ops.LAUNCHES)
    require_launched("probe", probe_counts, ("field_chain",))
    chain_host = chain_out.cpu().numpy()
    for j in range(4):
        if ed.limbs_to_int(chain_host[:, j]) != pow(chain_vals[j], 2**64, ed.P):
            raise AssertionError("field_chain disagrees with Python's pow")

    # --- phase 3: times at the slice's shapes ------------------------------
    # the 1,000-request batch's own inputs
    _, (s_u8, h_u8, k_u8, idx_m, r_u8) = verifier.stage_bytes(auth_items)
    _, tables_m, valid_m = ed.decompress_kernel(k_u8)
    batch_leaves = [b"\x00" + txn_to_leaf(t) for t in txns]
    word_groups: dict[int, list[bytes]] = {}
    for leaf in batch_leaves:
        word_groups.setdefault(sha.n_blocks_for(len(leaf)), []).append(leaf)
    k1_inputs = [sha.to_tensor(np.stack([sha.pad_to_words(m) for m in g]), dev)
                 for g in word_groups.values()]
    wave0 = sha.to_tensor(sha.bytes_to_digests(
        [hashlib.sha256(m).digest() for m in batch_leaves]
        + [bytes(32)] * (1024 - len(batch_leaves))), dev)
    wave_bounds = rand_words(16)
    wave_offs = torch.tensor([1, 0, 1, 1, 0, 0, 1, 0, 1, 0, 1, 1, 0, 1, 0, 0],
                             dtype=torch.int32, device=dev)
    wave_64k = rand_words(65536)     # the catchup append's wave width

    max_clock = _smi("clocks.max.sm")
    sm_mhz = float(max_clock.split()[0]) if max_clock else 1980.0
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    per_pipe_per_s = n_sm * 64 * sm_mhz * 1e6     # ALU or FMA pipe, all SMs
    issue_per_s = 2 * per_pipe_per_s              # 4 x 32 lanes per clk/SM
    hbm_bytes_per_s = 3.35e12
    # SHA-256: thread-instructions per pipe, counted from the SASS. K1 per
    # 64-byte block: one pass of its turn loop (the group's load, one
    # lane's expansion of one block and, counted once, the round loop's
    # body); K2 and K7 per parent: k_merkle_level, which has no loop
    sass_k1 = sass_profile(lib_paths["sha256"], "k_sha256_words")
    sass_k2 = sass_profile(lib_paths["sha256"], "k_merkle_level")
    if sass_k2["body"]["all"] or not sass_k1["body"]["all"]:
        raise AssertionError("SHA-256 SASS: want a loop (the blocks) in "
                             "k_sha256_words and none in k_merkle_level")
    # Ed25519: only the 32x32->64 multiplies (IMAD.WIDE, two FMA-pipe
    # slots each) are counted; adds and carries are left out, so the
    # bound errs low
    mul = {"sq": 55, "mul": 100}
    dbl = 4 * mul["sq"] + 4 * mul["mul"]
    add_t2d, add_full, madd = 8 * mul["mul"], 9 * mul["mul"], 7 * mul["mul"]
    inv = 254 * mul["sq"] + 11 * mul["mul"]
    pow58 = 251 * mul["sq"] + 11 * mul["mul"]
    verify_muls = 64 * dbl + 64 * add_t2d + 32 * madd + inv + 2 * mul["mul"]
    table_muls = 4 * (7 * (dbl + add_full) + 16 * mul["mul"])
    decomp_muls = pow58 + 4 * mul["sq"] + 8 * mul["mul"] + 192 * dbl \
        + table_muls

    def insns(prof: dict, groups) -> dict:
        """Thread-instructions per pipe of (items, loop passes) groups."""
        tot = {"alu": 0, "fma": 0, "all": 0}
        for n_items, passes in groups:
            for p in tot:
                tot[p] += n_items * (prof["rest"][p] + passes * prof["body"][p])
        return tot

    def op_time(tot: dict) -> float:
        return max(tot["alu"] / per_pipe_per_s, tot["fma"] / per_pipe_per_s,
                   tot["all"] / issue_per_s)

    def bound(bytes_moved: float, op_s: float) -> tuple[float, str]:
        t_b = bytes_moved / hbm_bytes_per_s
        return (max(t_b, op_s) * 1e3, "bytes" if t_b > op_s else "operations")

    n_blocks_k1 = sum(t.shape[0] * t.shape[1] // 16 for t in k1_inputs)
    k1_insns = insns(sass_k1, [(t.shape[0], t.shape[1] // 16)
                               for t in k1_inputs])
    k2_insns = insns(sass_k2, [(1024 >> (lv + 1), 0) for lv in range(10)])
    n_sigs, n_keys = s_u8.shape[0], k_u8.shape[0]
    key_table_bytes = tables_m[0].numel() * 4           # one key's tables
    comb_bytes = ed.comb_table_device(dev).numel() * 4
    n_rows5, n_sigs6 = aq5.shape[0], sd5.shape[1]
    k7_insns = insns(sass_k2, [(1023, 0)])

    # the Ed25519 kernels' and K7's bounds over u keys / n signatures /
    # a number of leaves (each input read once, each output written once)
    def k3_bound(u):
        return bound(u * (32 + 640 + 1 + key_table_bytes),
                     2 * u * decomp_muls / per_pipe_per_s)

    def k4_bound(n, u):
        return bound(n * (3 * 32 + 4 + 1) + u * (key_table_bytes + 1)
                     + comb_bytes, 2 * n * verify_muls / per_pipe_per_s)

    def k5_bound(u):
        return bound(u * (4 * 4 * 20 * 4 + key_table_bytes),
                     2 * u * table_muls / per_pipe_per_s)

    def k6_bound(n, u):
        return bound(n * ((32 + 64 + 20 + 1 + 1) * 4 + 1)
                     + u * key_table_bytes + comb_bytes,
                     2 * n * verify_muls / per_pipe_per_s)

    def k7_bound(n_leaves):
        return bound(n_leaves * 32 + 32,
                     op_time(insns(sass_k2, [(n_leaves - 1, 0)])))

    def wave_bound(n_leaves):      # leaves, bounds and offs in, N - 1 out
        levels = n_leaves.bit_length() - 1
        return bound(n_leaves * 32 + levels * 36 + (n_leaves - 1) * 32,
                     op_time(insns(sass_k2, [(n_leaves - 1, 0)])))
    rows = [
        ("K1", "sha256_words", "plenum_tpu_torch/csrc/sha256.cu",
         "plenum_tpu/ops/sha256.py:87",
         lambda: [sha.sha256_words(t) for t in k1_inputs],
         lambda: [sha.sha256_words_torch(t) for t in k1_inputs],
         bound(sum(t.numel() * 4 + t.shape[0] * 32 for t in k1_inputs),
               op_time(k1_insns)),
         {"messages": len(batch_leaves), "blocks": n_blocks_k1,
          "launches_per_call": len(k1_inputs)}),
        ("K2", "merkle_wave", "plenum_tpu_torch/csrc/sha256.cu",
         "plenum_tpu/ops/sha256.py:142",
         lambda: sha.merkle_wave(wave0, wave_bounds[:10], wave_offs[:10]),
         lambda: sha.merkle_wave_torch(wave0, wave_bounds[:10],
                                       wave_offs[:10]),
         bound(1024 * 32 + 10 * 36 + 1023 * 32, op_time(k2_insns)),
         {"wave": 1024, "parents": 1023, "levels": 10,
          "launches_per_call": 1}),
        ("K2T", "merkle_wave_tiled", "plenum_tpu_torch/csrc/sha256.cu",
         "plenum_tpu/ops/sha256.py:142",
         lambda: sha.merkle_wave(wave_64k, wave_bounds, wave_offs),
         lambda: sha.merkle_wave_torch(wave_64k, wave_bounds, wave_offs),
         wave_bound(65536),
         {"wave": 65536, "parents": 65535, "levels": 16,
          "tiles": 65536 // 1024 + 1, "launches_per_call": 1}),
        ("K2L", "sha256_interior", "plenum_tpu_torch/csrc/sha256.cu",
         "plenum_tpu/ops/sha256.py:123",
         lambda: sha.hash_interior(left, right),
         lambda: sha.hash_interior_torch(left, right),
         bound(1024 * 64 + 1024 * 32, op_time(insns(sass_k2, [(1024, 0)]))),
         {"pairs": 1024, "parents": 1024, "levels": 1,
          "launches_per_call": 1}),
        ("K3", "ed25519_decompress", "plenum_tpu_torch/csrc/ed25519.cu",
         "plenum_tpu/ops/ed25519.py:521",
         lambda: ed.decompress_kernel(k_u8),
         lambda: ed.decompress_torch(k_u8),
         k3_bound(n_keys),
         {"keys": n_keys, "launches_per_call": 1}),
        ("K4", "ed25519_verify", "plenum_tpu_torch/csrc/ed25519.cu",
         "plenum_tpu/ops/ed25519.py:599",
         lambda: ed.verify_tables(s_u8, h_u8, r_u8, idx_m, tables_m, valid_m),
         lambda: ed.verify_tables_torch(s_u8, h_u8, r_u8, idx_m, tables_m,
                                        valid_m),
         k4_bound(n_sigs, n_keys),
         {"signatures": n_sigs, "keys": n_keys, "launches_per_call": 1}),
        ("K5", "ed25519_quarter_tables", "plenum_tpu_torch/csrc/ed25519.cu",
         "plenum_tpu/ops/ed25519.py:627",
         lambda: ed.quarter_tables(aq5),
         lambda: ed.quarter_tables_torch(aq5),
         k5_bound(n_rows5),
         {"key_rows": n_rows5, "launches_per_call": 1}),
        ("K6", "ed25519_verify_staged", "plenum_tpu_torch/csrc/ed25519.cu",
         "plenum_tpu/ops/ed25519.py:475",
         lambda: ed.verify_staged(sd5, hd5, ry5, rs5, ix5, tables5),
         lambda: ed.verify_staged_torch(sd5, hd5, ry5, rs5, ix5, tables5),
         k6_bound(n_sigs6, n_rows5),
         {"signatures": n_sigs6, "key_rows": n_rows5, "launches_per_call": 1}),
        ("K7", "merkle_reduce", "plenum_tpu_torch/csrc/sha256.cu",
         "plenum_tpu/ops/sha256.py:129",
         lambda: sha.merkle_reduce_pow2(plane_leaves),
         lambda: sha.merkle_reduce_pow2_torch(plane_leaves),
         k7_bound(1024),
         {"leaves": 1024, "parents": 1023, "levels": 10,
          "launches_per_call": 2}),
        ("K8", "field_chain", "plenum_tpu_torch/csrc/ed25519.cu",
         "probes/pallas_sqr_experiment.py:57",
         lambda: field_chain(chain_x, 64),
         lambda: field_chain_torch(chain_x, 64),
         bound(2 * chain_x.numel() * 4,
               2 * 2048 * 64 * mul["sq"] / per_pipe_per_s),
         {"columns": 2048, "k": 64, "launches_per_call": 1}),
    ]
    path_counts = {"slice": main_counts, "sharded": sharded_counts,
                   "probe": probe_counts}
    path_of = {"K1": "slice", "K2": "slice", "K2T": "slice", "K2L": "slice",
               "K3": "slice",
               "K4": "slice", "K5": "sharded", "K6": "sharded",
               "K7": "sharded", "K8": "probe"}
    # (threads per item, per block), fixed in csrc/sha256.cu and
    # ed25519.cu, but for K3-K6: a quad per item, block size swept
    fixed_geometry = {"sha256_words": (8, 128), "merkle_wave": (1, 512),
                      "merkle_wave_tiled": (1, 512),
                      "sha256_interior": (1, 128), "merkle_reduce": (1, 256),
                      "field_chain": (1, 128)}
    # the SHA-256 kernels' chain floor: one launch plus the chain of its
    # levels. Levels of at most 16 parents run in warp 0 alone, so a wave
    # (or a K7 reduce) over N = 2 ... 32 costs one parent's chain more per
    # level: floor = t(1 level) + (levels - 1) x the least-squares slope
    # of device time over 1-5 levels, each kernel its own (the tiled wave:
    # a tile's levels, then its top's, on the wave's sweep). K1: one
    # message of the batch's 6 blocks alone.
    def level_sweep(fn) -> dict:
        return {lv: device_ms(lambda lv=lv: fn(1 << lv)) for lv in range(1, 11)}

    def chain_floor(sweep: dict, levels: int):
        pts = [(lv, t) for lv, t in sweep.items() if lv <= 5]
        if any(isinstance(t, str) for _, t in pts):
            return "not measured: the profiler traced no kernel"
        slope = float(np.polyfit(*zip(*pts), 1)[0])
        return sweep[1] + (levels - 1) * slope

    wave_sweep = level_sweep(lambda n_: sha.merkle_wave(
        left[:n_], wave_bounds[:n_.bit_length() - 1],
        wave_offs[:n_.bit_length() - 1]))
    reduce_sweep = level_sweep(lambda n_: sha.merkle_reduce_pow2(left[:n_]))
    one_message = k1_inputs[0][:1].clone()
    chain_of = {"sha256_words": lambda levels: device_ms(
                    lambda: sha.sha256_words(one_message)),
                "merkle_wave": lambda levels: chain_floor(wave_sweep, levels),
                "merkle_wave_tiled": lambda levels: chain_floor(wave_sweep,
                                                                levels),
                "sha256_interior": lambda levels: device_ms(
                    lambda: sha.hash_interior(left[:1], right[:1])),
                "merkle_reduce": lambda levels: chain_floor(reduce_sweep,
                                                            levels)}
    tiled_sweep = {lv: device_ms(lambda lv=lv: sha.merkle_wave(
        wave_64k[:1 << lv], wave_bounds[:lv], wave_offs[:lv]))
        for lv in (11, 16)}
    print(json.dumps({"chain_floor_sweeps_device_ms_by_levels": {
        "merkle_wave": wave_sweep, "merkle_reduce": reduce_sweep,
        "merkle_wave_tiled": tiled_sweep}}))

    def same(a, b) -> bool:
        if isinstance(a, (tuple, list)):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        return torch.equal(a, b)

    kernels = []
    for kid, name, src, replaces, fn, plain, (b_ms, b_by), shape in rows:
        by_block = None
        if kid in ("K3", "K4", "K5", "K6"):
            per_item, per_block = ed.THREADS_PER_ITEM, ed.THREADS_PER_BLOCK
            want = fn()
            by_block = {}
            for tpb in (32, 64, 128):
                ed.THREADS_PER_BLOCK = tpb
                if not same(fn(), want):
                    raise AssertionError(f"{name}: another result at {tpb} "
                                         f"threads per block")
                by_block[tpb] = median_ms(fn, 20)
            ed.THREADS_PER_BLOCK = per_block
        else:
            per_item, per_block = fixed_geometry[name]
        sha_times = {}
        if name in chain_of:
            sha_times = {"device_ms": device_ms(fn), "chain_floor_ms":
                         chain_of[name](shape.get("levels", 1))}
        kernels.append({
            "id": kid, "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": path_counts[path_of[kid]][name],
            "max_abs_err": max_err[name],
            "ms": by_block[per_block] if by_block else median_ms(fn, 20),
            "plain_ms": median_ms(plain, 3, warm=1),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "threads_per_item": per_item, "threads_per_block": per_block,
            "ms_by_threads_per_block": by_block,
            "path": path_of[kid],
            "launches_by_path": {p_: c_[name] for p_, c_ in path_counts.items()},
            "launches_per_1000_txn_batch": batch_counts[name], "shape": shape,
            **sha_times})
    by_id = {k_["id"]: k_ for k_ in kernels}
    # the inversion's share of K4: 254 squarings in lock-step on each of
    # K4's 4 x N threads, timed as K8 over 4 N columns (one thread each)
    inv_x = chain_x.repeat(1, (4 * n_sigs + 2047) // 2048)[:, :4 * n_sigs] \
        .contiguous()
    inv_ms = median_ms(lambda: field_chain(inv_x, 254), 20)
    print(json.dumps({"inversion_share": {
        "columns": 4 * n_sigs, "squarings": 254, "k8_ms": inv_ms,
        "k4_ms": by_id["K4"]["ms"], "share_of_k4": inv_ms / by_id["K4"]["ms"]}}))
    print(json.dumps({"bound_basis": {
        "alu_or_fma_pipe_per_s": per_pipe_per_s, "issue_per_s": issue_per_s,
        "sm_clock_mhz": sm_mhz, "clocks_max_sm": max_clock,
        "hbm_bytes_per_s": hbm_bytes_per_s,
        "k1_sass_per_block": sass_k1["body"],
        "k1_sass_per_message_besides": sass_k1["rest"],
        "k1_opcodes": sass_k1["opcodes"],
        "k2_sass_per_parent": sass_k2["rest"],
        "k2_opcodes": sass_k2["opcodes"],
        "k1_thread_insns": k1_insns, "k2_thread_insns": k2_insns,
        "verify_wide_muls_per_sig": verify_muls,
        "decompress_wide_muls_per_key": decomp_muls,
        "table_wide_muls_per_key_row": table_muls,
        "field_sq_wide_muls": mul["sq"],
        "k7_thread_insns": k7_insns,
        "wide_mul_fma_slots": 2}}))
    # B1 as one call (K3 then K4), the reference's verify_kernel_bytes
    b1_ms = median_ms(lambda: ed.verify_kernel_bytes(s_u8, h_u8, k_u8, idx_m,
                                                     r_u8), 20)
    b1_plain = median_ms(lambda: ed.verify_kernel_bytes_torch(
        s_u8, h_u8, k_u8, idx_m, r_u8), 3, warm=1)
    print(json.dumps({"verify_kernel_bytes": {
        "signatures": n_sigs, "keys": n_keys, "ms": b1_ms, "plain_ms": b1_plain,
        "bound_ms": by_id["K3"]["bound_ms"] + by_id["K4"]["bound_ms"]}}))
    # B3 as one call (K5 then K6), the reference's verify_kernel_indexed
    b3_ms = median_ms(lambda: ed.verify_kernel_indexed(sd5, hd5, aq5, ix5,
                                                       ry5, rs5), 20)
    b3_plain = median_ms(lambda: ed.verify_staged_torch(
        sd5, hd5, ry5, rs5, ix5, ed.quarter_tables_torch(aq5)), 3, warm=1)
    print(json.dumps({"verify_kernel_indexed": {
        "signatures": n_sigs6, "key_rows": n_rows5, "ms": b3_ms,
        "plain_ms": b3_plain,
        "bound_ms": by_id["K5"]["bound_ms"] + by_id["K6"]["bound_ms"]}}))
    # the wave as one k_merkle_level launch per level (the wave before
    # k_merkle_wave), beside k_merkle_wave
    def by_levels():
        flat = torch.empty((1023, 8), dtype=torch.int32, device=dev)
        rows = sha.wave_rows(1024)
        for level, (a, b) in enumerate(rows):
            sha._merkle_level(
                wave0 if level == 0 else flat[rows[level - 1][0]:a],
                wave_bounds[level], wave_offs[level:], flat[a:b])
        return flat
    if not torch.equal(by_levels(), sha.merkle_wave_flat(
            wave0, wave_bounds[:10], wave_offs[:10])):
        raise AssertionError("the wave by levels and by k_merkle_wave differ")
    print(json.dumps({"merkle_wave_by_levels": {
        "wave": 1024, "launches_per_call": 10,
        "ms": median_ms(by_levels, 20), "device_ms": device_ms(by_levels)}}))
    # K7 at 65,536 leaves (two launches: 128 blocks, then one over their
    # roots), and the tiled wave at 2,048 (one launch: 3 tiles, a 1-level
    # top)
    k7_64k = k7_bound(65536)
    print(json.dumps({"merkle_reduce_65536": {
        "ms": median_ms(lambda: sha.merkle_reduce_pow2(wave_64k), 20),
        "device_ms": device_ms(lambda: sha.merkle_reduce_pow2(wave_64k)),
        "plain_ms": median_ms(
            lambda: sha.merkle_reduce_pow2_torch(wave_64k), 3, warm=1),
        "bound_ms": k7_64k[0], "bound_by": k7_64k[1]}}))
    wave_2k = (wave_64k[:2048], wave_bounds[:11], wave_offs[:11])
    w2k_bound = wave_bound(2048)
    print(json.dumps({"merkle_wave_tiled_2048": {
        "ms": median_ms(lambda: sha.merkle_wave(*wave_2k), 20),
        "device_ms": tiled_sweep[11],
        "chain_floor_ms": chain_floor(wave_sweep, 11),
        "plain_ms": median_ms(lambda: sha.merkle_wave_torch(*wave_2k), 3,
                              warm=1),
        "bound_ms": w2k_bound[0], "bound_by": w2k_bound[1],
        "tiles": 3, "launches_per_call": 1}}))
    # B8: the plane's steps at grid [2, 1,024] on the 4-shard roster
    # its bound: the sum of its kernels' bounds; per shard K3 + K4 (or K5
    # + K6) over every staged key and its 2 x 1,024 / 4 signatures, and K7
    # over its leaves, then K7 over the 4 shard roots
    n_sh = plane.mesh.size
    sigs_sh, leaves_sh = 2 * 1024 // n_sh, plane_leaves.shape[0] // n_sh
    k7_sh = n_sh * k7_bound(leaves_sh)[0] + k7_bound(n_sh)[0]

    def plane_plain_ms(step: str, args) -> float:
        """The plane's step with each kernel's plain version in its place,
        on the same tensors on the card."""
        kernels = (ed.verify_kernel_bytes, ed.verify_kernel_indexed,
                   sha.merkle_reduce_pow2)
        ed.verify_kernel_bytes = ed.verify_kernel_bytes_torch
        ed.verify_kernel_indexed = lambda sd, hd, aq, ix, ry, rs: \
            ed.verify_staged_torch(sd, hd, ry, rs, ix,
                                   ed.quarter_tables_torch(aq))
        sha.merkle_reduce_pow2 = sha.merkle_reduce_pow2_torch
        before = dict(ops.LAUNCHES)
        try:
            ms = median_ms(lambda: getattr(plane, step)(*args), 3, warm=1)
        finally:
            (ed.verify_kernel_bytes, ed.verify_kernel_indexed,
             sha.merkle_reduce_pow2) = kernels
        if ops.LAUNCHES != before:     # a name bound before the swap
            raise AssertionError(f"plane {step} with the plain versions "
                                 f"still launched a kernel")
        return ms
    print(json.dumps({"plane_steps": {
        "grid": [2, 1024], "shards": n_sh, "leaves": 1024,
        "step_bytes_ms": median_ms(lambda: plane.step_bytes(*args_pb), 10),
        "step_ms": median_ms(lambda: plane.step(*args_pl), 10),
        "step_bytes_plain_ms": plane_plain_ms("step_bytes", args_pb),
        "step_plain_ms": plane_plain_ms("step", args_pl),
        "step_bytes_bound_ms": n_sh * (k3_bound(k_g.shape[0])[0] + k4_bound(
            sigs_sh, k_g.shape[0])[0]) + k7_sh,
        "step_bound_ms": n_sh * (k5_bound(aq_g.shape[0])[0] + k6_bound(
            sigs_sh, aq_g.shape[0])[0]) + k7_sh,
        "sharded_authenticate_s": auth_s}}))

    # --- where one batch's time goes: host vs device -----------------------
    # from the timings above: each kernel's per-launch time times its
    # launches in one 1,000-request batch (auth + stage + commit)
    batch_wall_ms = (t_commit - t_main) * 1e3
    device_est_ms = sum(k_["ms"] / k_["shape"]["launches_per_call"]
                        * k_["launches_per_1000_txn_batch"] for k_ in kernels)
    where = {"batch_wall_ms": batch_wall_ms,
             "authenticate_ms": (t_auth - t_main) * 1e3,
             "stage_root_commit_ms": (t_commit - t_auth) * 1e3,
             "device_ms_from_kernel_times": device_est_ms,
             "device_busy_share_from_kernel_times": device_est_ms / batch_wall_ms}
    # the same batch again under torch.profiler, on a fresh copy of the
    # ledger: measured device time (where the profiler cannot trace the
    # card, the line says so instead of failing the run)
    again = ledger_from_rows(txn_rows, hash_rows,
                             make_tree_hasher("cuda", min_batch=512,
                                              fuse_min=512))
    prof = None
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
    except (ImportError, RuntimeError) as exc:   # tracing unavailable
        prof = None
        where["profiler"] = f"not measured: {type(exc).__name__}: {exc}"
    t0 = time.perf_counter()
    verdicts_p = authnr.authenticate_batch(reqs)
    again.append_txns_to_uncommitted(txns)
    again.commit_txns(len(txns))
    torch.cuda.synchronize()
    where["repeat_wall_ms"] = (time.perf_counter() - t0) * 1e3
    events = None
    if prof is not None:
        try:
            prof.stop()
            events = prof.events()
        except RuntimeError as exc:
            where["profiler"] = f"not measured: {type(exc).__name__}: {exc}"
    if events is not None:
        by_kernel: dict[str, float] = {}
        for ev in events:
            if ev.device_type == DeviceType.CUDA:
                by_kernel[ev.name] = (by_kernel.get(ev.name, 0.0)
                                      + ev.time_range.elapsed_us() / 1e3)
        busy_ms = sum(by_kernel.values())
        where.update({"profiled_device_busy_ms": busy_ms,
                      "profiled_device_busy_share":
                          busy_ms / where["repeat_wall_ms"],
                      "profiled_device_ms_by_name": dict(sorted(
                          by_kernel.items(), key=lambda kv: -kv[1])[:12])})
    if verdicts_p.tolist() != expect.tolist():
        raise AssertionError("profiled batch: verdicts differ from the "
                             "expected ones")
    if again.root_hash != reference.tree.merkle_tree_hash(0, n_pre + len(txns)):
        raise AssertionError("profiled batch reached another root")
    print(json.dumps({"where_time_goes": where}))
    print(json.dumps({"total_s": time.perf_counter() - t_start}))
    print(json.dumps({"kernels": kernels}))
    print(_smi("name,power.limit"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(sha_device_times() if sys.argv[1:] == ["--sha-device-times"]
             else main())
