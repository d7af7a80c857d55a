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
     and one k_merkle_wave_tiled launch beyond, no k_sha256_interior; K7 at
     N = 2 ... 262,144 (one launch up to 512 leaves, two beyond); then
     the wave at alternating sizes queued back to back (a stale arrival
     counter would show as a wrong level); the interior hash at 1, 3,
     31, 33, 1,025 and 2,049 pairs, as two tensors and as a level's
     shifted pairing (offset 0 and 1), at every block size and both
     block-2 schedules, one launch a call, and one call traced as one
     kernel with no copy beside it; K8 at 1, 3, 31, 33, 1,025 and 2,049
     columns, k = 0, 1 and 254, on 1, 2 and 4 lanes a column at 32, 64
     and 128 threads a block;
  2. path A, slice 1, end to end: 1,000 signed NYM requests
     (Max3PCBatchSize) from 1,000 DIDs, 8 of them corrupted,
     authenticated through make_verifier("cuda"); the accepted requests'
     txns staged, rooted and committed on a domain ledger pre-filled to
     100,003 txns; then one catchup-scale append_batch of 65,536 txns at
     default thresholds (one k_merkle_wave_tiled launch), and one of
     4,096 txns on a hasher that declines the fused wave (its two widest
     levels one k_sha256_interior launch each). Roots must equal a hashlib
     ledger's fed the same txns, proofs must verify; each batch must take
     2 K1 and 2 k_merkle_wave launches and no other SHA-256 launch, the
     path 4 K1, 2 k_merkle_wave, 1 k_merkle_wave_tiled and 2
     k_sha256_interior;
  3. path B, the sharded crypto plane (slice 2): the same 1,000 requests
     through make_verifier("cuda-sharded") by the byte dispatch and by the
     limb dispatch (cold, then warm key cache); ShardedCryptoPlane over a
     4-shard roster wrapped onto the card at grid [2, 1,024] (the batch
     padded to 1,024 lanes, once per RBFT instance) with 1,024 leaf
     digests, by step_bytes and step; then graft_entry.dryrun_multichip(4).
     Verdicts must be exactly the expected ones and roots hashlib's;
  4. path C, the field-chain probe: x^(2^64) over 2,048 columns;
  5. path D, the device ring (slice 6): make_crypto_pipeline(
     Config(PIPELINE_SHA_MIN_BATCH=512), "cuda") shared by four co-hosted
     replicas, as the reference pool wires it: each replica's CoreAuthNr
     on pipe.verifier(), its domain ledger (100,003 txns) on
     pipe.tree_hasher(). After prewarm, one unmeasured batch and pin(),
     5 batches of 1,000 fresh requests (8 corrupted): every replica
     authenticates, stages its txns with deferred hashing, one
     CommitWave drains the four ledgers, every replica commits. Each
     batch must give the expected verdicts on every replica, roots equal
     to each other and to a hashlib ledger's, proofs that verify, one
     Ed25519 wave, at least 3,000 dedup hits, no unpinned shape, nothing
     routed off the card by the supervisor, and exactly K3 = K4 = 1, K1 =
     2 per SHA-256 block count of the leaves and 8 k_merkle_wave
     launches; then one batch (after its own warm-up) on "cuda-sharded".
     Per batch it prints the wall time, the device busy time
     (torch.profiler), launches, waves, dedup and pad share, beside
     slice 1's single-replica batch wall. The dummy lanes of the
     prewarm are held to False on K3 + K4 first;
  6. path E, the replica's execution layer (slice 7), wired as the
     reference pool wires it below the Node (tools/local_pool.build_pool,
     node.py's BLS): a genesis of four NODE txns with their BLS keys,
     the trustee and 100,000 NYMs (4 of them role-less DIDs with keys
     from known seeds), replayed once into one replica's stores and
     copied by convert.bootstrap_from_rows into four NodeBootstrap
     replicas on one make_crypto_pipeline(Config(
     PIPELINE_SHA_MIN_BATCH=512), "cuda", supervised=True), each with a
     BlsBftReplica on the ring's BLS lane, and a twin on "cpu" (hashlib,
     no ring). Fails unless native bn254 loaded. After prewarm, one
     unmeasured batch and pin(), 5 batches of 1,000 NYMs for fresh DIDs
     as run_load makes them (8 corrupted as in path A, 2 signed by
     role-less DIDs): every replica authenticates, apply_batch-es,
     certifies (the primary's pre-prepare, each replica's commit, all
     four commits processed, order) and commit_batch-es. Each batch
     fails unless every replica and the twin give 990 applied, 8
     rejected in authentication and 2 discarded, equal roots (state,
     txn, pool state, audit) and committed txns; the multi-signature
     verifies over the state root with a quorum; a GET_NYM for a DID of
     the batch proves against the committed root with a multi-signature
     that verifies; one Ed25519 wave, 0 unpinned shapes, 0 cmt host
     fallbacks, 8 completed commit waves (none degraded to the host),
     nothing routed off the card; and K3 = K4 = 1, K1 = 2 per SHA-256
     block count and 8 k_merkle_wave launches. Per batch it prints the
     wall time split into authenticate / apply / BLS / commit, the
     device busy time, launches, waves, dedup hits, BLS items and
     pairings, the twin's time, and one more batch under cProfile;
     beside them path D's ring batches and path A's batch;
  7. path F, the 4-node pool (slice 9): four Nodes on one SimNetwork
     and one QueueTimer ordering signed NYM writes through propagate,
     PRE-PREPARE/PREPARE/COMMIT, checkpoints and BLS multi-signatures,
     every client signature authenticated by K3 + K4 on the ring.
     F1: tools/local_pool.run_load(n_nodes=4, n_txns=300,
     backend="cuda"), the reference bench's own call, twice; F2:
     run_load(4, 4000, "cuda", window=1000), a full Max3PCBatchSize
     flood, twice; each run in turns with its "cpu" twin (the host
     crypto baseline) on the same host, the ratio of the median TPS
     printed; then each once more under torch.profiler (the device busy
     time, and the profiler's cost in TPS) and F2 once under cProfile.
     Each device run fails unless every txn was ordered, the ledgers
     agree, the backend state is "ok" with no fallback, deadline miss
     or device error, no shape went unpinned and K3 + K4 launched in
     the timed window (the counters are set to 0, and a profiler
     started, by the ring's pin(), which run_load calls after its
     warm-up). F3: tools/local_pool.build_pool's four Nodes on one
     supervised "cuda" ring, each started by convert.bootstrap_from_rows
     from path E's 100,001-txn domain; after run_load's warm-up (the two
     smallest buckets, the cmt ladder, one unmeasured batch, pin), 5
     batches of 1,000 NYMs made as path E makes them (8 corrupted, 2
     from role-less DIDs), each failing unless every node sent 990
     Replies, 2 Rejects and 8 NACKs, grew its domain ledger by 990, and
     the domain, pool and audit ledger roots and the domain and pool
     state roots are equal across the nodes, with K3 + K4 launched, no
     fallback and no unpinned shape. Prints TPS, latency, commit
     stages, the controller's trajectory, the ring's summary, launches
     per run, the profiled runs' device busy, and per F3 batch the time
     from submit to the last node's reply beside path E's batches;
  8. path G, the TCP pool (slice 10): tools/tcp_pool's four start_node
     OS processes over the authenticated TCP stack (X25519 + Ed25519
     handshake, ChaCha20-Poly1305 frames), driven by its pipelined
     client. G1, the tcpsvc topology: a CryptoPlaneServer in this
     process on make_verifier("cuda", supervised=True), the nodes on
     backend "service" through PLENUM_CRYPTO_SOCKET (none of them sees
     the card), run_tcp_pool(4, 600, "service", window=300) twice
     (three times until path I joined the script) in turns with its twin run_tcp_pool(4, 600, "service:cpu",
     window=300) (a service process on the host verifier), then once
     more under torch.profiler (the device busy time); each call in one
     spawned process, so its client shares no interpreter lock with the
     service's threads, as in the tcpsvc topology. Each G1 run fails
     unless every txn was ordered and every node's flushed metrics show
     it ordered with its supervisor's breaker closed and nothing routed
     to its fallback, K3 = K4 >= 1 launched in the run, the
     server dispatched with no worker-loop error, and the service's
     supervisor shows no fallback, hedge won by the CPU or device error;
     a twin run fails if it launched any kernel here. G2, the
     operator's entry point: run_tcp_pool(4, 600, "service:cuda",
     window=300), which spawns python -m
     plenum_tpu_torch.parallel.crypto_service --backend cuda; fails
     unless every txn was ordered, the service's stats show dispatches,
     no error and nothing off the card, and the backend state is "ok".
     G3: run_tcp_pool(4, 200, "cuda"), four CUDA contexts on the card,
     each node's verifier supervised; the same per-node checks. G4: an
     ObserverNode(crypto_backend="cuda") following four "cpu"
     start_node processes through 200 NYMs; fails unless its domain
     ledger and state equal every validator's (rebuilt from its stores
     after the run) and a GET_NYM read_proof from its client port
     verifies under the pool's BLS keys;
  9. path H, the scale-out rings (slice 11). Each pool run reads its
     ring through run_load's on_pin hook and fails unless every txn was
     ordered with the ledgers agreeing, no shape went unpinned, and
     every dispatch beyond one a signature repeats a signature that sat
     in a wave not yet resolved (the ring dedups only against its cache
     and within a wave: those repeats are counted, any other fails).
     H1, the multi-lane ring: run_load(4, 300, "cuda",
     config_overrides=dict(PIPELINE_DEVICES=4)) twice, in turns with its
     "cpu" twin: four lanes (each its own supervised verifier and
     breaker, its own worker thread) wrapped onto the card; each run
     fails unless the ring is a MultiDeviceCryptoPipeline of four CUDA
     lanes, every lane dispatched, every lane's supervisor routed
     nothing off the card, and K3 = K4 = the lanes' waves after pin(),
     at least one; one more run under torch.profiler gives the card's
     busy time, the time at least one kernel ran and their difference,
     the lanes' overlap; then path D's first batch through a four-lane
     ring on four replicas, its verdicts equal path D's. H2, the
     federated ring: python -m plenum_tpu_torch.parallel.crypto_service
     --backend cuda spawned as a rostered crypto host, run_load(4, 300,
     "cuda", config_overrides=dict(PIPELINE_REMOTE_HOSTS=<its socket>)):
     one lane on the card and one remote lane; fails unless one remote
     lane has a ship p95 above 0, both supervisors are clean and the
     service's stats show dispatches and nothing off the card. Then the
     kill rung: 200 items on a federated ring, the first 100 placed by
     the ring (alternating lanes) and dispatched, the host SIGKILLed
     under them, its breaker opened by direct batches to its supervisor
     (the reference's recipe), the rest placed around it; every verdict
     right, the items dispatched exactly once, device errors from the
     waves in flight, no remote wave after its breaker opened, only the
     remote breaker open; the host restarted on the same socket, and
     pumping the ring alone must close its breaker within its cooldown
     and 10 s. H3, multi-host on one rank: init_multihost on an nccl
     group of world size 1 (NCCL refuses two ranks on one GPU),
     global_mesh over four lanes wrapped onto the card, shard_host_batch
     of path B's host batch, ShardedCryptoPlane.step_bytes, which
     gathers the shard roots and sums the count over the group (NCCL
     all_gather and all_reduce): verdicts, root and count equal path
     B's; prints the build-cache report. H4, where a node process's
     host time goes: tools/perf_budget.run_budget(4, 300) (four
     start_node processes under cProfile on service:cuda) and
     tools/micro_costs.run(4, 300), each printed on a line of its own;
     measurements, failing only if the pool did not order every txn or
     wrote no profile;
 10. path I, shards, the autopilot and the card's tools (slice 12). I1:
     ShardedSimFabric(n_shards=2, nodes_per_shard=4) on a QueueTimer
     with pipeline=make_crypto_pipeline(Config(PIPELINE_DEVICES=2),
     "cuda", supervised=True): shard s pinned to lane s of a two-lane
     ring wrapped onto the card; after one write a shard, the ring's
     pad buckets, cmt ladder and pin(), 1,000 trustee-signed NYMs for
     distinct fresh DIDs (8 corrupted) through submit_write, then 60
     GET_NYM reads through fab.read_driver (half for DIDs the other
     shard owns), each verified by the composed check (ownership proof
     + the shard's multi-signature). Twice, in turns with its "cpu"
     twin (the same fabric, no ring), then once under torch.profiler
     (the card's busy share of the profiler's whole window, settling
     included). Each run fails unless every valid write was ordered on its owning
     shard and nowhere else, the corrupted ones NACKed, each shard's
     nodes agree on their domain, pool and audit roots, every read
     verified, no shape went unpinned, every lane's supervisor routed
     nothing off the card, and each lane dispatched after pin() with K3
     = K4 = the lanes' waves. I2: bench_configs.config10_shards(
     n_txns=120, backend="cuda"), the reference bench's single_8 /
     sharded_2x4 / sharded_4x2 A/B, failing unless every arm ordered
     all with no map-proof failure, every read served, in each of its
     ten passes (the warm-up and three of each arm), not only the
     medians it reports. I3: the fabric of I1 on a MockTimer with
     AUTOPILOT=True over a hand-built ring of two unthreaded lanes (the
     supervisors run on the sim clock), each a supervised
     FaultyVerifier (parallel/faults.py) over a card verifier; lane 0's
     device drops every wave until its breaker opens; fails unless the
     autopilot re-pins shard 0 onto lane 1 (a write of shard 0 then
     dispatched there), and, lane 0 healed, un-pins it citing the
     re-pin outside its cooldown, the control ledger audits clean
     (tools/control_audit) and lane 1's supervisor is clean. I4: one
     atomic cross-shard write (fab.cross_writes()) on a MockTimer fabric
     with no autopilot over a fresh ring from the factory, as in I1
     (supervised card lanes, inline: PIPELINE_LANE_THREADS=False, since
     the 2PC's steps advance sim time; the supervisors on the wall
     clock, where the card's waves land);
     fails unless it commits, both halves are applied, the prepare
     record carries the read and ownership proofs and the participant's
     check of them passes, no lane routed anything off the card, no
     shape went unpinned, and each lane dispatched with K3 = K4 = the
     lanes' waves. I5: tools/gpu_probe,
     tools/gpu_microbench (2,048 and 128 signatures with the negative
     control, K1 over 4,096 leaves) and tools/multichip --devices 4
     (four lanes on the card, in a subprocess), each on its own line;
     multichip fails the path if its first attempt failed (the tool
     re-runs it after a rebuild, which here could only hide a fault);
 11. times: per kernel, the median of CUDA-event-timed launches after
     warm-up, its plain version's time, and its bound on this card (K3-K6,
     one quad of four threads per item, at 32, 64 and 128 threads per
     block; the interior hash at 32, 64 and 128 threads a block with
     block 2's schedule expanded or from its table; K8 on 1, 2 and 4
     lanes a column at 32, 64 and 128; each result held to the
     default's, each setting's device time taken twice in turns; the
     plane's steps also with every kernel's plain version in its place);
     for the SHA-256 kernels and K8 also the device time that
     torch.profiler traces and the chain floor (the device time of one
     message, pair or column alone, K8's on each design; for K2 and K7
     one level's device time plus, per further level, the slope of
     device time over waves of 1-5 levels); the tiled wave at 2,048 and
     65,536 leaves; a wave as one k_sha256_interior launch per level;
     the inversion's share of K4 (and the same chain on K8's design);
     the plane's steps and the sharded batches.

Each path runs with the launch counters set to 0 just before it and read
just after; the run fails if a kernel of that path was never launched.
The card's verifiers are bare (a fault raises), but for the rings of
paths D, E, F, H and I and path G's service and card nodes, which are
supervised as the reference pool wires them: those paths fail if the
supervisor fell back to the CPU, hedged, or saw a device error (path I3
faults lane 0 on purpose, and holds only lane 1 to it). The first line
names the msgpack codec that ran (the C extension or the pure-Python
one).
Prints JSON lines (kernels, paths, device) and, last, one JSON object
{"ok": true, "device": {...}}. Exits non-zero, with no result line, when
there is no CUDA device or any phase fails. Imports nothing of JAX.

    python3 chip_smoke.py --device-times

only prints the device time and the CUDA-event time of the SHA-256
kernels and K8 of the package beside the script (K1, K2's wave at 1,024,
2,048 and 65,536 leaves, the interior hash of 1,024 pairs and of one,
K7 at 1,024 and 65,536, K8 over 2,048 columns and one column, k = 64,
and over 3,996 columns, k = 254) at the paths' shapes, through wrappers
every version of the port has: a copy of the script in another checkout
times that checkout's kernels, so two trees compare in one call.
"""
from __future__ import annotations

import cProfile
import hashlib
import importlib.util
import json
import os
import pstats
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


def kernels_traced(fn, tries: int = 3) -> list:
    """The names of what one call of fn ran on the card (kernels, copies
    and sets), in order, as torch.profiler traced it after one warm call;
    a trace with nothing in it is taken again, up to tries times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [ev.name for ev in sorted(
            prof.events(), key=lambda e: e.time_range.start)
            if ev.device_type == DeviceType.CUDA]
        if names:
            return names
    raise AssertionError("the profiler traced nothing on the card")


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


def device_times() -> int:
    """The --device-times mode (module docstring): two passes of each
    kernel's device time and of its event time (the median of 20 calls),
    ms per call, on inputs made from a seed."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import numpy as np

    from plenum_tpu_torch.ops import ed25519 as ed
    from plenum_tpu_torch.ops import sha256 as sha
    from plenum_tpu_torch.ops.field_chain import field_chain
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    cols = torch.from_numpy(np.ascontiguousarray(np.stack(
        [ed.int_to_limbs(int.from_bytes(rng.bytes(32), "little") % ed.P)
         for _ in range(3996)]).T)).to(dev)
    col1, cols2k = cols[:, :1].contiguous(), cols[:, :2048].contiguous()

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
             "k2_level_1_pair": lambda: sha.hash_interior(wave0[:1],
                                                          pairs[:1]),
             "k8_2048_columns_64": lambda: field_chain(cols2k, 64),
             "k8_1_column_64": lambda: field_chain(col1, 64),
             "k8_3996_columns_254": lambda: field_chain(cols, 254),
             "k7_1024": lambda: sha.merkle_reduce_pow2(wave0),
             "k7_65536": lambda: sha.merkle_reduce_pow2(leaves)}
    times = {k: [device_ms(fn) for _ in range(2)] for k, fn in cases.items()}
    events = {k: [median_ms(fn, 20) for _ in range(2)]
              for k, fn in cases.items()}
    print(json.dumps({"device_ms": times, "event_ms": events,
                      "tree": root, "gpu": _smi("name,power.limit")}))
    return 0


def host_profile(prof: cProfile.Profile) -> dict:
    """Where a profiled run's host time went: total time by source file
    (the package's files by their path in it) and the top functions."""
    by_fn = pstats.Stats(prof).stats
    by_file: dict[str, float] = {}
    for (path_, _, _), (_, _, tot, _, _) in by_fn.items():
        key = path_[path_.find("plenum_tpu_torch/"):] \
            if "plenum_tpu_torch/" in path_ else \
            "builtins" if path_ == "~" else path_.split("site-packages/")[-1]
        by_file[key] = by_file.get(key, 0.0) + tot * 1e3
    return {
        "profiled_ms": sum(by_file.values()),
        "tottime_ms_by_file": dict(sorted(by_file.items(),
                                          key=lambda kv: -kv[1])[:15]),
        "top_functions": [
            {"function": f"{os.path.basename(f_)}:{ln}:{name}",
             "calls": v[1], "tottime_ms": v[2] * 1e3,
             "cumtime_ms": v[3] * 1e3}
            for (f_, ln, name), v in sorted(by_fn.items(),
                                            key=lambda kv: -kv[1][2])[:20]]}


# the sizes of paths E, F, G and H (module docstring); a rehearsal on
# the CPU patches them smaller and F_BACKEND, G_BACKEND and H_BACKEND to
# "torch"
PREFILL = 100_000
F_BACKEND = "cuda"
F1_TXNS, F1_RUNS = 300, 2
F2_TXNS, F2_WINDOW, F2_RUNS = 4000, 1000, 2
F3_BATCHES, F3_REQUESTS = 5, 1000
G_BACKEND = "cuda"
G1_TXNS, G1_WINDOW, G1_RUNS = 600, 300, 2
G3_TXNS, G4_NYMS = 200, 200
H_BACKEND = "cuda"
H_LANES, H_TXNS, H1_RUNS = 4, 300, 2
H2_KILL_ITEMS, H2_PROBE_SLACK_S = 200, 10.0
H4_TXNS = 300


def replica_state(names, n_prefill: int, rng) -> dict:
    """The domain of paths E and F3 (module docstring): a genesis of the
    pool's NODE
    txns, the trustee and n_prefill NYMs (4 of them role-less DIDs with
    keys from known seeds), replayed once into one replica's stores
    (hashlib, no ring) -> the genesis, the trustee, the role-less
    signers, the replica's rows (convert.replica_rows) and the seconds
    each step took."""
    from plenum_tpu_torch import convert
    from plenum_tpu_torch.common.node_messages import DOMAIN_LEDGER_ID
    from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
    from plenum_tpu_torch.execution import txn as txn_lib
    from plenum_tpu_torch.execution.txn import NYM
    from plenum_tpu_torch.node.bootstrap import NodeBootstrap
    from plenum_tpu_torch.tools.local_pool import build_genesis
    from plenum_tpu_torch.utils.base58 import b58encode
    perf = time.perf_counter
    t0 = perf()
    genesis, trustee = build_genesis(names)
    idle = [Ed25519Signer(seed=(b"path-e-idle-%d" % k).ljust(32, b"\0"))
            for k in range(4)]
    raw = rng.bytes(32 * n_prefill)
    domain = list(genesis[DOMAIN_LEDGER_ID])
    for i in range(n_prefill - len(idle)):
        vk = raw[32 * i:32 * i + 32]
        domain.append(txn_lib.new_txn(NYM, {"dest": b58encode(vk[:16]),
                                            "verkey": b58encode(vk)}))
    for s in idle:
        domain.append(txn_lib.new_txn(NYM, {"dest": s.identifier,
                                            "verkey": s.verkey_b58}))
    for i, txn in enumerate(domain):
        txn_lib.set_seq_no(txn, i + 1)
    genesis[DOMAIN_LEDGER_ID] = domain
    genesis_s = perf() - t0
    t0 = perf()
    first = NodeBootstrap(names[0], genesis_txns=genesis,
                          crypto_backend="cpu").build()
    replay_s = perf() - t0
    return {"genesis": genesis, "trustee": trustee, "idle": idle,
            "rows": convert.replica_rows(first), "genesis_s": genesis_s,
            "replay_s": replay_s}


def nym_batches(trustee, idle, rng, n_req: int, first_user: int = 0):
    """The requests of paths E and F3, as run_load makes them ->
    batch_requests(first_id): n_req NYMs for fresh DIDs, n_req - 2 from
    the trustee, 8 of them corrupted as in path A, and 2 signed by
    role-less DIDs -> (requests, expected verdicts, the 2 role-less
    requests)."""
    from plenum_tpu_torch.common.request import Request
    from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
    from plenum_tpu_torch.execution.txn import NYM
    from plenum_tpu_torch.ops import ed25519 as ed
    from plenum_tpu_torch.utils.base58 import b58decode, b58encode
    next_user = [first_user]

    def batch_requests(first_id: int):
        reqs = []
        for i in range(n_req - 2):
            user = Ed25519Signer(
                seed=(b"lpu%d" % next_user[0]).ljust(32, b"\0")[:32])
            next_user[0] += 1
            req = Request(trustee.identifier, first_id + i,
                          {"type": NYM, "dest": user.identifier,
                           "verkey": user.verkey_b58})
            req.signature = trustee.sign_b58(req.signing_bytes())
            reqs.append((req, user))
        expect = [True] * (n_req - 2)
        bad = [int(i) for i in rng.choice(n_req - 2, size=8, replace=False)]
        for k, i in enumerate(bad):
            r, user = reqs[i]
            if k < 3:       # one bit of the signature flipped
                sig = bytearray(b58decode(r.signature))
                sig[int(rng.integers(64))] ^= 1 << int(rng.integers(8))
                r.signature = b58encode(bytes(sig))
            elif k < 5:     # operation changed after signing
                forged = Request(r.identifier, r.req_id,
                                 {**r.operation, "role": "0"})
                forged.signature = r.signature
                reqs[i] = (forged, user)
            elif k < 7:     # signed by another key
                r.signature = user.sign_b58(r.signing_bytes())
            else:           # S >= L
                sig = b58decode(r.signature)
                r.signature = b58encode(sig[:32]
                                        + (ed.L + 7).to_bytes(32, "little"))
            expect[i] = False
        reqs = [r for r, _ in reqs]
        roleless = []
        for j in range(2):
            author = idle[(first_id + j) % len(idle)]
            user = Ed25519Signer(
                seed=(b"lpu%d" % next_user[0]).ljust(32, b"\0")[:32])
            next_user[0] += 1
            req = Request(author.identifier, first_id + j,
                          {"type": NYM, "dest": user.identifier,
                           "verkey": user.verkey_b58})
            req.signature = author.sign_b58(req.signing_bytes())
            at = int(rng.integers(len(reqs) + 1))
            reqs.insert(at, req)
            expect.insert(at, True)
            roleless.append(req)
        return reqs, expect, roleless
    return batch_requests


def replica_path(state, batch_device, off_card_check) -> dict:
    """Path E, the replica's execution layer on the device ring (module
    docstring): four co-hosted replicas and a hashlib twin, copied from
    `state` (replica_state: four NODE txns with BLS keys, the trustee and
    PREFILL NYMs, four of them role-less DIDs with keys from known
    seeds), run 5 batches of 1,000 NYM requests through authenticate,
    apply, BLS and commit. Raises on any check that fails; -> the
    path's record. `batch_device(fn)` runs fn under the device
    profiler (-> result, wall ms, busy ms, ms by kernel);
    `off_card_check(what, verifier)` fails if the supervisor routed work
    off the card."""
    import numpy as np

    from plenum_tpu_torch import convert, ops
    from plenum_tpu_torch.common.node_messages import (DOMAIN_LEDGER_ID,
                                                       Commit, PrePrepare)
    from plenum_tpu_torch.common.quorums import Quorums
    from plenum_tpu_torch.common.request import Request
    from plenum_tpu_torch.common.serialization import pack, unpack
    from plenum_tpu_torch.config import Config
    from plenum_tpu_torch.consensus.bls_bft_replica import BlsBftReplica
    from plenum_tpu_torch.crypto.bn254 import PAIRING_STATS
    from plenum_tpu_torch.crypto.multi_signature import MultiSignature
    from plenum_tpu_torch.execution import ThreePcBatch
    from plenum_tpu_torch.execution import txn as txn_lib
    from plenum_tpu_torch.execution.txn import GET_NYM
    from plenum_tpu_torch.ledger.ledger import txn_to_leaf
    from plenum_tpu_torch.native import have_native_bn254
    from plenum_tpu_torch.ops import sha256 as sha
    from plenum_tpu_torch.parallel.commit_wave import CommitWave
    from plenum_tpu_torch.parallel.pipeline import make_crypto_pipeline
    from plenum_tpu_torch.state import rlp
    from plenum_tpu_torch.state.trie import Trie
    from plenum_tpu_torch.tools.local_pool import pool_bls_keys

    if not have_native_bn254():
        raise AssertionError("path E: the native bn254 library did not "
                             "build; pure-Python pairings would make every "
                             "host number of the path meaningless")
    n_prefill, n_req, n_batches = PREFILL, 1000, 5
    sha_min, bucket = 512, 1024       # path D's ring
    names = [f"Node{i + 1}" for i in range(4)]
    rng = np.random.default_rng(20261020)
    perf = time.perf_counter

    genesis, trustee, idle, rows = (state["genesis"], state["trustee"],
                                    state["idle"], state["rows"])
    t0 = perf()
    pipe = make_crypto_pipeline(Config(PIPELINE_SHA_MIN_BATCH=sha_min),
                                "cuda", supervised=True)
    comps = [convert.bootstrap_from_rows(n, rows, genesis_txns=genesis,
                                         pipeline=pipe).build()
             for n in names]
    twin = convert.bootstrap_from_rows("Twin", rows, genesis_txns=genesis,
                                       crypto_backend="cpu").build()
    copy_s = perf() - t0
    bls_keys = pool_bls_keys(names)
    blss = []
    for n, c in zip(names, comps):
        if c.bls_register.get_key_by_name(n) != bls_keys[n]:
            raise AssertionError(f"path E: {n}'s BLS key is not the pool "
                                 f"ledger's")
        blss.append(BlsBftReplica(
            node_name=n, bls_signer=c.bls_signer,
            bls_verifier=pipe.bls_verifier(), key_register=c.bls_register,
            bls_store=c.bls_store, quorums=Quorums(4)))
    roots0 = {c.db.get_state(DOMAIN_LEDGER_ID).committed_head_hash
              for c in comps + [twin]}
    sizes0 = {c.db.get_ledger(DOMAIN_LEDGER_ID).size for c in comps + [twin]}
    if len(roots0) != 1 or sizes0 != {n_prefill + 1}:
        raise AssertionError(f"path E: the replicas start apart: "
                             f"{len(roots0)} state roots, sizes {sizes0}")

    batch_requests = nym_batches(trustee, idle, rng, n_req)

    # --- one batch on the four replicas ---------------------------------
    wave_runs = [0]
    wave_run = CommitWave.run

    def counted_run(self):
        out = wave_run(self)
        wave_runs[0] += 1
        return out

    def pp_time_of(k: int) -> float:
        return 1_760_000_000.25 + 10 * k

    def replicas_batch(k: int, reqs, prev_root):
        """Authenticate, apply, BLS (the primary's pre-prepare, every
        replica's commit, each processing the four commits, order) and
        commit on the four replicas -> (what they answered, host ms per
        phase, pairings)."""
        pairings0 = PAIRING_STATS["pairings"]
        t = [perf()]
        verdicts = [c.authenticator.authenticate_batch(reqs) for c in comps]
        accepted = [r for r, ok in zip(reqs, verdicts[0]) if ok]
        t.append(perf())
        applied = [c.executor.apply_batch(
            DOMAIN_LEDGER_ID, accepted, pp_time_of(k), view_no=0,
            pp_seq_no=k, primaries=[names[0]]) for c in comps]
        t.append(perf())
        a = applied[0]
        params = blss[0].update_pre_prepare({}, prev_root or "")
        pp = PrePrepare(
            inst_id=0, view_no=0, pp_seq_no=k, pp_time=pp_time_of(k),
            req_idr=a.valid_digests, discarded=a.discarded,
            digest=hashlib.sha256("".join(a.valid_digests).encode())
            .hexdigest(), ledger_id=DOMAIN_LEDGER_ID,
            state_root=a.state_root, txn_root=a.txn_root,
            pool_state_root=a.pool_state_root,
            audit_txn_root=a.audit_txn_root,
            bls_multi_sig=params.get("bls_multi_sig"))
        pp_faults = [b.validate_pre_prepare(pp, names[0]) for b in blss[1:]]
        commits = [Commit(inst_id=0, view_no=0, pp_seq_no=k,
                          **b.update_commit({}, pp)) for b in blss]
        for b in blss:
            for n, cm in zip(names, commits):
                b.process_commit(cm, n)
        mss = [b.process_order((0, k), pp) for b in blss]
        t.append(perf())
        batch = ThreePcBatch(
            ledger_id=DOMAIN_LEDGER_ID, view_no=0, pp_seq_no=k,
            pp_time=pp_time_of(k), valid_digests=a.valid_digests,
            state_root=bytes.fromhex(a.state_root),
            txn_root=bytes.fromhex(a.txn_root),
            audit_txn_root=bytes.fromhex(a.audit_txn_root),
            primaries=(names[0],), node_reg=tuple(names))
        committed = [c.executor.commit_batch(batch) for c in comps]
        t.append(perf())
        phases = {ph: (b_ - a_) * 1e3 for ph, a_, b_ in zip(
            ("authenticate", "apply", "bls", "commit"), t, t[1:])}
        return ((verdicts, applied, pp, pp_faults, mss, committed, batch),
                phases, PAIRING_STATS["pairings"] - pairings0)

    def twin_batch(k: int, reqs):
        verdicts = twin.authenticator.authenticate_batch(reqs)
        accepted = [r for r, ok in zip(reqs, verdicts) if ok]
        a = twin.executor.apply_batch(DOMAIN_LEDGER_ID, accepted,
                                      pp_time_of(k), view_no=0, pp_seq_no=k,
                                      primaries=[names[0]])
        batch = ThreePcBatch(
            ledger_id=DOMAIN_LEDGER_ID, view_no=0, pp_seq_no=k,
            pp_time=pp_time_of(k), valid_digests=a.valid_digests,
            state_root=bytes.fromhex(a.state_root),
            txn_root=bytes.fromhex(a.txn_root),
            audit_txn_root=bytes.fromhex(a.audit_txn_root),
            primaries=(names[0],), node_reg=tuple(names))
        return verdicts, a, twin.executor.commit_batch(batch)

    def check(what: str, out, expect, roleless, twin_out, st0, waves0):
        """Every check of a batch (module docstring) -> the ring's stats
        over the batch."""
        verdicts, applied, pp, pp_faults, mss, committed, _ = out
        t_verdicts, t_applied, t_committed = twin_out
        for v in verdicts + [t_verdicts]:
            if [bool(x) for x in v] != expect:
                raise AssertionError(f"{what}: a replica's verdicts differ "
                                     f"from the expected ones")
        want_discarded = {r.digest for r in roleless}
        for a in applied + [t_applied]:
            if tuple(a)[:4] != tuple(applied[0])[:4]:
                raise AssertionError(f"{what}: the replicas' roots differ "
                                     f"(state, txn, pool state, audit)")
            if len(a.valid_digests) != n_req - 10 or \
                    set(a.discarded) != want_discarded:
                raise AssertionError(
                    f"{what}: {len(a.valid_digests)} applied and "
                    f"{len(a.discarded)} discarded, want {n_req - 10} and "
                    f"the 2 role-less requests")
        packed = {pack(c) for c in committed + [t_committed]}
        if len(packed) != 1 or len(committed[0]) != n_req - 10:
            raise AssertionError(f"{what}: the committed txns differ")
        a = applied[0]
        for c in comps + [twin]:
            st = c.db.get_state(DOMAIN_LEDGER_ID)
            if st.committed_head_hash.hex() != a.state_root or \
                    c.db.get_ledger(DOMAIN_LEDGER_ID).root_hash.hex() != \
                    a.txn_root:
                raise AssertionError(f"{what}: a committed root is not the "
                                     f"applied one")
        if any(f is not None for f in pp_faults):
            raise AssertionError(f"{what}: the pre-prepare's multi-"
                                 f"signature was refused: {pp_faults}")
        if any(ms is None for ms in mss) or \
                len({pack(ms.to_list()) for ms in mss}) != 1:
            raise AssertionError(f"{what}: no common multi-signature")
        ms = mss[0]
        if ms.value.state_root_hash != a.state_root or \
                not ms.verify(bls_keys) or \
                not Quorums(4).bls_signatures.is_reached(
                    len(ms.participants)):
            raise AssertionError(f"{what}: the multi-signature does not "
                                 f"verify over the state root")
        # GET_NYM for a DID the batch wrote, on every replica
        i = int(rng.integers(len(committed[0])))
        data = txn_lib.txn_data(committed[0][i])
        for c in comps:
            res = c.read_manager.get_result(Request(
                trustee.identifier, 10**9 + i,
                {"type": GET_NYM, "dest": data["dest"]}))
            sp = res["state_proof"]
            present, got = Trie.verify_proof(
                bytes.fromhex(sp["root_hash"]), data["dest"].encode(),
                rlp.decode(bytes.fromhex(sp["proof_nodes"])))
            if sp["root_hash"] != a.state_root or not present or \
                    unpack(got) != res["data"] or \
                    res["data"]["verkey"] != data["verkey"]:
                raise AssertionError(f"{what}: GET_NYM's state proof does "
                                     f"not verify")
            if not MultiSignature.from_list(
                    sp["multi_signature"]).verify(bls_keys):
                raise AssertionError(f"{what}: GET_NYM's multi-signature "
                                     f"does not verify")
        got = {k_: pipe.stats[k_] - st0[k_] for k_ in pipe.stats}
        if got["dispatches"] != 1 or pipe.stats["unpinned_shapes"] or \
                pipe.stats["cmt_host_fallbacks"]:
            raise AssertionError(
                f"{what}: {got['dispatches']} Ed25519 waves (want 1), "
                f"{pipe.stats['unpinned_shapes']} unpinned shapes, "
                f"{pipe.stats['cmt_host_fallbacks']} cmt host fallbacks")
        if wave_runs[0] - waves0 != 2 * len(comps):
            raise AssertionError(
                f"{what}: {wave_runs[0] - waves0} commit waves completed, "
                f"want {2 * len(comps)} (a wave degraded to the host)")
        off_card_check(what, pipe.verifier())
        return got

    CommitWave.run = counted_run
    try:
        prev = None
        if pipe.prewarm([bucket]) != [bucket]:
            raise AssertionError(f"path E: prewarm did not warm bucket "
                                 f"{bucket}")
        # one unmeasured batch notes the shapes the prewarm does not
        reqs, expect, roleless = batch_requests(1)
        st0, w0 = dict(pipe.stats), wave_runs[0]
        out, _, _ = replicas_batch(1, reqs, prev)
        check("path E warm-up", out, expect, roleless, twin_batch(1, reqs),
              st0, w0)
        prev = out[2].state_root
        pipe.pin()
        batches = []
        ops.reset_counts()
        for k in range(2, 2 + n_batches):
            reqs, expect, roleless = batch_requests(k * n_req)
            st0, w0 = dict(pipe.stats), wave_runs[0]
            counts0 = dict(ops.LAUNCHES)
            (out, phases, pairings), wall, busy, by_name = batch_device(
                lambda: replicas_batch(k, reqs, prev))
            counts = {k_: ops.LAUNCHES[k_] - counts0[k_]
                      for k_ in ops.LAUNCHES}
            t_tw = perf()
            twin_out = twin_batch(k, reqs)
            twin_ms = (perf() - t_tw) * 1e3
            got = check(f"path E batch {k}", out, expect, roleless, twin_out,
                        st0, w0)
            prev = out[2].state_root
            # K3 + K4 once for the four replicas' wave; K1 once per SHA-256
            # block count of the leaves for the first apply's leaf level
            # (the other three hit the cmt lane's cache) and once for the
            # first commit (the others hit the SHA lane's digest cache);
            # one k_merkle_wave per replica in its apply and one in its
            # commit; nothing else (state hashing is sha3 on the host)
            groups = len({sha.n_blocks_for(len(txn_to_leaf(t_)) + 1)
                          for t_ in out[5][0]})
            want = {k_: 0 for k_ in ops.LAUNCHES}
            want.update(ed25519_decompress=1, ed25519_verify=1,
                        sha256_words=2 * groups, merkle_wave=2 * len(comps))
            if counts != want:
                raise AssertionError(f"path E batch {k}: launches {counts}, "
                                     f"want {want}")
            batches.append({
                "wall_ms_4_replicas": wall, "host_ms_by_phase": phases,
                "twin_ms": twin_ms, "device_busy_ms": busy,
                "device_ms_by_name": by_name, "launches": counts,
                "ed_dispatches": got["dispatches"],
                "dedup_hits": got["dedup_hits"],
                "cache_hits": got["cache_hits"],
                "bls_items": got["bls_items"], "bls_unique": got["bls_unique"],
                "bls_batches": got["bls_batches"], "pairings": pairings,
                "cmt_items": got["cmt_items"], "cmt_unique": got["cmt_unique"],
                "sha_items": got["sha_items"], "sha_unique": got["sha_unique"],
                "applied": len(out[1][0].valid_digests),
                "discarded": len(out[1][0].discarded)})
        counts = dict(ops.LAUNCHES)
        # where an apply + commit batch's host time goes: one more batch
        # under cProfile (which slows every Python call: read shares)
        k = 2 + n_batches
        reqs, expect, roleless = batch_requests(k * n_req)
        st0, w0 = dict(pipe.stats), wave_runs[0]
        prof = cProfile.Profile()
        out, _, _ = prof.runcall(replicas_batch, k, reqs, prev)
        check("path E batch under cProfile", out, expect, roleless,
              twin_batch(k, reqs), st0, w0)
    finally:
        CommitWave.run = wave_run
    return {
        "replicas": len(comps), "requests_per_batch": n_req,
        "domain_txns_at_genesis": n_prefill + 1,
        "domain_txns_after": comps[0].db.get_ledger(DOMAIN_LEDGER_ID).size,
        "sha_min_batch": sha_min, "native_bn254": have_native_bn254(),
        "genesis_s": state["genesis_s"],
        "genesis_replay_one_replica_s": state["replay_s"],
        "copies_to_4_replicas_and_twin_s": copy_s,
        "batches": batches, "launches": counts,
        "host_profile_one_batch": host_profile(prof),
        "summary": pipe.summary()}


class DeviceWindow:
    """torch.profiler over the card from construction to stop() ->
    (device busy ms, device ms by name); the busy time is a string
    saying why where the profiler cannot trace the card. After stop(),
    `union_ms` is the time at least one device activity ran: busy ms
    less the time activities overlapped."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()

    def stop(self):
        import torch
        from torch.autograd import DeviceType
        torch.cuda.synchronize()
        self._prof.stop()
        names: dict[str, float] = {}
        spans = []
        for ev in self._prof.events():
            if ev.device_type == DeviceType.CUDA:
                names[ev.name] = (names.get(ev.name, 0.0)
                                  + ev.time_range.elapsed_us() / 1e3)
                spans.append((ev.time_range.start, ev.time_range.end))
        busy = sum(names.values()) if names else \
            "not measured: the profiler traced nothing"
        union_us, reach = 0.0, float("-inf")
        for start, end in sorted(spans):
            union_us += max(0.0, end - max(start, reach))
            reach = max(reach, end)
        self.union_ms = union_us / 1e3 if spans else busy
        return busy, names


def _require_launched_ed(what: str, counts: dict) -> None:
    if counts["ed25519_decompress"] < 1 or counts["ed25519_verify"] < 1:
        raise AssertionError(f"{what}: K3 + K4 were not launched in the "
                             f"timed window: {counts}")


def pool_runs(off_card_check, device_window) -> dict:
    """Paths F1 and F2 (module docstring): run_load on F_BACKEND through
    the entry point a user calls, in turns with its `cpu` twin on the
    same host, then once more under torch.profiler and (F2) once under
    cProfile. Each device run fails unless every requested txn was
    ordered, the ledgers agree, the ring's supervisor routed nothing off
    the card, no shape went unpinned and K3 + K4 launched inside the
    timed window (the launch counters are set to 0, and the profiler
    opened, by run_load's on_pin hook, which it calls with its ring once
    the ring is warmed and pinned). TPS and launches come from the runs without a profiler,
    the device busy time from the profiled one. `device_window()` -> an
    object whose stop() gives (busy ms, ms by name)."""
    from plenum_tpu_torch import ops
    from plenum_tpu_torch.tools.local_pool import run_load
    timed: dict = {}

    def pinned(pipe):
        timed["pipe"] = pipe
        ops.reset_counts()
        if timed["profiler"] == "device":
            timed["window"] = device_window()
        elif timed["profiler"] is not None:
            timed["profiler"].enable()

    def brief(r: dict) -> dict:
        return {k: r.get(k) for k in (
            "txns_ordered", "txns_requested", "seconds", "tps",
            "p50_latency_ms", "p99_latency_ms", "ledger_sizes_agree",
            "backend_state", "crypto_plane", "commit_stage", "controller")}

    def device_run(what: str, n_txns: int, profiler=None, **kw) -> dict:
        """profiler: None, "device" (torch.profiler) or a cProfile.Profile,
        either open from pin() to the run's end."""
        timed.clear()
        timed["profiler"] = profiler
        try:
            r = run_load(4, n_txns, F_BACKEND, on_pin=pinned, **kw)
        finally:
            if isinstance(profiler, cProfile.Profile):
                profiler.disable()
        if "pipe" not in timed:
            raise AssertionError(f"{what}: run_load never pinned its ring")
        window = timed["window"].stop() if "window" in timed else None
        counts = dict(ops.LAUNCHES)
        pipe = timed["pipe"]
        if r["txns_ordered"] != r["txns_requested"] or \
                not r["ledger_sizes_agree"]:
            raise AssertionError(
                f"{what}: {r['txns_ordered']} of {r['txns_requested']} "
                f"ordered, ledgers agree: {r['ledger_sizes_agree']}")
        plane = r.get("crypto_plane") or {}
        if r.get("backend_state") != "ok" or plane.get("fallback_batches") \
                or plane.get("deadline_misses"):
            raise AssertionError(f"{what}: backend {r.get('backend_state')}"
                                 f", {plane}")
        off_card_check(what, pipe.verifier())
        if r["pipeline"]["unpinned_shapes"]:
            raise AssertionError(f"{what}: {r['pipeline']['unpinned_shapes']}"
                                 f" unpinned shapes")
        _require_launched_ed(what, counts)
        out = {**brief(r), "pipeline": r["pipeline"], "launches": counts}
        if window is not None:
            busy, by_name = window
            out.update({"device_busy_ms": busy, "device_ms_by_name": by_name,
                        "device_busy_share": busy / (r["seconds"] * 1e3)
                        if isinstance(busy, float) else busy})
        return out

    def twin_run(what: str, n_txns: int, **kw) -> dict:
        r = run_load(4, n_txns, "cpu", **kw)
        if r["txns_ordered"] != r["txns_requested"] or \
                not r["ledger_sizes_agree"]:
            raise AssertionError(f"{what}: the cpu twin ordered "
                                 f"{r['txns_ordered']} of "
                                 f"{r['txns_requested']}")
        return brief(r)

    from plenum_tpu_torch.crypto import ed25519 as ed_crypto
    # what the cpu twin verifies with on this host
    out = {"backend": F_BACKEND, "cpu_twin_verifier":
           "cryptography (C)" if ed_crypto._HAVE_CRYPTOGRAPHY
           else "pure-Python RFC 8032"}
    for tag, n_txns, runs, kw in (("F1", F1_TXNS, F1_RUNS, {}),
                                  ("F2", F2_TXNS, F2_RUNS,
                                   {"window": F2_WINDOW})):
        dev, cpu = [], []
        for i in range(runs):       # in turns: drift on the host hits both
            dev.append(device_run(f"path {tag} run {i}", n_txns, **kw))
            cpu.append(twin_run(f"path {tag} twin {i}", n_txns, **kw))
        med = statistics.median(d["tps"] for d in dev)
        med_cpu = statistics.median(c["tps"] for c in cpu)
        profiled = device_run(f"path {tag} under torch.profiler", n_txns,
                              profiler="device", **kw)
        out[tag] = {"n_txns": n_txns, **kw, "runs": dev, "cpu_twin": cpu,
                    "tps_median": med, "cpu_tps_median": med_cpu,
                    "tps_ratio_to_cpu": med / med_cpu,
                    "under_torch_profiler": profiled,
                    "profiler_tps_cost": 1 - profiled["tps"] / med}
    # where an F2 run's host time goes: one more run, cProfile open from
    # pin() to its end (it slows every Python call: read shares, not times)
    prof = cProfile.Profile()
    r = device_run("path F2 under cProfile", F2_TXNS, profiler=prof,
                   window=F2_WINDOW)
    out["F2"]["host_profile_one_run"] = {"tps_under_cprofile": r["tps"],
                                         **host_profile(prof)}
    return out


def _node_summaries(base: str, names) -> dict:
    """Each node's flushed metrics history (tools/metrics_report), as
    tcp_pool reads the first node's."""
    from plenum_tpu_torch.tools.metrics_report import (derive_summary,
                                                       fold_rows, read_store)
    return {n: derive_summary(fold_rows(read_store(
        os.path.join(base, n, "metrics"))), 0.0) for n in names}


def _require_nodes_on_plane(what: str, summaries: dict,
                            supervised: bool) -> dict:
    """Every node ordered (tcp_pool stops the nodes once f + 1 replied to
    the last request, so a node may stop a batch short); where its
    verifier is supervised (service nodes, card nodes), every node's
    flushed supervisor gauges show the breaker closed and nothing routed
    to its CPU fallback. -> txns ordered by node."""
    for name, s_ in summaries.items():
        if not s_.get("txns_ordered"):
            raise AssertionError(f"{what}: {name} ordered nothing")
        if not supervised:
            continue
        if s_.get("crypto_breaker_state") != "closed" or any(
                s_.get(k_) for k_ in ("crypto_fallback_batches",
                                      "crypto_hedge_wins",
                                      "crypto_deadline_misses",
                                      "crypto_breaker_opens")):
            raise AssertionError(f"{what}: {name}'s supervisor: " + str(
                {k_: v for k_, v in s_.items() if k_.startswith("crypto_")}))
    return {name: s_["txns_ordered"] for name, s_ in summaries.items()}


def _require_service_clean(what: str, stats: dict) -> None:
    """The crypto service's own counters: it dispatched, no worker-loop
    error (each is fed to the inner's breaker and could otherwise turn
    card faults into CPU verdicts unseen), and its supervisor routed
    nothing off the card."""
    plane = stats.get("plane") or {}
    hidden = {k_: plane.get(k_) for k_ in (
        "fallback_batches", "hedge_wins", "open_circuit_fallbacks",
        "backpressure_fallbacks", "device_errors", "deadline_misses",
        "verdict_forks") if plane.get(k_)}
    if stats.get("dispatches", 0) < 1 or stats.get("errors", 0) or hidden \
            or plane.get("breaker_state") != "closed":
        raise AssertionError(f"{what}: service {stats}")


def tcp_pool_path(off_card_check, device_window) -> dict:
    """Path G (module docstring): tools/tcp_pool's four start_node
    processes over the authenticated TCP stack, their client signatures
    verified on the card. G1: a CryptoPlaneServer in this process on a
    supervised G_BACKEND verifier, the nodes on "service"; G2: the
    service as its own process (service:G_BACKEND); G3: every node on
    its own card verifier; G4: an ObserverNode following a pool."""
    import asyncio
    import itertools
    import multiprocessing
    import tempfile
    import threading

    from plenum_tpu_torch import ops
    from plenum_tpu_torch.crypto.ed25519 import make_verifier, warm_up
    from plenum_tpu_torch.parallel.crypto_service import CryptoPlaneServer
    from plenum_tpu_torch.parallel.supervisor import find_supervisor
    from plenum_tpu_torch.tools.tcp_pool import run_tcp_pool

    names = [f"Node{i + 1}" for i in range(4)]
    # short paths: a run's service socket lies in its directory, and a
    # unix socket's path holds at most 107 bytes
    work = tempfile.mkdtemp(prefix="g_")
    run_dirs = itertools.count()
    out: dict = {"backend": G_BACKEND}

    def brief(r: dict) -> dict:
        return {k_: r.get(k_) for k_ in (
            "txns_ordered", "txns_requested", "seconds", "tps",
            "p50_latency_ms", "p99_latency_ms", "backend_state",
            "crypto_plane", "crypto_service", "commit_stage",
            "ordered_by_node")}

    def pool_run(what: str, n_txns: int, backend: str, supervised: bool,
                 **kw) -> dict:
        """run_tcp_pool in `loader`, a spawned process, so that its
        client's pure-Python packing does not share this process's
        interpreter lock with G1's service threads."""
        base = os.path.join(work, str(next(run_dirs)))
        r = loader.apply_async(run_tcp_pool, (4, n_txns, backend),
                               dict(base_dir=base, **kw)).get(600.0)
        if r["txns_ordered"] != r["txns_requested"] or \
                r["txns_requested"] != n_txns:
            raise AssertionError(f"{what}: {r['txns_ordered']} of "
                                 f"{r['txns_requested']} ordered")
        if supervised and r.get("backend_state") != "ok":
            raise AssertionError(f"{what}: backend {r.get('backend_state')}"
                                 f", {r.get('crypto_plane')}")
        r["ordered_by_node"] = _require_nodes_on_plane(
            what, _node_summaries(base, names), supervised)
        shutil.rmtree(base, ignore_errors=True)
        return r

    # --- G1: the service in this process --------------------------------
    sock = os.path.join(work, "crypto.sock")
    # warmed before any node dials, as the service's own main warms it
    inner = warm_up(make_verifier(G_BACKEND, supervised=True))
    sup = find_supervisor(inner)
    server = CryptoPlaneServer(inner, socket_path=sock)
    started = threading.Event()

    async def serve():
        await server.start()
        started.set()
        while not server._stop.is_set():
            await asyncio.sleep(0.05)
        await server.stop()

    thread = threading.Thread(
        target=lambda: asyncio.new_event_loop().run_until_complete(serve()),
        daemon=True)
    thread.start()
    if not started.wait(30.0):
        raise AssertionError("path G1: the crypto service never started")
    saved_socket = os.environ.get("PLENUM_CRYPTO_SOCKET")
    os.environ["PLENUM_CRYPTO_SOCKET"] = sock
    # the load's own process, spawned with this socket in its env
    loader = multiprocessing.get_context("spawn").Pool(1)
    if saved_socket is None:
        os.environ.pop("PLENUM_CRYPTO_SOCKET")
    else:
        os.environ["PLENUM_CRYPTO_SOCKET"] = saved_socket

    def service_run(what: str, profiled: bool = False) -> dict:
        st0 = dict(server.stats)
        ops.reset_counts()
        window = device_window() if profiled else None
        r = pool_run(what, G1_TXNS, "service", True, window=G1_WINDOW)
        busy = window.stop() if window is not None else None
        counts = dict(ops.LAUNCHES)
        delta = {k_: v - st0.get(k_, 0) for k_, v in server.stats.items()
                 if isinstance(v, int)}
        _require_service_clean(what, {**delta,
                                      "plane": sup.supervisor_stats(),
                                      "errors": server.stats.get("errors",
                                                                 0)})
        off_card_check(what, inner)
        _require_launched_ed(what, counts)
        if counts["ed25519_decompress"] != counts["ed25519_verify"]:
            raise AssertionError(f"{what}: K3 and K4 launched "
                                 f"{counts['ed25519_decompress']} and "
                                 f"{counts['ed25519_verify']} times")
        run = {**brief(r), "service": delta, "launches": counts}
        if busy is not None:
            busy_ms, by_name = busy
            run.update({"device_busy_ms": busy_ms,
                        "device_ms_by_name": by_name,
                        "device_busy_share": busy_ms / (r["seconds"] * 1e3)
                        if isinstance(busy_ms, float) else busy_ms})
        return run

    def twin_run(what: str) -> dict:
        ops.reset_counts()
        r = pool_run(what, G1_TXNS, "service:cpu", True, window=G1_WINDOW)
        if any(ops.LAUNCHES.values()):
            raise AssertionError(f"{what}: the host twin launched "
                                 f"{dict(ops.LAUNCHES)}")
        return brief(r)

    try:
        try:
            dev, cpu = [], []
            for i in range(G1_RUNS):    # in turns: host drift hits both
                dev.append(service_run(f"path G1 run {i}"))
                cpu.append(twin_run(f"path G1 twin {i}"))
            profiled = service_run("path G1 under torch.profiler",
                                   profiled=True)
        finally:
            server._stop.set()
            thread.join(timeout=10.0)
        med = statistics.median(d_["tps"] for d_ in dev)
        med_cpu = statistics.median(c_["tps"] for c_ in cpu)
        out["G1"] = {"n_txns": G1_TXNS, "window": G1_WINDOW, "runs": dev,
                     "cpu_twin": cpu, "tps_median": med,
                     "cpu_tps_median": med_cpu,
                     "tps_ratio_to_cpu": med / med_cpu,
                     "under_torch_profiler": profiled,
                     "supervisor": sup.supervisor_stats(),
                     "server": dict(server.stats)}
        counts = {k_: sum(r_["launches"][k_] for r_ in dev + [profiled])
                  for k_ in ops.LAUNCHES}
        ops.reset_counts()      # G2-G4 launch in their own processes

        # --- G2: the operator's entry point, the service its own process
        r = pool_run("path G2", G1_TXNS, f"service:{G_BACKEND}", True,
                     window=G1_WINDOW)
        if not r.get("crypto_service"):
            raise AssertionError("path G2: no stats from the crypto service")
        _require_service_clean("path G2", r["crypto_service"])
        out["G2"] = brief(r)

        # --- G3: every node on its own card verifier ----------------------
        ops.build()         # built once here: no node process runs nvcc
        out["G3"] = brief(pool_run("path G3", G3_TXNS, G_BACKEND, True))
    except BaseException:
        loader.terminate()
        raise
    loader.close()
    loader.join()

    # --- G4: an observer following a pool ---------------------------------
    out["G4"] = observer_run(os.path.join(work, "o"), names)
    shutil.rmtree(work, ignore_errors=True)
    out["launches_g2_to_g4_this_process"] = dict(ops.LAUNCHES)
    out["launches"] = {k_: v + ops.LAUNCHES[k_] for k_, v in counts.items()}
    return out


def observer_run(base: str, names) -> dict:
    """Path G4: four `cpu` start_node processes (durable stores) and an
    ObserverNode on G_BACKEND following them through G4_NYMS NYMs. Fails
    unless the observer's domain ledger and state equal every
    validator's (rebuilt from its stores after the run) and a GET_NYM
    read_proof envelope from the observer's client port verifies under
    the pool's BLS keys."""
    import asyncio
    import signal
    import socket
    import subprocess

    from plenum_tpu_torch.client.wallet import Wallet
    from plenum_tpu_torch.common.node_messages import DOMAIN_LEDGER_ID
    from plenum_tpu_torch.common.request import Request
    from plenum_tpu_torch.common.serialization import pack, unpack
    from plenum_tpu_torch.execution.txn import GET_NYM, NYM
    from plenum_tpu_torch.node.bootstrap import NodeBootstrap
    from plenum_tpu_torch.node.observer_node import ObserverNode
    from plenum_tpu_torch.reads import READ_PROOF, verify_read_proof
    from plenum_tpu_torch.tools.genesis import load_genesis_files
    from plenum_tpu_torch.tools.tcp_pool import (REPO, _wait_all_started,
                                                 drive_load, setup_pool_dir)

    trustee_seed = b"chip-smoke-observer".ljust(32, b"\0")
    specs = setup_pool_dir(base, names, trustee_seed)
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    env.pop("PLENUM_CONFIG_JSON", None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "plenum_tpu_torch.tools.start_node",
         "--name", n_, "--base-dir", base, "--kv", "file",
         "--backend", "cpu"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for n_ in names]
    try:
        _wait_all_started(procs, deadline_s=60.0)
        genesis = load_genesis_files(base)
        addrs = {n_: ("127.0.0.1", spec[3]) for n_, spec in zip(names, specs)}
        with socket.socket() as s_:
            s_.bind(("127.0.0.1", 0))
            obs_port = s_.getsockname()[1]
        t0 = time.perf_counter()
        # anchor_lag_max=None: the anchors' timestamps are the primary's
        # pp_time, which start_node takes from time.perf_counter, and the
        # lag bound compares them with the observer's time.time, so a
        # bound strips every envelope of an OS-process pool
        obs = ObserverNode("observer1", genesis, addrs, f=1,
                           client_port=obs_port, client_host="127.0.0.1",
                           anchor_lag_max=None, crypto_backend=G_BACKEND)
        wallet = Wallet("chip-smoke-observer")
        trustee = wallet.add_identifier(seed=trustee_seed)
        users, reqs = [], []
        for i in range(G4_NYMS):
            user = wallet.add_identifier(seed=hashlib.sha256(
                b"chip-smoke-obs-%d" % i).digest())
            users.append(user)
            reqs.append(wallet.sign_request(
                {"type": NYM, "dest": user, "verkey": wallet.verkey_of(user)},
                identifier=trustee))
        ledger = obs.observer.c.db.get_ledger(DOMAIN_LEDGER_ID)
        query = Request("chip-smoke-reader", 1,
                        {"type": GET_NYM, "dest": users[-1]})

        async def scenario():
            stop = asyncio.Event()
            task = asyncio.create_task(obs.run(stop))
            try:
                await asyncio.sleep(1.0)         # registrations land
                done, _ = await drive_load(addrs, 1, reqs, window=100,
                                           timeout=120.0)
                if len(done) != G4_NYMS:
                    raise AssertionError(f"path G4: {len(done)} of "
                                         f"{G4_NYMS} NYMs ordered")
                deadline = time.monotonic() + 30.0
                while ledger.size < 1 + G4_NYMS and \
                        time.monotonic() < deadline:
                    await asyncio.sleep(0.1)
                if ledger.size != 1 + G4_NYMS:
                    raise AssertionError(f"path G4: the observer holds "
                                         f"{ledger.size} txns")
                # one verified read from the observer's client port
                reader, writer = await asyncio.open_connection("127.0.0.1",
                                                               obs_port)
                data = pack(query.to_dict())
                writer.write(len(data).to_bytes(4, "big") + data)
                await writer.drain()
                hdr = await asyncio.wait_for(reader.readexactly(4), 30.0)
                reply = unpack(await reader.readexactly(
                    int.from_bytes(hdr, "big")))
                writer.close()
                return reply
            finally:
                stop.set()
                await task

        reply = asyncio.run(scenario())
        wall_s = time.perf_counter() - t0
    finally:
        for p_ in procs:
            if p_.poll() is None:
                p_.send_signal(signal.SIGTERM)
        for p_ in procs:
            try:
                p_.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p_.kill()
    result = reply.get("result") or {}
    bls_keys = ObserverNode._genesis_bls_keys(genesis)
    ok, why = verify_read_proof(GET_NYM, query.operation, result, bls_keys,
                                freshness_s=1e12, n_nodes=len(names))
    if reply.get("op") != "REPLY" or READ_PROOF not in result or not ok:
        raise AssertionError(f"path G4: the observer's read_proof does not "
                             f"verify ({why}): {reply}")
    mine = (ledger.size, ledger.root_hash, obs.observer.c.db.get_state(
        DOMAIN_LEDGER_ID).committed_head_hash)
    for n_ in names:
        c_ = NodeBootstrap(n_, genesis_txns=genesis, crypto_backend="cpu",
                           data_dir=os.path.join(base, n_, "data")).build()
        theirs = (c_.db.get_ledger(DOMAIN_LEDGER_ID).size,
                  c_.db.get_ledger(DOMAIN_LEDGER_ID).root_hash,
                  c_.db.get_state(DOMAIN_LEDGER_ID).committed_head_hash)
        c_.db.close()
        if theirs != mine:
            raise AssertionError(f"path G4: {n_}'s domain "
                                 f"{theirs[0]} txns differs from the "
                                 f"observer's {mine[0]}")
    return {"nyms": G4_NYMS, "observer_backend": G_BACKEND,
            "domain_size": mine[0], "root": mine[1].hex(),
            "read_proof": why or "ok", "wall_s": wall_s,
            "gate": dict(obs.read_gate.stats)}


def production_pool(off_card_check, batch_device, state) -> dict:
    """Path F3 (module docstring): tools/local_pool.build_pool's four
    Nodes on F_BACKEND, each started from a copy of `state`'s domain
    (replica_state, path E's), fed F3_BATCHES batches of F3_REQUESTS
    NYMs made as path E makes them. Each batch fails unless every node
    replied to the F3_REQUESTS - 10 valid requests, NACKed the 8
    corrupted and rejected the 2 role-less ones, the domain ledger grew
    by F3_REQUESTS - 10 on every node, and the domain, pool and audit
    ledger roots and the domain and pool state roots are equal across
    the nodes; and, over the measured batches, unless the supervisor
    routed nothing off the card, no shape went unpinned and K3 + K4
    launched in every batch. `batch_device(fn)` -> (fn(), wall ms, busy
    ms, ms by name)."""
    import numpy as np

    from plenum_tpu_torch import ops
    from plenum_tpu_torch.common.node_messages import (AUDIT_LEDGER_ID,
                                                       POOL_LEDGER_ID, Reject,
                                                       RequestNack)
    from plenum_tpu_torch.tools.local_pool import (build_pool,
                                                   commit_stage_stats)
    perf = time.perf_counter
    genesis = state["genesis"]
    t0 = perf()
    (names, nodes, timer, _trustee, replies, Reply, DOMAIN_LEDGER_ID, plane,
     _net) = build_pool(4, F_BACKEND, genesis=(genesis, state["trustee"]),
                        rows=state["rows"])
    pipe = plane._pipeline
    setup_s = perf() - t0
    batch_requests = nym_batches(state["trustee"], state["idle"],
                                 np.random.default_rng(20261019),
                                 F3_REQUESTS, first_user=10**6)
    # per node: Replies, Rejects and NACKs since the batch's submit, the
    # time of the last of them, and how many client messages were read
    kinds = (Reply, Reject, RequestNack)
    tallies: dict = {}

    def tally(n):
        t = tallies[n]
        for ts, msg, _client in replies[n][t[4]:]:
            for i, kind in enumerate(kinds):
                if isinstance(msg, kind):
                    t[i] += 1
                    t[3] = ts
        t[4] = len(replies[n])
        return tuple(t[:3])

    def prod_all():
        timer.service()
        for node in nodes.values():
            node.prod()
        plane.flush()

    def roots(n):
        db = nodes[n].c.db
        return (db.get_ledger(DOMAIN_LEDGER_ID).root_hash,
                db.get_ledger(POOL_LEDGER_ID).root_hash,
                db.get_ledger(AUDIT_LEDGER_ID).root_hash,
                db.get_state(DOMAIN_LEDGER_ID).committed_head_hash,
                db.get_state(POOL_LEDGER_ID).committed_head_hash)

    def one_batch(what: str, k: int, timeout: float = 300.0) -> dict:
        reqs, expect, roleless = batch_requests(k * F3_REQUESTS)
        want = (sum(expect) - len(roleless), len(roleless),
                len(expect) - sum(expect))
        sizes0 = {n: nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).size
                  for n in names}
        audit0 = nodes[names[0]].c.db.get_ledger(AUDIT_LEDGER_ID).size
        for n in names:
            replies[n].clear()
            tallies[n] = [0, 0, 0, 0.0, 0]
        t_submit = perf()
        for req in reqs:
            d = req.to_dict()
            for n in names:
                nodes[n].handle_client_message(d, "f3")
        deadline = t_submit + timeout
        while any(tally(n) != want for n in names):
            if perf() > deadline or any(
                    a > b for n in names for a, b in zip(tally(n), want)):
                raise AssertionError(
                    f"{what}: replies (Reply, Reject, Nack) "
                    f"{ {n: tally(n) for n in names} }, want {want}")
            prod_all()
        last = max(tallies[n][3] for n in names)
        grown = {n: nodes[n].c.db.get_ledger(DOMAIN_LEDGER_ID).size
                 - sizes0[n] for n in names}
        if set(grown.values()) != {want[0]}:
            raise AssertionError(f"{what}: the domain ledgers grew by "
                                 f"{grown}, want {want[0]}")
        if len({roots(n) for n in names}) != 1:
            raise AssertionError(f"{what}: the nodes' roots differ")
        return {"submit_to_last_reply_ms": (last - t_submit) * 1e3,
                "ordered": want[0], "rejected": want[1], "nacked": want[2],
                "three_pc_batches": nodes[names[0]].c.db.get_ledger(
                    AUDIT_LEDGER_ID).size - audit0}

    # warm-up as run_load's (held to the reference's code, so it stays
    # there): the smallest buckets and the cmt ladder, one unmeasured
    # batch, then pin
    t0 = perf()
    pipe.prewarm(pipe.buckets[:2])
    pipe.prewarm_cmt([1, 2, 4, 8])
    one_batch("path F3 warm-up", 1)
    pipe.pin()
    warm_s = perf() - t0
    batches = []
    ops.reset_counts()
    for k in range(2, 2 + F3_BATCHES):
        counts0, st0 = dict(ops.LAUNCHES), dict(pipe.stats)
        rec, wall, busy, by_name = batch_device(
            lambda: one_batch(f"path F3 batch {k}", k))
        counts = {k_: ops.LAUNCHES[k_] - counts0[k_] for k_ in ops.LAUNCHES}
        _require_launched_ed(f"path F3 batch {k}", counts)
        got = {k_: pipe.stats[k_] - st0[k_] for k_ in pipe.stats}
        batches.append({**rec, "wall_ms": wall, "device_busy_ms": busy,
                        "device_ms_by_name": by_name, "launches": counts,
                        "ed_dispatches": got["dispatches"],
                        "dedup_hits": got["dedup_hits"],
                        "pad_items": got["pad_items"],
                        "dispatched_items": got["dispatched_items"],
                        "bls_items": got["bls_items"],
                        "sha_unique": got["sha_unique"]})
    counts = dict(ops.LAUNCHES)
    off_card_check("path F3", plane)
    if pipe.stats["unpinned_shapes"]:
        raise AssertionError(f"path F3: {pipe.stats['unpinned_shapes']} "
                             f"unpinned shapes")
    ctl = getattr(nodes[names[0]], "batch_controller", None)
    return {"nodes": len(nodes), "requests_per_batch": F3_REQUESTS,
            "domain_txns_at_start": len(genesis[DOMAIN_LEDGER_ID]),
            "domain_txns_after": nodes[names[0]].c.db.get_ledger(
                DOMAIN_LEDGER_ID).size,
            "setup_s": setup_s, "warm_up_s": warm_s, "batches": batches,
            "launches": counts, "summary": pipe.summary(),
            "commit_stage": commit_stage_stats(nodes[names[0]].metrics),
            "controller": ctl.trajectory() if ctl is not None else None}


def _lane_devices(pipe) -> list:
    """Each lane's device, read beneath its supervisor."""
    from plenum_tpu_torch.parallel.pipeline import _device_of
    return [str(_device_of(lane.inner)) for lane in pipe.lanes]


def _spawn_service(sock: str, log_path: str):
    """`python -m plenum_tpu_torch.parallel.crypto_service` on H_BACKEND
    at `sock`, as an operator starts a rostered crypto host -> the process
    once its socket accepts (the service warms its verifier before it
    binds)."""
    import socket as socket_mod
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)))
    with open(log_path, "ab") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "plenum_tpu_torch.parallel.crypto_service",
             "--socket", sock, "--backend", H_BACKEND, "--min-batch", "1"],
            stdout=log, stderr=subprocess.STDOUT, env=env)
    deadline = time.monotonic() + 180.0
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            with open(log_path) as fh:
                tail = fh.read()[-2000:]
            raise AssertionError(f"crypto service exited {proc.returncode}: "
                                 + tail)
        try:
            with socket_mod.socket(socket_mod.AF_UNIX) as s:
                s.connect(sock)
            return proc
        except OSError:
            time.sleep(0.1)
    proc.kill()
    raise AssertionError("crypto service never bound its socket")


def scale_out_path(off_card_check, d_batch, device_window) -> dict:
    """Path H (module docstring): the multi-lane ring (H1), the federated
    ring with one rostered crypto host (H2), multi-host on one rank (H3)
    and the Amdahl budget of the TCP pool's node processes (H4).
    `d_batch` -> (path D's first batch of requests, its verdicts, the
    verkey lookup, path B's host batch and its verdicts and root);
    `device_window()` as in pool_runs."""
    import signal
    import tempfile

    import numpy as np

    from plenum_tpu_torch import ops
    from plenum_tpu_torch.config import Config
    from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
    from plenum_tpu_torch.node.client_authn import CoreAuthNr, ReqAuthenticator
    from plenum_tpu_torch.parallel.crypto_service import \
        ServiceEd25519Verifier
    from plenum_tpu_torch.parallel.federation import (FederatedCryptoPipeline,
                                                      make_federated_pipeline)
    from plenum_tpu_torch.parallel.pipeline import (MultiDeviceCryptoPipeline,
                                                    make_crypto_pipeline)
    from plenum_tpu_torch.parallel.supervisor import find_supervisor
    from plenum_tpu_torch.tools.local_pool import run_load

    lane_type = "cuda" if H_BACKEND == "cuda" else "cpu"
    work = tempfile.mkdtemp(prefix="h_")
    out: dict = {"backend": H_BACKEND}
    timed: dict = {}

    def pinned(pipe):
        """run_load's on_pin: the ring's counters as the timed phase
        starts, the launch counters set to 0."""
        timed["pipe"] = pipe
        timed["dispatches"] = [d_["dispatches"] for d_ in pipe.device_state()]
        timed["items"] = pipe.stats["dispatched_items"]
        timed["repeats"] = pipe.inflight_repeats
        ops.reset_counts()
        if timed["profiled"]:
            timed["window"] = device_window()

    def ring_run(what: str, overrides: dict, profiled: bool = False) -> tuple:
        """run_load on H_BACKEND with `overrides` -> (its result, its ring,
        K3/K4 launched and each lane's dispatches in the timed phase, the
        ring's dispatches beyond one a signature, the device window's
        (busy ms, ms by name, busy union ms) when `profiled`). Fails
        unless every txn was ordered, the ledgers agree, no shape went
        unpinned, and every dispatch beyond one a signature repeats a
        signature that sat in a wave not yet resolved (the ring's dedup
        scope, ROADMAP C): a dispatch the dedup should have caught fails
        the run."""
        timed.clear()
        timed["profiled"] = profiled
        r = run_load(4, H_TXNS, H_BACKEND, config_overrides=overrides,
                     on_pin=pinned)
        window = None
        if "window" in timed:
            busy, by_name = timed["window"].stop()
            window = (busy, by_name, timed["window"].union_ms)
        if "pipe" not in timed:
            raise AssertionError(f"{what}: run_load never pinned its ring")
        pipe = timed["pipe"]
        if r["txns_ordered"] != r["txns_requested"] or \
                not r["ledger_sizes_agree"]:
            raise AssertionError(f"{what}: {r['txns_ordered']} of "
                                 f"{r['txns_requested']} ordered, ledgers "
                                 f"agree: {r['ledger_sizes_agree']}")
        if r["pipeline"]["unpinned_shapes"]:
            raise AssertionError(f"{what}: unpinned shapes")
        beyond = pipe.stats["dispatched_items"] - timed["items"] \
            - r["txns_requested"]
        repeats = pipe.inflight_repeats - timed["repeats"]
        if beyond != repeats:
            raise AssertionError(
                f"{what}: {beyond} dispatches beyond one a signature, of "
                f"which {repeats} repeat a signature in a wave not yet "
                f"resolved")
        counts = dict(ops.LAUNCHES)
        lane_disp = [d_["dispatches"] - n_ for d_, n_ in
                     zip(pipe.device_state(), timed["dispatches"])]
        return r, pipe, counts, lane_disp, beyond, window

    def brief(r: dict) -> dict:
        return {k_: r.get(k_) for k_ in (
            "txns_ordered", "txns_requested", "seconds", "tps",
            "p50_latency_ms", "p99_latency_ms", "ledger_sizes_agree",
            "backend_state")}

    def twin_run(what: str) -> dict:
        r = run_load(4, H_TXNS, "cpu")
        if r["txns_ordered"] != r["txns_requested"]:
            raise AssertionError(f"{what}: the cpu twin ordered "
                                 f"{r['txns_ordered']} of "
                                 f"{r['txns_requested']}")
        return brief(r)

    h_counts = {k_: 0 for k_ in ops.LAUNCHES}

    def add_counts(counts: dict) -> None:
        for k_, v in counts.items():
            h_counts[k_] += v

    def h1_run(what: str, profiled: bool = False) -> dict:
        r, pipe, counts, lane_disp, beyond, window = ring_run(
            what, dict(PIPELINE_DEVICES=H_LANES), profiled)
        if type(pipe) is not MultiDeviceCryptoPipeline or \
                len(pipe.lanes) != H_LANES or \
                {d_.split(":")[0] for d_ in _lane_devices(pipe)} != \
                {lane_type} or not all(
                    l_.threaded == (lane_type == "cuda") for l_ in pipe.lanes):
            raise AssertionError(f"{what}: not {H_LANES} {lane_type} lanes: "
                                 f"{type(pipe).__name__} "
                                 f"{_lane_devices(pipe)}")
        state = pipe.device_state()
        if any(d_["dispatches"] < 1 for d_ in state):
            raise AssertionError(f"{what}: a lane never dispatched: {state}")
        for k_, lane in enumerate(pipe.lanes):
            off_card_check(f"{what} lane {k_}", lane.inner)
        if counts["ed25519_decompress"] != counts["ed25519_verify"] or \
                counts["ed25519_verify"] != sum(lane_disp) or \
                counts["ed25519_verify"] < 1:
            raise AssertionError(f"{what}: K3 {counts['ed25519_decompress']}"
                                 f", K4 {counts['ed25519_verify']} against "
                                 f"{lane_disp} lane dispatches")
        pipe.close()
        run = {**brief(r), "launches": counts,
               "lane_dispatches_timed": lane_disp,
               "dispatched_beyond_unique_signatures": beyond,
               "lanes": state, "lane_devices": _lane_devices(pipe),
               "pipeline": {k_: r["pipeline"].get(k_) for k_ in (
                   "dispatches", "dispatched_items", "items_per_dispatch",
                   "pipeline_dedup_ratio", "pad_waste", "unpinned_shapes")}}
        if window is not None:
            busy, by_name, union = window
            wall = r["seconds"] * 1e3
            run.update({"device_kernel_ms": busy, "device_ms_by_name": by_name,
                        "device_busy_union_ms": union,
                        "lanes_overlap_ms": busy - union
                        if isinstance(busy, float) else busy,
                        "device_busy_share": union / wall
                        if isinstance(union, float) else union})
        return run

    # --- H1: the multi-lane ring, four lanes wrapped onto the card --------
    t_h = time.perf_counter()
    dev_runs, cpu_runs = [], []
    for i in range(H1_RUNS):       # in turns: drift on the host hits both
        dev_runs.append(h1_run(f"path H1 run {i}"))
        add_counts(dev_runs[-1]["launches"])
        cpu_runs.append(twin_run(f"path H1 twin {i}"))
    med = statistics.median(d_["tps"] for d_ in dev_runs)
    med_cpu = statistics.median(c_["tps"] for c_ in cpu_runs)
    # whether the lanes' waves overlap on the card: one more run, the
    # profiler open over its timed phase (its launches are not added)
    profiled = h1_run("path H1 under torch.profiler", profiled=True)
    # path D's first four-replica batch through a four-lane ring
    d_reqs, d_verdicts, get_verkey = d_batch["ring"]
    ops.reset_counts()
    pipe4 = make_crypto_pipeline(Config(PIPELINE_SHA_MIN_BATCH=512),
                                 H_BACKEND, n_devices=H_LANES)
    authns = []
    for _ in range(4):
        a_ = ReqAuthenticator()
        a_.register_authenticator(CoreAuthNr(verifier=pipe4.verifier(),
                                             get_verkey=get_verkey))
        authns.append(a_)
    # warmed, not pinned: as path D's warm-up batch does, the batch notes
    # its full key-table shape (a pinned ring would split it at the
    # prewarm's 64-key table)
    pipe4.prewarm([1024])
    ops.reset_counts()
    t_d = time.perf_counter()
    got = [a_.authenticate_batch(d_reqs) for a_ in authns]
    d_ms = (time.perf_counter() - t_d) * 1e3
    for v in got:
        if v.tolist() != d_verdicts.tolist():
            raise AssertionError("path H1: the four-lane ring's verdicts on "
                                 "path D's batch differ from the single "
                                 "ring's")
    for k_, lane in enumerate(pipe4.lanes):
        off_card_check(f"path H1 ring batch lane {k_}", lane.inner)
    d_counts = dict(ops.LAUNCHES)
    add_counts(d_counts)
    pipe4.close()
    out["H1"] = {"n_txns": H_TXNS, "lanes": H_LANES, "runs": dev_runs,
                 "cpu_twin": cpu_runs, "tps_median": med,
                 "cpu_tps_median": med_cpu, "tps_ratio_to_cpu": med / med_cpu,
                 "under_torch_profiler": profiled,
                 "ring_batch": {"replicas": 4, "requests": len(d_reqs),
                                "wall_ms": d_ms, "launches": d_counts,
                                "lanes": pipe4.device_state(),
                                "equal_to_path_d": True},
                 "path_s": time.perf_counter() - t_h}

    # --- H2: the federated ring: a local lane and one crypto host --------
    t_h2 = time.perf_counter()
    sock = os.path.join(work, "fed.sock")
    log_path = os.path.join(work, "service.log")
    svc = _spawn_service(sock, log_path)
    try:
        svc_start_s = time.perf_counter() - t_h2
        stats0 = ServiceEd25519Verifier(socket_path=sock).stats()
        what = "path H2"
        r, pipe, counts, lane_disp, beyond, _ = ring_run(
            what, dict(PIPELINE_REMOTE_HOSTS=sock))
        if type(pipe) is not FederatedCryptoPipeline or pipe.n_local != 1 \
                or len(pipe.lanes) != 2:
            raise AssertionError(f"{what}: not one local lane and one remote")
        fed = pipe.federation_state()
        if fed["remote_lanes"] != 1 or not fed["ship_ms_p95"] > 0:
            raise AssertionError(f"{what}: federation {fed}, lane "
                                 f"dispatches {lane_disp}")
        off_card_check(f"{what} local lane", pipe.lanes[0].inner)
        remote_sup = find_supervisor(pipe.lanes[1].inner)
        if remote_sup.breaker.state != "closed" or any(
                remote_sup.stats[k_] for k_ in (
                    "fallback_batches", "hedge_wins", "device_errors",
                    "deadline_misses", "verdict_forks")):
            raise AssertionError(f"{what}: the remote lane's supervisor "
                                 f"{remote_sup.supervisor_stats()}")
        stats1 = ServiceEd25519Verifier(socket_path=sock).stats()
        svc_delta = {k_: v - stats0.get(k_, 0) for k_, v in stats1.items()
                     if isinstance(v, int)}
        _require_service_clean(what, {**svc_delta, "plane": stats1.get(
            "plane") or {}, "errors": stats1.get("errors", 0)})
        if counts["ed25519_verify"] != lane_disp[0]:
            raise AssertionError(f"{what}: K4 {counts['ed25519_verify']} "
                                 f"against {lane_disp[0]} local waves")
        add_counts(counts)
        pipe.close()
        h2 = {**brief(r), "federation": fed,
              "dispatched_beyond_unique_signatures": beyond,
              "lane_dispatches_timed": lane_disp, "lanes": pipe.device_state(),
              "launches_local_lane": counts,
              "service_dispatches_remote_k3_k4": svc_delta.get("dispatches"),
              "service": svc_delta, "service_start_s": svc_start_s}

        # the kill rung: the host dies under waves the ring's own
        # placement gave it, then rejoins
        signer = Ed25519Signer(seed=b"h2-kill".ljust(32, b"\0"))
        items = [(b"h2-%d" % i, signer.sign(b"h2-%d" % i), signer.verkey)
                 for i in range(H2_KILL_ITEMS)]
        items[7] = (items[7][0], items[7][1][:32] + bytes(32), items[7][2])
        want = [i != 7 for i in range(H2_KILL_ITEMS)]
        kpipe = make_federated_pipeline(
            Config(PIPELINE_MIN_BUCKET=16, PIPELINE_MAX_BUCKET=64,
                   PIPELINE_FLUSH_WAIT=0.0), hosts=[sock], n_devices=1,
            devices=None if H_BACKEND == "cuda" else ["cpu"])
        kpipe.prewarm([16, 32])
        kpipe.pin()
        items0 = kpipe.stats["dispatched_items"]
        k_sup = find_supervisor(kpipe.lanes[1].inner)
        half = H2_KILL_ITEMS // 2
        # no lane has a drain sample yet: unhinted placement takes the
        # least-occupied lane, so the waves alternate between the two
        toks = [kpipe.submit_verify(items[n:n + 20])
                for n in range(0, half, 20)]
        kpipe.service(force=True)
        remote_waves_at_kill = kpipe.device_state()[1]["dispatches"]
        svc.send_signal(signal.SIGKILL)
        svc.wait(timeout=30)
        got = [kpipe.collect_verify(t_, wait=True) for t_ in toks]
        errors_in_flight = k_sup.stats["device_errors"]
        # the dead host opens its breaker under direct batches (the
        # reference's crypto-host-down recipe)
        nudges = 0
        while k_sup.breaker.state == "closed" and nudges < 30:
            k_sup.verify_batch(items[:4])
            nudges += 1
        # the rest: placement routes around the open lane
        remote_waves = kpipe.device_state()[1]["dispatches"]
        toks = [kpipe.submit_verify(items[n:n + 20])
                for n in range(half, H2_KILL_ITEMS, 20)]
        got += [kpipe.collect_verify(t_, wait=True) for t_ in toks]
        got = np.concatenate(got)
        double = kpipe.stats["dispatched_items"] - items0 - H2_KILL_ITEMS
        local_sup = find_supervisor(kpipe.lanes[0].inner)
        remote_after = kpipe.device_state()[1]["dispatches"] - remote_waves
        if got.tolist() != want or double != 0 or remote_waves_at_kill < 1 \
                or errors_in_flight < 1 or remote_after:
            raise AssertionError(
                f"path H2 kill: verdicts right {got.tolist() == want}, "
                f"{double} dispatched beyond the {H2_KILL_ITEMS} items, "
                f"remote waves at the kill {remote_waves_at_kill}, device "
                f"errors from them {errors_in_flight}, remote waves after "
                f"its breaker opened {remote_after}")
        if local_sup.breaker.state != "closed" or \
                k_sup.breaker.state == "closed":
            raise AssertionError(f"path H2 kill: breakers local "
                                 f"{local_sup.breaker.state}, remote "
                                 f"{k_sup.breaker.state}")
        off_card_check("path H2 kill local lane", kpipe.lanes[0].inner)
        # the host comes back on the same socket; the pump alone re-admits
        t_restart = time.perf_counter()
        svc = _spawn_service(sock, log_path)
        back_s = time.perf_counter() - t_restart
        t_up = time.perf_counter()
        limit = k_sup.breaker.cooldown + H2_PROBE_SLACK_S
        while k_sup.breaker.state != "closed" and \
                time.perf_counter() - t_up < limit:
            kpipe.service()
            time.sleep(0.05)
        rejoin_s = time.perf_counter() - t_up
        if k_sup.breaker.state != "closed":
            raise AssertionError(f"path H2 kill: the remote breaker stayed "
                                 f"{k_sup.breaker.state} {rejoin_s:.1f} s "
                                 f"after the host came back (limit "
                                 f"{limit:.1f} s)")
        kpipe.close()
        h2["kill_rung"] = {
            "items": H2_KILL_ITEMS, "dispatched_beyond_items": double,
            "remote_waves_at_kill": remote_waves_at_kill,
            "device_errors_from_waves_in_flight": errors_in_flight,
            "nudges_to_open": nudges, "lanes": kpipe.device_state(),
            "remote_supervisor": k_sup.supervisor_stats(),
            "restart_s": back_s, "rejoin_after_restart_s": rejoin_s,
            "probe_limit_s": limit}
        h2["path_s"] = time.perf_counter() - t_h2
        out["H2"] = h2
    finally:
        if svc.poll() is None:
            svc.terminate()
            try:
                svc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                svc.kill()
                svc.wait()

    # --- H3: multi-host on one rank ---------------------------------------
    t_h3 = time.perf_counter()
    import socket as socket_mod

    import torch.distributed as dist

    from plenum_tpu_torch.ops.sha256 import digests_to_bytes
    from plenum_tpu_torch.parallel.crypto_plane import (STEP_BYTES_SPECS,
                                                        ShardedCryptoPlane)
    from plenum_tpu_torch.parallel.mesh import lane_roster
    from plenum_tpu_torch.parallel.multihost import (global_mesh,
                                                     init_multihost,
                                                     shard_host_batch)
    with socket_mod.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ops.reset_counts()
    group = "nccl" if H_BACKEND == "cuda" else "gloo"
    preflight = init_multihost(coordinator=f"127.0.0.1:{port}",
                               num_processes=1, process_id=0, backend=group)
    try:
        mesh = global_mesh(devices=lane_roster(
            4, None if H_BACKEND == "cuda" else ["cpu"]))
        if not mesh.in_group:
            raise AssertionError("path H3: the global mesh is not over the "
                                 "process group")
        host_args, b_ok, b_root = d_batch["plane"]
        args = [shard_host_batch(mesh, a_, spec)
                for a_, spec in zip(host_args, STEP_BYTES_SPECS)]
        # the plane gathers the shard roots and sums the count over the
        # group's ranks itself (all_gather, all_reduce on the card)
        ok_h, root_h, n_all = ShardedCryptoPlane(mesh).step_bytes(*args)
        if not np.array_equal(ok_h.cpu().numpy(), b_ok) or \
                digests_to_bytes(root_h[None]) != digests_to_bytes(
                    b_root[None]) or int(n_all) != int(b_ok.sum()):
            raise AssertionError("path H3: verdicts, root or count differ "
                                 "from path B's plane")
    finally:
        dist.destroy_process_group()
    h3_counts = dict(ops.LAUNCHES)
    add_counts(h3_counts)
    out["H3"] = {"group": group, "world_size": 1,
                 "mesh": mesh.shape, "lanes": [str(d_) for d_ in mesh.flat],
                 "build_cache": preflight, "n_ok": int(n_all),
                 "launches": h3_counts, "equal_to_path_b": True,
                 "path_s": time.perf_counter() - t_h3}
    print(json.dumps({"build_cache_preflight": preflight}))

    # --- H4: where a node process's host time goes ------------------------
    t_h4 = time.perf_counter()
    from plenum_tpu_torch.tools import micro_costs, perf_budget
    budget = perf_budget.run_budget(4, H4_TXNS)
    if "error" in budget:
        raise AssertionError(f"path H4: {budget['error']}")
    pool = budget["pool"]
    if pool["txns_ordered"] != pool["txns_requested"]:
        raise AssertionError(f"path H4: the profiled pool ordered "
                             f"{pool['txns_ordered']} of "
                             f"{pool['txns_requested']}")
    shutil.rmtree(budget["profile_dir"], ignore_errors=True)
    costs = micro_costs.run(4, H4_TXNS)
    print(json.dumps({"perf_budget": {k_: budget[k_] for k_ in (
        "txns", "ncpu", "sum_ms_per_txn", "sum_busy_ms_per_txn",
        "busiest_node", "busiest_ms_per_txn", "wall_ms_per_txn",
        "offloadable_fraction_sum", "offloadable_fraction_busiest",
        "amdahl_ceiling_sum", "amdahl_ceiling_busiest")},
        "pool_tps": pool.get("tps"), "backend": pool.get("backend")}))
    print(json.dumps({"micro_costs": {k_: costs[k_] for k_ in (
        "txns", "wall_ms_per_txn", "categories", "measured_ms_per_txn",
        "residual_ms_per_txn", "offloadable_ms_per_txn",
        "offloadable_fraction_of_wall")}}))
    out["H4"] = {"perf_budget_offloadable_fraction_sum":
                 budget["offloadable_fraction_sum"],
                 "micro_costs_offloadable_fraction_of_wall":
                 costs["offloadable_fraction_of_wall"],
                 "path_s": time.perf_counter() - t_h4}
    shutil.rmtree(work, ignore_errors=True)
    out["launches"] = h_counts
    return out


# the sizes of path I (module docstring); a rehearsal on the CPU patches
# them smaller and I_BACKEND to "torch"
I_BACKEND = "cuda"
I1_WRITES, I1_BAD, I1_READS, I1_RUNS = 1000, 8, 60, 2
I2_TXNS = 120
I5_BATCHES, I5_SHA, I5_DEVICES, I5_SECONDS = "2048,128", 4096, 4, 3.0


def _shard_writes(fab, n: int, n_bad: int, tag: bytes) -> tuple:
    """n trustee-signed NYMs for distinct fresh DIDs, the n_bad of them
    spread evenly through the list signed over other bytes -> (requests,
    the bad ones' req_ids, each valid DID's owning shard)."""
    from plenum_tpu_torch.common.request import Request
    from plenum_tpu_torch.crypto.ed25519 import Ed25519Signer
    from plenum_tpu_torch.execution.txn import NYM
    reqs, bad, owner = [], set(), {}
    step = n // max(1, n_bad)
    for i in range(n):
        user = Ed25519Signer(hashlib.sha256(tag + b"%d" % i).digest())
        req = Request(fab.trustee.identifier, i + 1,
                      {"type": NYM, "dest": user.identifier,
                       "verkey": user.verkey_b58})
        if n_bad and i % step == step // 2 and len(bad) < n_bad:
            req.signature = fab.trustee.sign_b58(b"not this request %d" % i)
            bad.add(req.req_id)
        else:
            req.signature = fab.trustee.sign_b58(req.signing_bytes())
            owner[user.identifier] = fab.router.shard_of(req)
        reqs.append(req)
    return reqs, bad, owner


def _settle_shards(fab, step, limit: float = 20.0) -> None:
    """Drive the fabric (`step()`: one prod cycle, or one sim-time run)
    until every shard's nodes hold domain ledgers of one size: a node
    may apply the last batch a cycle after the first one did."""
    t_end = time.perf_counter() + limit
    while time.perf_counter() < t_end and any(
            len(s.domain_sizes()) != 1 for s in fab.shards.values()):
        step()


def _shard_state(fab) -> dict:
    """Per shard: its nodes' domain, pool and audit roots (equal across
    the shard or the path fails) and the DIDs its first node ordered."""
    from plenum_tpu_torch.execution import txn as txn_lib
    out = {}
    for sid, shard in sorted(fab.shards.items()):
        roots = {name: tuple(node.c.db.get_ledger(lid).root_hash.hex()
                             for lid in (1, 0, 3))
                 for name, node in shard.nodes.items()}
        if len(set(roots.values())) != 1:
            raise AssertionError(f"shard {sid}: its nodes' domain, pool "
                                 f"and audit roots differ: {roots}")
        ledger = shard.nodes[shard.names[0]].c.db.get_ledger(1)
        dests = [txn_lib.txn_data(ledger.get_by_seq_no(i)).get("dest")
                 for i in range(2, ledger.size + 1)]
        out[sid] = {"roots": next(iter(roots.values())), "dests": dests,
                    "size": ledger.size}
    return out


def shard_path(off_card_check, device_window) -> dict:
    """Path I (module docstring): two 4-node shards in one process, each
    pinned to its own lane of a supervised two-lane ring (I1) with its
    `cpu` twin, the reference bench's sharding A/B (I2), the autopilot
    re-pinning a faulted lane's shard (I3, on a ring of two unthreaded
    lanes whose supervisors run on the sim clock), a cross-shard write
    (I4, on a fresh ring from the factory) and the card's tools (I5).
    `device_window()` as in pool_runs."""
    import random

    from plenum_tpu_torch import ops
    from plenum_tpu_torch.common.node_messages import RequestNack
    from plenum_tpu_torch.common.request import Request
    from plenum_tpu_torch.common.timer import QueueTimer
    from plenum_tpu_torch.config import Config
    from plenum_tpu_torch.crypto.ed25519 import (CpuEd25519Verifier,
                                                 Ed25519Signer,
                                                 TorchEd25519Verifier,
                                                 warm_up)
    from plenum_tpu_torch.execution.txn import ATTRIB, GET_NYM, NYM
    from plenum_tpu_torch.parallel.faults import FaultyVerifier
    from plenum_tpu_torch.parallel.pipeline import (MultiDeviceCryptoPipeline,
                                                    make_crypto_pipeline)
    from plenum_tpu_torch.parallel.supervisor import (CLOSED, CircuitBreaker,
                                                      DeadlineBudget,
                                                      SupervisedVerifier)
    from plenum_tpu_torch.shards import ShardedSimFabric
    from plenum_tpu_torch.tools import (bench_configs, control_audit,
                                        gpu_microbench, gpu_probe, multichip)

    lane_type = "cuda" if I_BACKEND == "cuda" else "cpu"
    out: dict = {"backend": I_BACKEND}
    i_counts = {k_: 0 for k_ in ops.LAUNCHES}

    def add_counts(counts: dict) -> None:
        for k_, v in counts.items():
            i_counts[k_] += v

    def fabric_config(backend: str, **over):
        return Config(Max3PCBatchWait=0.05, crypto_backend=backend,
                      STATE_FRESHNESS_UPDATE_INTERVAL=600.0, **over)

    def card_ring(cfg):
        """The supervised two-lane ring, its bucket ladder covering the
        co-hosted nodes' steady state as build_pool's does."""
        per_node = cfg.LISTENER_MESSAGE_QUOTA + cfg.REMOTES_MESSAGE_QUOTA
        bucket = 1
        while bucket < 4 * per_node:
            bucket *= 2
        pipe = make_crypto_pipeline(cfg.replace(PIPELINE_MAX_BUCKET=max(
            bucket, cfg.PIPELINE_MAX_BUCKET)), I_BACKEND, supervised=True)
        if type(pipe) is not MultiDeviceCryptoPipeline or \
                len(pipe.lanes) != 2 or \
                {d_.split(":")[0] for d_ in _lane_devices(pipe)} != \
                {lane_type}:
            raise AssertionError(f"path I: not two {lane_type} lanes: "
                                 f"{type(pipe).__name__} "
                                 f"{_lane_devices(pipe)}")
        return pipe

    def ordered(fab) -> int:
        return sum(s.ordered_count() for s in fab.shards.values())

    def drive(fab, reqs, n_valid: int, timeout: float = 300.0) -> float:
        """Route the writes 256 in flight, prod until n_valid more are
        ordered -> seconds."""
        base = ordered(fab)
        t0 = time.perf_counter()
        i = 0
        while ordered(fab) - base < n_valid and \
                time.perf_counter() < t0 + timeout:
            while i < len(reqs) and i - (ordered(fab) - base) < 256:
                fab.submit_write(reqs[i])
                i += 1
            fab.prod_all()
            if fab.pipeline is not None:
                fab.pipeline.flush()
        return time.perf_counter() - t0

    def i1_run(what: str, backend: str, profiled: bool = False) -> dict:
        """One fabric (a fresh ring on the card, or the `cpu` twin with no
        ring): warm-up, pin, I1_WRITES writes, I1_READS reads."""
        cfg = fabric_config(backend, PIPELINE_DEVICES=2)
        pipe = card_ring(cfg) if backend != "cpu" else None
        fab = ShardedSimFabric(
            n_shards=2, nodes_per_shard=4, seed=11,
            timer=QueueTimer(time.perf_counter), config=cfg,
            pipeline=pipe, latency=(0.00005, 0.0002))
        if pipe is not None:
            if fab.lane_pins != {0: 0, 1: 1}:
                raise AssertionError(f"{what}: shards pinned {fab.lane_pins}")
            for sid, shard in fab.shards.items():
                lanes = {n.c.authenticator.core_authenticator.verifier.lane
                         for n in shard.nodes.values()}
                if lanes != {sid}:
                    raise AssertionError(f"{what}: shard {sid}'s nodes "
                                         f"submit to lanes {lanes}")
        # warm-up: one write a shard end to end, then the ring's pad
        # buckets and cmt ladder, then pin (run_load's contract)
        warm, _, _ = _shard_writes(fab, 16, 0, b"i1-warm-")
        warm_by = {}
        for r_ in warm:
            warm_by.setdefault(fab.router.shard_of(r_), r_)
        drive(fab, list(warm_by.values()), len(warm_by), 120.0)
        if pipe is not None:
            pipe.prewarm(pipe.buckets[:2])
            pipe.prewarm_cmt([1, 2, 4, 8])
            pipe.pin()
            lane0 = [d_["dispatches"] for d_ in pipe.device_state()]
            st0 = dict(pipe.stats)
            rep0 = pipe.inflight_repeats
        reqs, bad, owner = _shard_writes(fab, I1_WRITES, I1_BAD,
                                         b"i1-%s-" % what.encode())
        for sid, shard in fab.shards.items():
            for n in shard.names:
                shard.client_msgs[n].clear()
        sizes0 = {sid: s.ordered_count() for sid, s in fab.shards.items()}
        ops.reset_counts()
        window = device_window() if profiled else None
        t_w = time.perf_counter()
        secs = drive(fab, reqs, len(owner))
        # the NACKs may trail the last ordered batch by a prod or two
        def nacked() -> set:
            return {m.req_id for s in fab.shards.values() for n in s.names
                    for m, _ in s.client_msgs[n]
                    if isinstance(m, RequestNack)}

        t_nack = time.perf_counter() + 10.0
        while time.perf_counter() < t_nack and not bad <= nacked():
            fab.prod_all()
        _settle_shards(fab, fab.prod_all)
        # the share is of the profiler's whole window: the drive, the
        # NACKs' tail and the settling
        window_s = time.perf_counter() - t_w
        busy = window.stop() if window is not None else None
        counts = dict(ops.LAUNCHES)
        state = _shard_state(fab)
        per_shard = {sid: st["size"] - 1 - sizes0[sid]
                     for sid, st in state.items()}
        # every valid write ordered on its owning shard and nowhere else
        for sid, st in state.items():
            want = {d for d, s_ in owner.items() if s_ == sid}
            got = set(st["dests"])
            if not want <= got or len(st["dests"]) != len(set(st["dests"])):
                raise AssertionError(f"{what}: shard {sid} is missing "
                                     f"{len(want - got)} of its writes or "
                                     f"ordered one twice")
            foreign = {d for d in got if d in owner and owner[d] != sid}
            if foreign:
                raise AssertionError(f"{what}: shard {sid} ordered "
                                     f"{len(foreign)} writes it does not "
                                     f"own")
        if sum(per_shard.values()) != len(owner):
            raise AssertionError(f"{what}: {sum(per_shard.values())} "
                                 f"ordered, {len(owner)} valid writes")
        bad_dests = {r_.operation["dest"] for r_ in reqs if r_.req_id in bad}
        if any(d in bad_dests for st in state.values() for d in st["dests"]):
            raise AssertionError(f"{what}: a corrupted write was ordered")
        nacks = nacked()
        if not bad <= nacks:
            raise AssertionError(f"{what}: {len(bad - nacks)} corrupted "
                                 f"writes were not NACKed")
        run = {"seconds": secs, "writes": len(reqs),
               "valid": len(owner), "nacked": len(bad & nacks),
               "tps": len(owner) / secs,
               "per_shard_ordered": per_shard,
               "per_shard_tps": {sid: n_ / secs
                                 for sid, n_ in per_shard.items()},
               "launches": counts}
        if pipe is not None:
            if pipe.stats["unpinned_shapes"] != st0["unpinned_shapes"]:
                raise AssertionError(f"{what}: unpinned shapes")
            lanes = pipe.device_state()
            lane_disp = [d_["dispatches"] - n_ for d_, n_ in
                         zip(lanes, lane0)]
            for k_, lane in enumerate(pipe.lanes):
                off_card_check(f"{what} lane {k_}", lane.inner)
            if min(lane_disp) < 1 or \
                    counts["ed25519_decompress"] != \
                    counts["ed25519_verify"] or \
                    counts["ed25519_verify"] != sum(lane_disp):
                raise AssertionError(
                    f"{what}: K3 {counts['ed25519_decompress']}, K4 "
                    f"{counts['ed25519_verify']} against lane dispatches "
                    f"{lane_disp}")
            submitted = pipe.stats["submitted_items"] - \
                st0["submitted_items"]
            # the ring dedups against its cache and within a wave (ROADMAP
            # C): every dispatch beyond one a signature must repeat one
            # that sat in a wave not yet resolved
            beyond = pipe.stats["dispatched_items"] \
                - st0["dispatched_items"] - len(reqs)
            if beyond != pipe.inflight_repeats - rep0:
                raise AssertionError(
                    f"{what}: {beyond} dispatches beyond one a signature, "
                    f"{pipe.inflight_repeats - rep0} of them repeats of "
                    f"unresolved waves")
            run.update({
                "lane_dispatches_timed": lane_disp,
                "lane_items_timed": [
                    d_["dispatched_items"] for d_ in lanes],
                "lanes": lanes, "lane_devices": _lane_devices(pipe),
                "dedup_ratio": (pipe.stats["dedup_hits"]
                                - st0["dedup_hits"]) / submitted
                if submitted else None,
                "dispatched_beyond_unique_signatures": beyond,
                "inflight_repeats": pipe.inflight_repeats - rep0,
                "pad_items": pipe.stats["pad_items"] - st0["pad_items"]})
            if busy is not None:
                busy_ms, by_name = busy
                run.update({"device_busy_ms": busy_ms,
                            "device_ms_by_name": by_name,
                            "window_s": window_s,
                            "device_busy_share": busy_ms / (window_s * 1e3)
                            if isinstance(busy_ms, float) else busy_ms})
        # cross-shard reads: half of them for DIDs shard 1 owns, read by
        # a client homed on shard 0; each through the composed check
        def pump(seconds):
            t_end = time.perf_counter() + seconds
            while time.perf_counter() < t_end:
                fab.prod_all()
                if fab.pipeline is not None:
                    fab.pipeline.flush()

        driver = fab.read_driver(pump=pump)
        by_shard = {0: [], 1: []}
        for d, s_ in sorted(owner.items()):
            by_shard[s_].append(d)
        keys = {d: r_.operation["verkey"] for r_ in reqs
                for d in (r_.operation["dest"],) if d in owner}
        t_r = time.perf_counter()
        for j in range(I1_READS):
            pool_ = by_shard[1] if j % 2 else by_shard[0]
            dest = pool_[j // 2 % len(pool_)]
            q = Request("i1-reader", j + 1, {"type": GET_NYM, "dest": dest})
            res = driver.read(q, per_node_s=2.0, step_s=0.001)
            if res is None or res["data"]["verkey"] != keys[dest]:
                raise AssertionError(f"{what}: read {j} of {dest} did not "
                                     f"verify: {driver.stats.summary()}")
        s_ = driver.stats.summary()
        if s_["map_proof_failures"] or s_["fallbacks"] or \
                s_["cross_reads"] < I1_READS // 2:
            raise AssertionError(f"{what}: reads {s_}")
        run["reads"] = {"served": I1_READS,
                        "owned_by_the_other_shard": I1_READS // 2,
                        "composed_checks": s_["cross_reads"],
                        "seconds": time.perf_counter() - t_r,
                        "verify_ms_p50": s_.get("verify_ms_p50"),
                        "verify_ms_p95": s_.get("verify_ms_p95")}
        run["roots"] = {sid: st["roots"] for sid, st in state.items()}
        if pipe is not None:
            pipe.close()
        return run

    # --- I1: two shards, each on its own lane, in turns with the twin ----
    t_i = time.perf_counter()
    dev_runs, cpu_runs = [], []
    for i in range(I1_RUNS):       # in turns: drift on the host hits both
        dev_runs.append(i1_run(f"path I1 run {i}", I_BACKEND))
        add_counts(dev_runs[-1]["launches"])
        cpu_runs.append(i1_run(f"path I1 twin {i}", "cpu"))
        if cpu_runs[-1]["launches"]["ed25519_verify"]:
            raise AssertionError("path I1 twin: launched a kernel")
    profiled = i1_run("path I1 under torch.profiler", I_BACKEND,
                      profiled=True)
    med = statistics.median(d_["tps"] for d_ in dev_runs)
    med_cpu = statistics.median(c_["tps"] for c_ in cpu_runs)
    out["I1"] = {"writes": I1_WRITES, "corrupted": I1_BAD,
                 "reads": I1_READS, "runs": dev_runs, "cpu_twin": cpu_runs,
                 "tps_median": med, "cpu_tps_median": med_cpu,
                 "tps_ratio_to_cpu": med / med_cpu,
                 "under_torch_profiler": profiled,
                 "seconds": time.perf_counter() - t_i}

    # --- I2: the reference bench's sharding A/B on the card -------------
    # every pass the bench makes (its warm-up and the three runs of each
    # arm) is checked, not only the median it reports
    t_2 = time.perf_counter()
    ops.reset_counts()
    arm_once = bench_configs._sharded_arm_once
    passes: list = []

    def checked_arm(*args, **kw):
        passes.append(arm_once(*args, **kw))
        return passes[-1]

    bench_configs._sharded_arm_once = checked_arm
    try:
        ab = bench_configs.config10_shards(n_txns=I2_TXNS, backend=I_BACKEND)
    finally:
        bench_configs._sharded_arm_once = arm_once
    add_counts(ops.LAUNCHES)
    if "error" in ab or len(passes) != 10:
        raise AssertionError(f"path I2: {len(passes)} passes, {ab}")
    for j, p_ in enumerate(passes):
        if p_.get("txns_ordered") != p_.get("txns_requested") or \
                p_.get("map_proof_failures") or p_.get("reads_served") != 60:
            raise AssertionError(f"path I2: pass {j} of 10 ({p_.get('shards')}"
                                 f" shards): {p_}")
    out["I2"] = {"n_txns": I2_TXNS,
                 **{k_: {f: ab[k_][f] for f in (
                     "aggregate_tps", "per_shard_tps", "reads_per_s",
                     "cross_shard_served", "cross_verify_ms_p50")}
                    for k_ in ("single_8", "sharded_2x4", "sharded_4x2")},
                 "speedup_2x4": ab["speedup_2x4"],
                 "speedup_4x2": ab["speedup_4x2"],
                 "launches": {k_: ops.LAUNCHES[k_] for k_ in (
                     "ed25519_decompress", "ed25519_verify")},
                 "seconds": time.perf_counter() - t_2}

    # --- I3: the autopilot re-pins a faulted lane's shard ----------------
    t_3 = time.perf_counter()
    ops.reset_counts()
    cfg = fabric_config(I_BACKEND, PIPELINE_DEVICES=2, AUTOPILOT=True,
                        AUTOPILOT_INTERVAL=0.5, AUTOPILOT_SUSTAIN=2,
                        AUTOPILOT_RECOVER_SUSTAIN=3, AUTOPILOT_COOLDOWN=6.0,
                        RESHARD_COOLDOWN=6.0, TELEMETRY_INTERVAL=0.5,
                        SLO_BURN_FAST_WINDOW=2.0, SLO_BURN_SLOW_WINDOW=6.0)
    faulties, sups = [], []
    for k_ in range(2):
        inner = TorchEd25519Verifier(device=lane_type)
        if lane_type == "cuda":
            warm_up(inner)
        faulty = FaultyVerifier(inner, device_index=k_)
        faulties.append(faulty)
        sups.append(SupervisedVerifier(
            faulty, fallback=CpuEd25519Verifier(),
            breaker=CircuitBreaker(fail_threshold=2, cooldown=1.0),
            budget=DeadlineBudget(base=2.0, min_s=1.0, warm_max=5.0,
                                  cold_max=5.0),
            label=f"lane{k_}"))
    pipe3 = MultiDeviceCryptoPipeline(ed_inners=sups, config=cfg,
                                      threaded=False)
    fab3 = ShardedSimFabric(n_shards=2, nodes_per_shard=4, seed=3,
                            config=cfg, pipeline=pipe3)
    for obj in (*sups, *faulties):
        obj.set_clock(fab3.timer.get_current_time)
    ap = fab3.autopilot
    if ap is None or fab3.lane_pins != {0: 0, 1: 1}:
        raise AssertionError(f"path I3: autopilot {ap}, pins "
                             f"{fab3.lane_pins}")
    rnd = random.Random(12)

    def junk(n: int):
        return [(rnd.randbytes(16), rnd.randbytes(63) + b"\x00",
                 rnd.randbytes(32)) for _ in range(n)]

    def write_on(fab, sid: int, tag: bytes, req_id: int):
        for j in range(400):
            u = Ed25519Signer(hashlib.sha256(tag + b"%d" % j).digest())
            req = Request(fab.trustee.identifier, req_id,
                          {"type": NYM, "dest": u.identifier,
                           "verkey": u.verkey_b58})
            if fab.router.shard_of(req) == sid:
                req.signature = fab.trustee.sign_b58(req.signing_bytes())
                return u, req
        raise AssertionError(f"path I: no DID for shard {sid}")

    def order(fab, sid: int, req, limit: float = 30.0) -> None:
        before = fab.shards[sid].ordered_count()
        if fab.submit_write(req) != sid:
            raise AssertionError(f"path I: write routed off shard {sid}")
        waited = 0.0
        while waited < limit and fab.shards[sid].ordered_count() <= before:
            fab.run(0.5)
            waited += 0.5
        if fab.shards[sid].ordered_count() <= before:
            raise AssertionError(f"path I: shard {sid} did not order")

    # both shards order on their own lanes first
    order(fab3, 0, write_on(fab3, 0, b"i3-a", 1)[1])
    order(fab3, 1, write_on(fab3, 1, b"i3-b", 2)[1])
    faulties[0].drop()                 # lane 0's device refuses every wave
    waited = 0.0
    while waited < 40.0 and not any(r_.action == "repin"
                                    for r_ in ap.ledger.records):
        pipe3.verifier(lane=0).verify_batch(junk(3))
        fab3.run(0.5)
        waited += 0.5
    repins = [r_ for r_ in ap.ledger.records if r_.action == "repin"]
    if not repins or fab3.lane_pins[0] != 1 or \
            repins[0].evidence.get("sick_lane") != 0:
        raise AssertionError(f"path I3: no re-pin of shard 0 onto lane 1 "
                             f"(breaker {sups[0].breaker.state}, pins "
                             f"{fab3.lane_pins}, {ap.summary()})")
    repin_sim_s = fab3.timer.get_current_time()
    # shard 0 orders through lane 1 while lane 0 is dark
    lane1_before = pipe3.lanes[1].stats["dispatches"]
    order(fab3, 0, write_on(fab3, 0, b"i3-c", 3)[1])
    lane1_shard0 = pipe3.lanes[1].stats["dispatches"] - lane1_before
    if lane1_shard0 < 1:
        raise AssertionError("path I3: shard 0's write never reached "
                             "lane 1")
    faulties[0].heal()
    waited = 0.0
    while waited < 60.0 and not any(r_.action == "unpin"
                                    for r_ in ap.ledger.records):
        if sups[0].breaker.state != CLOSED:
            pipe3.verifier(lane=0).verify_batch(junk(3))
        fab3.run(0.5)
        waited += 0.5
    unpins = [r_ for r_ in ap.ledger.records if r_.action == "unpin"]
    if not unpins or fab3.lane_pins[0] != 0 or \
            unpins[0].cites != repins[0].seq or \
            unpins[0].t < repins[0].cooldown_until:
        raise AssertionError(f"path I3: shard 0 not un-pinned with a "
                             f"citation ({fab3.lane_pins}, {ap.summary()})")
    records = ap.ledger.to_dicts()
    problems = control_audit.audit_records(records)
    if problems:
        raise AssertionError(f"path I3: the control ledger failed its "
                             f"audit: {problems}")
    off_card_check("path I3 lane 1", sups[1])
    if pipe3.stats["unpinned_shapes"]:
        raise AssertionError("path I3: unpinned shapes")
    lane0 = sups[0].stats
    i3_counts = dict(ops.LAUNCHES)
    add_counts(i3_counts)
    _require_launched_ed("path I3", i3_counts)
    out["I3"] = {
        "repin": repins[0].to_dict(), "unpin": unpins[0].to_dict(),
        "repin_sim_s": repin_sim_s, "records": len(records),
        "actions": [r_["action"] for r_ in records if r_["action"] != "hold"],
        "holds": sum(1 for r_ in records if r_["action"] == "hold"),
        "audit_problems": problems,
        "replay": control_audit.replay(records),
        "lane1_dispatches_for_shard0": lane1_shard0,
        "lane0_supervisor": {k_: lane0[k_] for k_ in (
            "fallback_batches", "device_errors", "open_circuit_fallbacks")},
        "lane0_breaker_opens": sups[0].supervisor_stats()["breaker_opens"],
        "lane_dispatches": [d_["dispatches"] for d_ in
                            pipe3.device_state()],
        "mapping_epoch": fab3.mapping.epoch, "shards": sorted(fab3.shards),
        "launches": i3_counts, "seconds": time.perf_counter() - t_3}

    # --- I4: one atomic cross-shard write on the card fabric -------------
    # a fresh ring from the factory (I1's supervised card lanes) under a
    # fabric with no autopilot (a reshard between the 2PC's begin and its
    # prepare would abort it on a stale epoch, as it must). The 2PC's
    # blocking steps advance the fabric's MockTimer, so the lanes
    # dispatch inline (PIPELINE_LANE_THREADS=False, the config's switch
    # for sims): a threaded lane resolves in real time while sim time
    # runs on, and the prepare's sim-time deadline passes. Each Node puts
    # the ring on the fabric's clock; the lanes' supervisors go back to
    # the wall clock, since the card's waves land in real time (on sim
    # time a wave in flight over a few sim steps reads as a deadline
    # miss and is hedged on the CPU)
    pipe3.close()
    t_4 = time.perf_counter()
    cfg4 = fabric_config(I_BACKEND, PIPELINE_DEVICES=2,
                         PIPELINE_LANE_THREADS=False)
    pipe4 = card_ring(cfg4)
    fab4 = ShardedSimFabric(n_shards=2, nodes_per_shard=4, seed=5,
                            config=cfg4, pipeline=pipe4)
    for lane in pipe4.lanes:
        lane.inner.set_clock(time.monotonic)
    if fab4.lane_pins != {0: 0, 1: 1}:
        raise AssertionError(f"path I4: shards pinned {fab4.lane_pins}")
    pipe4.prewarm(pipe4.buckets[:2])
    pipe4.prewarm_cmt([1, 2, 4, 8])
    pipe4.pin()
    lane4 = [d_["dispatches"] for d_ in pipe4.device_state()]
    ops.reset_counts()
    dep, dep_req = write_on(fab4, 1, b"i4-dep", 1)
    order(fab4, 1, dep_req)
    xsw = fab4.cross_writes()
    home, _ = write_on(fab4, 0, b"i4-home", 9)
    txid = xsw.begin(
        0, 1, {"type": NYM, "dest": home.identifier,
               "verkey": home.verkey_b58},
        {"type": GET_NYM, "dest": dep.identifier},
        {"type": ATTRIB, "dest": dep.identifier,
         "raw": json.dumps({"linked": home.identifier})})
    state_ = xsw.drive(txid)
    recs = xsw._scan_records(0).get(txid, {})
    prep = recs.get("prepare") or {}
    witness_ok = xsw.participant(1)._check_witness(
        prep.get("intent") or {}, prep.get("witness"))
    from plenum_tpu_torch.execution import txn as txn_lib

    def applied(sid: int, kind: str, did: str) -> bool:
        node = fab4.shards[sid].nodes[fab4.shards[sid].names[0]]
        ledger = node.c.db.get_ledger(1)
        return any(txn_lib.txn_type_of(ledger.get_by_seq_no(i)) == kind
                   and txn_lib.txn_data(ledger.get_by_seq_no(i))
                   .get("dest") == did
                   and (kind == NYM or "linked" in (txn_lib.txn_data(
                       ledger.get_by_seq_no(i)).get("raw") or ""))
                   for i in range(2, ledger.size + 1))

    halves = (applied(0, NYM, home.identifier),
              applied(1, ATTRIB, dep.identifier))
    result = (prep.get("witness") or {}).get("result") or {}
    if state_ != "committed" or not all(halves) or \
            witness_ok != (True, "ok") or "read_proof" not in result or \
            "shard_proof" not in result or \
            recs.get("decision", {}).get("decision") != "commit" or \
            xsw.participant(1).locks:
        raise AssertionError(f"path I4: {state_}, halves {halves}, witness "
                             f"{witness_ok}, {xsw.summary()}")
    _settle_shards(fab4, lambda: fab4.run(0.5))
    _shard_state(fab4)                 # each shard's nodes still agree
    i4_counts = dict(ops.LAUNCHES)
    add_counts(i4_counts)
    for k_, lane in enumerate(pipe4.lanes):
        off_card_check(f"path I4 lane {k_}", lane.inner)
    if pipe4.stats["unpinned_shapes"]:
        raise AssertionError("path I4: unpinned shapes")
    lane_disp4 = [d_["dispatches"] - n_ for d_, n_ in
                  zip(pipe4.device_state(), lane4)]
    if min(lane_disp4) < 1 or i4_counts["ed25519_decompress"] != \
            i4_counts["ed25519_verify"] or \
            i4_counts["ed25519_verify"] != sum(lane_disp4):
        raise AssertionError(
            f"path I4: K3 {i4_counts['ed25519_decompress']}, K4 "
            f"{i4_counts['ed25519_verify']} against lane dispatches "
            f"{lane_disp4}")
    out["I4"] = {"txid": txid, "state": state_, "halves_applied": halves,
                 "witness": witness_ok, "summary": xsw.summary(),
                 "lane_dispatches": lane_disp4, "launches": i4_counts,
                 "seconds": time.perf_counter() - t_4}
    pipe4.close()

    # --- I5: the card's tools --------------------------------------------
    t_5 = time.perf_counter()
    probe = gpu_probe.probe_gpu()
    print(json.dumps({"gpu_probe": probe}), flush=True)
    if I_BACKEND == "cuda" and not probe["up"]:
        raise AssertionError(f"path I5: gpu_probe says the card is down: "
                             f"{probe}")
    ops.reset_counts()
    rc = gpu_microbench.main(["--backend", I_BACKEND, "--batches",
                              I5_BATCHES, "--sha-batch", str(I5_SHA),
                              "--skip-probe"])
    add_counts(ops.LAUNCHES)
    if rc != 0:
        raise AssertionError(f"path I5: gpu_microbench exited {rc}")
    row = multichip.run_harness(I5_DEVICES, seconds=I5_SECONDS,
                                timeout=600.0, backend=I_BACKEND)
    print(json.dumps({"multichip": row}), flush=True)
    # the tool re-runs a failed first attempt after a rebuild, for its
    # operators; here the kernels were just built from this checkout, so
    # a retry can only hide a fault of the first attempt
    source = "cuda" if I_BACKEND == "cuda" else "torch-cpu"
    if not row["ok"] or row["n_devices"] != I5_DEVICES or \
            len(row["per_device_dispatches"]) != I5_DEVICES or \
            row.get("torch_source") != source or "first_attempt" in row:
        raise AssertionError(f"path I5: multichip (first attempt "
                             f"{row.get('first_attempt')}): {row}")
    out["I5"] = {"gpu_probe_up": probe["up"],
                 "multichip_torch_source": row["torch_source"],
                 "multichip_items_per_s": row["flood_items_per_s"],
                 "seconds": time.perf_counter() - t_5}
    out["launches"] = i_counts
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from plenum_tpu_torch import graft_entry, ops
    from plenum_tpu_torch.common import serialization
    from plenum_tpu_torch.common.request import Request
    from plenum_tpu_torch.common.serialization import pack
    from plenum_tpu_torch.config import Config
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
    from plenum_tpu_torch.ops import field_chain as fc
    from plenum_tpu_torch.ops.field_chain import field_chain, field_chain_torch
    from plenum_tpu_torch.parallel.crypto_plane import (
        ShardedCryptoPlane, ShardedTorchEd25519Verifier)
    from plenum_tpu_torch.parallel.commit_wave import CommitWave
    from plenum_tpu_torch.parallel.mesh import lane_roster, make_mesh
    from plenum_tpu_torch.parallel.pipeline import make_crypto_pipeline
    from plenum_tpu_torch.parallel.supervisor import find_supervisor
    from plenum_tpu_torch.utils.base58 import b58decode, b58encode

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    print(json.dumps({"python": sys.version.split()[0], "torch": torch.__version__,
                      "cuda": torch.version.cuda,
                      "gpu": torch.cuda.get_device_name(0),
                      "msgpack_codec": serialization.CODEC}))

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

    def require_nothing_off_card(path: str, verifier) -> None:
        """Fail unless the plane supervisor routed nothing of the path
        away from the card: no CPU fallback, hedge, device error or
        deadline miss, no verdict fork, the breaker closed."""
        sup = find_supervisor(verifier)
        if sup is None:
            raise AssertionError(f"{path}: no plane supervisor in the chain")
        hidden = {k_: sup.stats[k_] for k_ in (
            "fallback_batches", "hedge_wins", "open_circuit_fallbacks",
            "backpressure_fallbacks", "device_errors", "deadline_misses",
            "verdict_forks") if sup.stats[k_]}
        if hidden or sup.breaker.state != "closed":
            raise AssertionError(f"{path}: the supervisor routed work off "
                                 f"the card: {hidden}, breaker "
                                 f"{sup.breaker.state}")

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

    def signed_batch(first_id: int):
        """n_req NYM requests, one from each DID, req_ids from first_id,
        8 of them corrupted -> (requests, expected verdicts)."""
        reqs = [nym_request(s, first_id + i) for i, s in enumerate(signers)]
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
                r.signature = signers[(i + 1) % n_req].sign_b58(
                    r.signing_bytes())
            else:           # S >= L
                sig = b58decode(r.signature)
                r.signature = b58encode(sig[:32]
                                        + (ed.L + 7).to_bytes(32, "little"))
            expect[i] = False
        return reqs, expect

    reqs, expect = signed_batch(1)
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

    # K2: k_sha256_interior on 1,024 pairs, and the wave at N = 2 ... 262,144
    # under five offset patterns: one k_merkle_wave launch up to 1,024
    # leaves, one k_merkle_wave_tiled launch beyond
    def rand_words(n):
        return torch.from_numpy(rng.integers(-2**31, 2**31, size=(n, 8),
                                             dtype=np.int64).astype(np.int32)).to(dev)
    left, right = rand_words(1024), rand_words(1024)
    bit_equal("sha256_interior", sha.hash_interior(left, right),
              sha.hash_interior_torch(left, right))
    # the interior hash at ragged widths (a lone group, a partial warp, a
    # tail block past 1,024 and 2,048 pairs), by both forms: the two
    # tensors as they are, and a level's shifted pairing under both
    # offsets; every block size, one launch a call
    interior_tpb = sha.INTERIOR_THREADS_PER_BLOCK
    bound_row = rand_words(1)[0]
    for n_e in (1, 3, 31, 33, 1025, 2049):
        l_e, r_e, cur_e = rand_words(n_e), rand_words(n_e), rand_words(2 * n_e)
        want_pairs = sha.hash_interior_torch(l_e, r_e)
        want_level = {}
        for o in (0, 1):
            sh_ = torch.cat([bound_row[None], cur_e])[1 - o:][:2 * n_e]
            want_level[o] = sha.hash_interior_torch(sh_[0::2], sh_[1::2])
        for tpb in (32, 64, 128):
            sha.INTERIOR_THREADS_PER_BLOCK = tpb
            before = ops.LAUNCHES["sha256_interior"]
            bit_equal("sha256_interior", sha.hash_interior(l_e, r_e),
                      want_pairs)
            for o in (0, 1):
                out_e = torch.empty_like(l_e)
                sha._merkle_level(cur_e, bound_row, torch.tensor(
                    [o], dtype=torch.int32, device=dev), out_e)
                bit_equal("sha256_interior", out_e, want_level[o])
            if ops.LAUNCHES["sha256_interior"] != before + 3:
                raise AssertionError("sha256_interior: not one launch "
                                     "a call")
    sha.INTERIOR_THREADS_PER_BLOCK = interior_tpb
    # one call is one kernel on the card: no copy beside it
    traced = kernels_traced(lambda: sha.hash_interior(left, right))
    if len(traced) != 1 or "k_sha256_interior" not in traced[0]:
        raise AssertionError(f"hash_interior: want one kernel a call, "
                             f"traced {traced}")
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
    # bare verifiers for the kernel checks: they stage and poke internals
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
    # K8 at ragged widths (a lone group, a partial warp, a tail block past
    # 1,024 and 2,048 columns) and k = 0, 1, 254, at every geometry: one
    # and four lanes a column, 32, 64 and 128 threads a block
    k8_geometries = [(g_, b_) for g_ in (1, 4) for b_ in (32, 64, 128)]
    for n_e in (1, 3, 31, 33, 1025, 2049):
        x_e = torch.from_numpy(np.ascontiguousarray(np.stack(
            [ed.int_to_limbs(int.from_bytes(rng.bytes(32), "little") % ed.P)
             for _ in range(n_e)]).T)).to(dev)
        for k_e in (0, 1, 254):
            want_e = field_chain_torch(x_e, k_e)
            for g_, b_ in k8_geometries:
                before = ops.LAUNCHES["field_chain"]
                bit_equal("field_chain", field_chain(x_e, k_e, g_, b_), want_e)
                if ops.LAUNCHES["field_chain"] != before + 1:
                    raise AssertionError("field_chain: not one launch a call")
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
    # min_batch pairs (2,048, then 1,024: two k_sha256_interior launches)
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
    # append one K1 and two k_sha256_interior launches
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
    # bare: the path switches its dispatch and reads its key cache
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
        if step == "step_bytes":        # path H3 feeds this batch again
            h3_plane = ([a_.cpu().numpy() for a_ in args],
                        ok_g.cpu().numpy(), root_g.cpu().numpy())
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

    # --- path D: the device ring, four co-hosted replicas (slice 6) -------
    # the reference pool's crypto wiring (node/bootstrap.py): one ring, its
    # verifier behind every replica's CoreAuthNr and its tree hasher behind
    # every replica's domain ledger; staged leaves drained by one commit
    # wave per batch
    def batch_device(fn):
        """fn() under torch.profiler (CUDA activity only) -> (its result,
        wall ms, device busy ms, device ms by name); the busy time is a
        string saying why where the profiler cannot trace the card."""
        window = DeviceWindow()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        busy, names = window.stop()
        return out, wall, busy, names

    n_rep = 4
    ring_cfg = Config(PIPELINE_SHA_MIN_BATCH=512)

    def ring_setup(backend: str, ledgers=None):
        """The ring, four replicas' authenticators and domain ledgers (from
        the 100,003-txn rows, or continuing `ledgers`' stores)."""
        # supervised, as the reference pool wires its ring; opted into on
        # the card, so every counter of the supervisor is checked below
        pipe = make_crypto_pipeline(ring_cfg, backend, supervised=True)
        authns = []
        for _ in range(n_rep):
            a = ReqAuthenticator()
            a.register_authenticator(CoreAuthNr(verifier=pipe.verifier(),
                                                get_verkey=verkeys.get))
            authns.append(a)
        if ledgers is None:
            leds = [ledger_from_rows(txn_rows, hash_rows, pipe.tree_hasher())
                    for _ in range(n_rep)]
        else:
            leds = [Ledger(tree=CompactMerkleTree(pipe.tree_hasher(),
                                                  led.tree.hash_store),
                           txn_log=led.txn_log) for led in ledgers]
        return pipe, authns, leds

    def ring_batch(pipe, authns, leds, breqs):
        """One batch on the four replicas: authenticate, stage with
        deferred hashing, one commit wave over the four ledgers, commit.
        -> (verdicts per replica, txns, the wave's roots, merkle infos,
        host ms per phase)."""
        t = [time.perf_counter()]
        verdicts_r = [a.authenticate_batch(breqs) for a in authns]
        btxns = [new_txn(NYM, dict(r.operation), request=r)
                 for r, ok in zip(breqs, verdicts_r[0]) if ok]
        t.append(time.perf_counter())
        for led in leds:
            led.append_txns_to_uncommitted(btxns, defer_hash=True)
        wave = CommitWave(pipe)
        for j, led in enumerate(leds):
            wave.add(f"domain{j}", led.uncommitted_root_staged())
        roots_w = wave.run()
        t.append(time.perf_counter())
        infos_r = [led.commit_txns(len(btxns))[1] for led in leds]
        t.append(time.perf_counter())
        return verdicts_r, btxns, roots_w, infos_r, phase_ms(t)

    def phase_ms(t) -> dict:
        return {ph: (b_ - a_) * 1e3 for ph, a_, b_ in zip(
            ("authenticate", "stage_and_root", "commit"), t, t[1:])}

    def solo_batch(authns, leds, breqs):
        """The same batch on four replicas that share nothing: slice 1's
        path on each (its own bare verifier and device tree
        hasher, eager staging) -> as ring_batch, the roots per replica."""
        t = [time.perf_counter()]
        verdicts_r = [a.authenticate_batch(breqs) for a in authns]
        btxns = [new_txn(NYM, dict(r.operation), request=r)
                 for r, ok in zip(breqs, verdicts_r[0]) if ok]
        t.append(time.perf_counter())
        roots = {f"domain{j}": led.append_txns_to_uncommitted(btxns)[0]
                 for j, led in enumerate(leds)}
        t.append(time.perf_counter())
        infos_r = [led.commit_txns(len(btxns))[1] for led in leds]
        t.append(time.perf_counter())
        return verdicts_r, btxns, roots, infos_r, phase_ms(t)

    def ring_check(what, pipe, leds, ring_ref, bexpect, out, before):
        """The per-batch checks: verdicts, roots against each other and
        hashlib's, a proof per replica, one wave, the dedup, no unpinned
        shape, nothing routed off the card."""
        verdicts_r, btxns, roots_w, infos_r, _ = out
        for v in verdicts_r:
            if v.tolist() != bexpect.tolist():
                raise AssertionError(f"{what}: a replica's verdicts differ "
                                     f"from the expected ones")
        ring_ref.append_batch(btxns)
        roots = {led.root_hash for led in leds} | set(roots_w.values())
        if roots != {ring_ref.root_hash} or \
                {led.size for led in leds} != {ring_ref.size}:
            raise AssertionError(f"{what}: the replicas' roots differ from "
                                 f"each other or from the hashlib ledger's")
        for led, infos in zip(leds, infos_r):
            k_ = int(rng.integers(len(btxns)))
            path_ = [bytes.fromhex(h) for h in infos[k_]["auditPath"]]
            if not MerkleVerifier().verify_inclusion(
                    txn_to_leaf(btxns[k_]), infos[k_]["seqNo"] - 1, led.size,
                    path_, led.root_hash):
                raise AssertionError(f"{what}: inclusion proof fails")
        if pipe is None:
            return None
        got = {k_: pipe.stats[k_] - before[k_] for k_ in pipe.stats}
        if got["dispatches"] != 1 or got["dedup_hits"] < 3 * n_req \
                or pipe.stats["unpinned_shapes"] != 0:
            raise AssertionError(
                f"{what}: {got['dispatches']} Ed25519 waves (want 1), "
                f"{got['dedup_hits']} dedup hits (want >= {3 * n_req}), "
                f"{pipe.stats['unpinned_shapes']} unpinned shapes")
        require_nothing_off_card(what, pipe.verifier())
        return got

    def ring_warm(pipe, authns, leds, ring_ref, first_id):
        """Prewarm the batch's bucket (dummy lanes: every verdict False),
        run one unmeasured batch, which notes the shapes the prewarm does
        not (the full key table, the SHA-256 block counts, the commit
        level, the fused wave), then pin."""
        if pipe.prewarm([1024]) != [1024]:
            raise AssertionError("ring prewarm did not warm bucket 1024")
        wreqs, wexpect = signed_batch(first_id)
        before = dict(pipe.stats)
        ring_check("ring warm-up", pipe, leds, ring_ref, wexpect,
                   ring_batch(pipe, authns, leds, wreqs), before)
        pipe.pin()

    # the prewarm's dummy lanes: K3 + K4 give False, as the plain versions
    dummy = [(b"pipeline-prewarm", b"\x00" * 64, b"\x00" * 32)] * 4
    _, (s_d, h_d, k_d, ix_d, r_d) = verifier.stage_bytes(dummy)
    ok_d = ed.verify_kernel_bytes(s_d, h_d, k_d, ix_d, r_d)
    bit_equal("ed25519_verify", ok_d, ed.verify_kernel_bytes_torch(
        s_d, h_d, k_d, ix_d, r_d))
    if ok_d.any():
        raise AssertionError("the prewarm's dummy lanes verify on the card")

    t_ring0 = time.perf_counter()
    ring_ref = ledger_from_rows(txn_rows, hash_rows, TreeHasher())
    pipe, authns, leds = ring_setup("cuda")
    ring_warm(pipe, authns, leds, ring_ref, 10_001)
    ring_setup_s = time.perf_counter() - t_ring0
    ring_batches = []
    ops.reset_counts()
    torch.cuda.synchronize()
    for b in range(5):
        breqs, bexpect = signed_batch(20_001 + 1000 * b)
        before, counts0 = dict(pipe.stats), dict(ops.LAUNCHES)
        out, wall, busy, by_name = batch_device(
            lambda: ring_batch(pipe, authns, leds, breqs))
        counts = {k_: ops.LAUNCHES[k_] - counts0[k_] for k_ in ops.LAUNCHES}
        got = ring_check(f"ring batch {b}", pipe, leds, ring_ref, bexpect,
                         out, before)
        if b == 0:          # path H1 runs this batch on four lanes
            h1_ring = (breqs, out[0][0].copy(), verkeys.get)
        # K3 + K4 once for the four replicas' wave; K1 once per SHA-256
        # block count of the batch's leaves for the commit wave's one
        # deduped level and once for the first replica's commit (the other
        # three hit the ring's digest cache); one k_merkle_wave per
        # replica for the wave's shadow and one for its commit
        groups = len({sha.n_blocks_for(len(txn_to_leaf(t)) + 1)
                      for t in out[1]})
        want = {k_: 0 for k_ in ops.LAUNCHES}
        want.update(ed25519_decompress=1, ed25519_verify=1,
                    sha256_words=2 * groups, merkle_wave=2 * n_rep)
        if counts != want:
            raise AssertionError(f"ring batch {b}: launches {counts}, "
                                 f"want {want}")
        ring_batches.append({
            "wall_ms_4_replicas": wall, "host_ms_by_phase": out[4],
            "device_busy_ms": busy,
            "device_ms_by_name": by_name, "launches": counts,
            "ed_dispatches": got["dispatches"],
            "dedup_hits": got["dedup_hits"],
            "dedup_ratio": got["dedup_hits"] / got["submitted_items"],
            "cache_hits": got["cache_hits"],
            "wave_items": got["dispatched_items"], "pad_items": got["pad_items"],
            "pad_share": got["pad_items"] / (got["dispatched_items"]
                                             + got["pad_items"]),
            "sha_unique": got["sha_unique"], "cmt_unique": got["cmt_unique"],
            "accepted": int(bexpect.sum())})
    ring_counts = dict(ops.LAUNCHES)
    require_launched("ring", ring_counts,
                     ("sha256_words", "merkle_wave", "ed25519_decompress",
                      "ed25519_verify"))
    # where a ring batch's host time goes: one more batch under cProfile
    # (which slows every Python call, so read shares, not times)
    breqs, bexpect = signed_batch(25_001)
    before = dict(pipe.stats)
    host_prof = cProfile.Profile()
    out = host_prof.runcall(ring_batch, pipe, authns, leds, breqs)
    ring_check("ring batch under cProfile", pipe, leds, ring_ref, bexpect,
               out, before)
    host_profile_d = host_profile(host_prof)
    ring_summary = pipe.summary()
    ring_sup = find_supervisor(pipe.verifier()).supervisor_stats()
    # the same four replicas sharing nothing, from the same ledger state
    # (what the ring's dedup saves): K3 + K4 and slice 1's SHA-256
    # launches once per replica
    solo_authns, solo_leds = [], []
    for _ in range(n_rep):
        a = ReqAuthenticator()
        a.register_authenticator(CoreAuthNr(verifier=make_verifier("cuda"),
                                            get_verkey=verkeys.get))
        solo_authns.append(a)
        solo_leds.append(ledger_from_rows(
            txn_rows, hash_rows,
            make_tree_hasher("cuda", min_batch=512, fuse_min=512)))
    solo_ref = ledger_from_rows(txn_rows, hash_rows, TreeHasher())
    solo_batches = []
    ops.reset_counts()
    for b in range(5):
        breqs, bexpect = signed_batch(20_001 + 1000 * b)
        counts0 = dict(ops.LAUNCHES)
        out, wall, busy, _ = batch_device(
            lambda: solo_batch(solo_authns, solo_leds, breqs))
        counts = {k_: ops.LAUNCHES[k_] - counts0[k_] for k_ in ops.LAUNCHES}
        ring_check(f"solo batch {b}", None, solo_leds, solo_ref, bexpect,
                   out, None)
        groups = len({sha.n_blocks_for(len(txn_to_leaf(t)) + 1)
                      for t in out[1]})
        want = {k_: 0 for k_ in ops.LAUNCHES}
        want.update(ed25519_decompress=n_rep, ed25519_verify=n_rep,
                    sha256_words=2 * groups * n_rep, merkle_wave=2 * n_rep)
        if counts != want:
            raise AssertionError(f"solo batch {b}: launches {counts}, "
                                 f"want {want}")
        solo_batches.append({"wall_ms_4_replicas": wall,
                             "host_ms_by_phase": out[4],
                             "device_busy_ms": busy, "launches": counts})
    solo_counts = dict(ops.LAUNCHES)
    # the sharded inner: one more measured batch, the same checks
    t_rs = time.perf_counter()
    pipe_s, authns_s, leds_s = ring_setup("cuda-sharded", leds)
    ring_warm(pipe_s, authns_s, leds_s, ring_ref, 30_001)
    breqs, bexpect = signed_batch(40_001)
    ops.reset_counts()
    before = dict(pipe_s.stats)
    out, wall_s, busy_s, by_name_s = batch_device(
        lambda: ring_batch(pipe_s, authns_s, leds_s, breqs))
    ring_sharded_counts = dict(ops.LAUNCHES)
    got_s = ring_check("ring batch, cuda-sharded", pipe_s, leds_s, ring_ref,
                       bexpect, out, before)
    shards = find_supervisor(pipe_s.verifier())._device._plane.mesh.size
    groups = len({sha.n_blocks_for(len(txn_to_leaf(t)) + 1) for t in out[1]})
    want = {k_: 0 for k_ in ops.LAUNCHES}
    # per shard K3 + K4; K7 only over more than one shard's root (each
    # shard's one zero leaf is its root)
    want.update(ed25519_decompress=shards, ed25519_verify=shards,
                merkle_reduce=int(shards > 1), sha256_words=2 * groups,
                merkle_wave=2 * n_rep)
    if ring_sharded_counts != want:
        raise AssertionError(f"ring batch, cuda-sharded: launches "
                             f"{ring_sharded_counts}, want {want}")
    print(json.dumps({"ring_path": {
        "replicas": n_rep, "requests_per_batch": n_req,
        "ledger_size_before": n_pre, "ledger_size_after": ring_ref.size,
        "sha_min_batch": ring_cfg.PIPELINE_SHA_MIN_BATCH,
        "batches": ring_batches,
        "slice1_single_replica_batch_wall_ms": (t_commit - t_main) * 1e3,
        "launches": ring_counts, "summary": ring_summary,
        "host_profile_one_batch": host_profile_d,
        "four_replicas_without_ring": {"batches": solo_batches,
                                       "launches": solo_counts},
        "supervisor": ring_sup, "setup_s": ring_setup_s,
        "sharded": {"shards": shards, "wall_ms_4_replicas": wall_s,
                    "device_busy_ms": busy_s, "device_ms_by_name": by_name_s,
                    "launches": ring_sharded_counts,
                    "ed_dispatches": got_s["dispatches"],
                    "dedup_ratio": got_s["dedup_hits"]
                    / got_s["submitted_items"],
                    "pad_items": got_s["pad_items"],
                    "setup_s": time.perf_counter() - t_rs}}}))

    # --- path E: the replica's execution layer on the ring (slice 7) -----
    t_e = time.perf_counter()
    # the 100,001-txn domain of paths E and F3, replayed once
    state = replica_state([f"Node{i + 1}" for i in range(4)], PREFILL,
                          np.random.default_rng(20261018))
    replica = replica_path(state, batch_device, require_nothing_off_card)
    replica_counts = replica["launches"]
    require_launched("replica", replica_counts,
                     ("sha256_words", "merkle_wave", "ed25519_decompress",
                      "ed25519_verify"))
    replica.update({
        "path_s": time.perf_counter() - t_e,
        "path_d_ring_batch_wall_ms": [b_["wall_ms_4_replicas"]
                                      for b_ in ring_batches],
        "path_a_single_replica_batch_wall_ms": (t_commit - t_main) * 1e3})
    print(json.dumps({"replica_path": replica}))

    # --- path F: the 4-node pool on the card (slice 9) --------------------
    # the entry point a user calls (tools/local_pool.run_load, consensus
    # end to end: F1 and F2), then four Nodes on path E's domain (F3)
    t_f = time.perf_counter()
    pool = pool_runs(require_nothing_off_card, DeviceWindow)
    pool["F3"] = production_pool(require_nothing_off_card, batch_device,
                                 state)
    del state
    pool_counts = {k_: sum(r_["launches"][k_] for tag in ("F1", "F2")
                           for r_ in pool[tag]["runs"])
                   + pool["F3"]["launches"][k_] for k_ in ops.LAUNCHES}
    require_launched("pool", pool_counts,
                     ("ed25519_decompress", "ed25519_verify"))
    pool.update({
        "path_s": time.perf_counter() - t_f, "launches": pool_counts,
        "path_e_replica_batch_wall_ms": [
            b_["wall_ms_4_replicas"] for b_ in replica["batches"]]})
    print(json.dumps({"pool_path": pool}))

    # --- path G: the TCP pool, K3 + K4 in one service process (slice 10)
    t_g = time.perf_counter()
    tcp = tcp_pool_path(require_nothing_off_card, DeviceWindow)
    tcp_counts = tcp["launches"]
    require_launched("tcp", tcp_counts,
                     ("ed25519_decompress", "ed25519_verify"))
    tcp["path_s"] = time.perf_counter() - t_g
    print(json.dumps({"tcp_pool_path": tcp}))

    # --- path H: the multi-lane, federated and multi-host rings (slice 11)
    t_h = time.perf_counter()
    ops.reset_counts()
    scale = scale_out_path(require_nothing_off_card,
                           {"ring": h1_ring, "plane": h3_plane}, DeviceWindow)
    scale_counts = scale["launches"]
    require_launched("scale-out", scale_counts,
                     ("ed25519_decompress", "ed25519_verify",
                      "merkle_reduce"))
    scale["path_s"] = time.perf_counter() - t_h
    print(json.dumps({"scale_out_path": scale}))

    # --- path I: shards pinned to their own lanes, the autopilot, the
    # card's tools (slice 12)
    t_i = time.perf_counter()
    ops.reset_counts()
    shard = shard_path(require_nothing_off_card, DeviceWindow)
    shard_counts = shard["launches"]
    require_launched("shards", shard_counts,
                     ("ed25519_decompress", "ed25519_verify",
                      "sha256_words"))
    shard["path_s"] = time.perf_counter() - t_i
    print(json.dumps({"shard_path": shard}))

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
    # body); K2, K7 and the interior hash per parent: k_interior_yardstick
    # (never launched: the first, one-thread interior hash,
    # k_merkle_level, which has no loop)
    sass_k1 = sass_profile(lib_paths["sha256"], "k_sha256_words")
    sass_k2 = sass_profile(lib_paths["sha256"], "k_interior_yardstick")
    if sass_k2["body"]["all"] or not sass_k1["body"]["all"]:
        raise AssertionError("SHA-256 SASS: want a loop (the blocks) in "
                             "k_sha256_words and none in "
                             "k_interior_yardstick")
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
                   "probe": probe_counts, "ring": ring_counts,
                   "ring_sharded": ring_sharded_counts,
                   "replica": replica_counts, "pool": pool_counts,
                   "tcp": tcp_counts, "scale_out": scale_counts,
                   "shards": shard_counts}
    path_of = {"K1": "slice", "K2": "slice", "K2T": "slice", "K2L": "slice",
               "K3": "pool",
               "K4": "pool", "K5": "sharded", "K6": "sharded",
               "K7": "sharded", "K8": "probe"}
    # (threads per item, per block), fixed in csrc/sha256.cu and
    # ed25519.cu, but for K3-K6: a quad per item, block size swept
    fixed_geometry = {"sha256_words": (8, 128), "merkle_wave": (1, 512),
                      "merkle_wave_tiled": (1, 512), "merkle_reduce": (1, 256)}
    # the swept kernels: their settings, the default, (threads per item,
    # per block) of a setting, and the row's call at a setting
    def with_attr(mod, attr, value, fn):
        """fn run with mod.attr set to value, then set back."""
        def run():
            saved = getattr(mod, attr)
            setattr(mod, attr, value)
            try:
                return fn()
            finally:
                setattr(mod, attr, saved)
        return run

    sweeps = {**{kid_: ((32, 64, 128), ed.THREADS_PER_BLOCK,
                        lambda tpb: (ed.THREADS_PER_ITEM, tpb),
                        lambda tpb, fn: with_attr(ed, "THREADS_PER_BLOCK",
                                                  tpb, fn))
                 for kid_ in ("K3", "K4", "K5", "K6")},
              "K2L": ((32, 64, 128), sha.INTERIOR_THREADS_PER_BLOCK,
                      lambda tpb: (sha.INTERIOR_THREADS_PER_ITEM, tpb),
                      lambda tpb, fn: with_attr(
                          sha, "INTERIOR_THREADS_PER_BLOCK", tpb, fn)),
              "K8": (k8_geometries,
                     (fc.THREADS_PER_ITEM, fc.THREADS_PER_BLOCK),
                     lambda cfg: cfg,
                     lambda cfg, fn: lambda: field_chain(chain_x, 64, *cfg))}
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
    one_column = chain_x[:, :1].contiguous()
    chain_of = {"sha256_words": lambda levels: device_ms(
                    lambda: sha.sha256_words(one_message)),
                "merkle_wave": lambda levels: chain_floor(wave_sweep, levels),
                "merkle_wave_tiled": lambda levels: chain_floor(wave_sweep,
                                                                levels),
                "sha256_interior": lambda levels: device_ms(
                    lambda: sha.hash_interior(left[:1], right[:1])),
                "field_chain": lambda levels: device_ms(
                    lambda: field_chain(one_column, 64)),
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

    def sweep(run_at, configs, default):
        """Each setting's result (run_at(cfg)() runs the kernel at cfg)
        held to the default's; per setting the median event time and, in
        turns over the settings, two device times."""
        want = run_at(default)()
        ms, dev_ms = {}, {}
        for cfg in configs:
            if not same(run_at(cfg)(), want):
                raise AssertionError(f"another result at {cfg}")
            ms[str(cfg)] = median_ms(run_at(cfg), 20)
        for _ in range(2):
            for cfg in configs:
                dev_ms.setdefault(str(cfg), []).append(
                    device_ms(run_at(cfg)))
        return ms, dev_ms

    kernels = []
    for kid, name, src, replaces, fn, plain, (b_ms, b_by), shape in rows:
        by_setting = dev_by_setting = None
        if kid in sweeps:
            configs, default, geometry, at = sweeps[kid]
            by_setting, dev_by_setting = sweep(
                lambda cfg, fn=fn: at(cfg, fn), configs, default)
            per_item, per_block = geometry(default)
            ms = by_setting[str(default)]
        else:
            per_item, per_block = fixed_geometry[name]
            ms = median_ms(fn, 20)
        sha_times = {}
        if name in chain_of:
            sha_times = {"device_ms": device_ms(fn), "chain_floor_ms":
                         chain_of[name](shape.get("levels", 1))}
        kernels.append({
            "id": kid, "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": path_counts[path_of[kid]][name],
            "max_abs_err": max_err[name],
            "ms": ms,
            "plain_ms": median_ms(plain, 3, warm=1),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "threads_per_item": per_item, "threads_per_block": per_block,
            "ms_by_setting": by_setting,
            "device_ms_by_setting": dev_by_setting,
            "path": path_of[kid],
            "launches_by_path": {p_: c_[name] for p_, c_ in path_counts.items()},
            "launches_per_1000_txn_batch": batch_counts[name],
            "launches_per_ring_batch": ring_batches[0]["launches"][name],
            "launches_per_replica_batch":
                replica["batches"][0]["launches"][name],
            "launches_per_pool_f1_run":
                pool["F1"]["runs"][0]["launches"][name],
            "launches_per_pool_f3_batch":
                pool["F3"]["batches"][0]["launches"][name],
            "launches_per_tcp_g1_run":
                tcp["G1"]["runs"][0]["launches"][name],
            "launches_per_multilane_h1_run":
                scale["H1"]["runs"][0]["launches"][name],
            "launches_h2_local_lane": scale["H2"]["launches_local_lane"][name],
            "launches_per_shard_i1_run":
                shard["I1"]["runs"][0]["launches"][name],
            "launches_h2_remote_service_k3_k4":
                scale["H2"]["service_dispatches_remote_k3_k4"]
                if name in ("ed25519_decompress", "ed25519_verify") else None,
            "shape": shape,
            **sha_times})
    by_id = {k_["id"]: k_ for k_ in kernels}
    # the inversion's share of K4: 254 squarings in lock-step on each of
    # K4's 4 x N threads, timed as K8 over 4 N columns on K4's geometry
    # (one thread a column, K4's block size); beside it the same chain on
    # K8's design, what a split inversion would take
    inv_x = chain_x.repeat(1, (4 * n_sigs + 2047) // 2048)[:, :4 * n_sigs] \
        .contiguous()
    k4_geometry = (1, ed.THREADS_PER_BLOCK)
    k8_geometry = (fc.THREADS_PER_ITEM, fc.THREADS_PER_BLOCK)
    inv = {}
    for what, geo in (("k4", k4_geometry), ("k8", k8_geometry)):
        call = lambda geo=geo: field_chain(inv_x, 254, *geo)
        inv[what] = {"threads_per_item": geo[0], "threads_per_block": geo[1],
                     "ms": median_ms(call, 20), "device_ms": device_ms(call)}
    print(json.dumps({"inversion_share": {
        "columns": 4 * n_sigs, "squarings": 254,
        "k8_ms": inv["k4"]["ms"], "k4_ms": by_id["K4"]["ms"],
        "share_of_k4": inv["k4"]["ms"] / by_id["K4"]["ms"],
        "on_k4_geometry": inv["k4"], "on_k8_design": inv["k8"],
        "split_share_of_k4": inv["k8"]["ms"] / by_id["K4"]["ms"]}}))
    # K8's chain floor (one column alone, k = 64) on each design, at the
    # default block size
    print(json.dumps({"field_chain_floor_by_threads_per_item": {
        g_: device_ms(lambda g_=g_: field_chain(one_column, 64, g_,
                                                fc.THREADS_PER_BLOCK))
        for g_ in (1, 4)}}))
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
    # the wave as one k_sha256_interior launch per level (the wave before
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
    sys.exit(device_times() if sys.argv[1:] == ["--device-times"]
             else main())
