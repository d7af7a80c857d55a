"""Batched SHA-256 for the Merkle ledger: CUDA kernels and plain versions.

Counterpart of the JAX package's ops/sha256.py. The hashing is RFC 6962's
(leaf = SHA256(0x00 || data), interior = SHA256(0x01 || left || right)),
done for whole batches per call.

Words travel as int32 tensors holding the uint32 bit patterns (torch has
no uint32 arithmetic on the CPU): messages int32[N, 16*B] of big-endian
words of B padded 64-byte blocks, digests int32[N, 8].

Each public function dispatches on where its tensors lie: CUDA tensors go
to the kernels in csrc/sha256.cu (K1 `sha256_words`; K2 the append wave,
one launch for every level of a wave up to 2^20 leaves, and the interior
hash of one level; K7 the subtree reduce), CPU tensors to the plain
PyTorch version beside it (`*_torch`), which computes in int64 lanes
masked to 32 bits. There is no fallback: a kernel that cannot launch
raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from plenum_tpu_torch import ops

# --- constants (FIPS 180-4) ----------------------------------------------

_K = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2]

_H0 = [0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
       0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19]

_M32 = 0xFFFFFFFF


# --- plain versions (int64 lanes, masked to 32 bits) -----------------------

def _u32(words: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2^32)."""
    return words.to(torch.int64) & _M32


def _i32(vals: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same bit pattern."""
    return ((vals ^ 0x80000000) - 0x80000000).to(torch.int32)


def _sigma(x, r1, r2, r3):
    """rotr(x, r1) ^ rotr(x, r2) ^ rotr(x, r3) for x in [0, 2^32): one
    doubled copy x || x serves all three rotates, masked once."""
    xx = x | (x << 32)
    return ((xx >> r1) ^ (xx >> r2) ^ (xx >> r3)) & _M32


def _small_sigma(x, r1, r2, s):
    """rotr(x, r1) ^ rotr(x, r2) ^ (x >> s), the schedule's sigmas."""
    xx = x | (x << 32)
    return (((xx >> r1) ^ (xx >> r2)) & _M32) ^ (x >> s)


def _compress(state: list, block: list) -> list:
    """One SHA-256 compression over a batch: state and block are lists of
    int64 lanes [N] (8 and 16 of them), values in [0, 2^32)."""
    w = list(block)
    for t in range(16, 64):
        w.append((w[t - 16] + _small_sigma(w[t - 15], 7, 18, 3) + w[t - 7]
                  + _small_sigma(w[t - 2], 17, 19, 10)) & _M32)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        ch = g ^ (e & (f ^ g))
        t1 = h + _sigma(e, 6, 11, 25) + ch + (w[t] + _K[t])
        maj = (a & b) | (c & (a | b))
        h, g, f, e = g, f, e, (d + t1) & _M32
        d, c, b, a = c, b, a, (t1 + _sigma(a, 2, 13, 22) + maj) & _M32
    return [(x + y) & _M32 for x, y in zip(state, (a, b, c, d, e, f, g, h))]


def sha256_words_torch(msgs: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: int32[N, 16*B] padded words -> int32[N, 8]."""
    n, n_words = msgs.shape
    if n_words % 16:
        raise ValueError("messages must be padded to whole 64-byte blocks")
    m = _u32(msgs)
    state = [torch.full((n,), v, dtype=torch.int64, device=msgs.device)
             for v in _H0]
    for blk in range(n_words // 16):
        state = _compress(state, [m[:, 16 * blk + i] for i in range(16)])
    return _i32(torch.stack(state, dim=1))


def _interior_words(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """RFC-6962 interior message 0x01 || l || r, padded: int64[N, 32].
    The 1-byte prefix shifts every word right by 8 bits."""
    cat = torch.cat([_u32(left), _u32(right)], dim=1)     # [N, 16]
    lo8 = (cat & 0xFF) << 24
    prev = torch.cat([torch.full_like(cat[:, :1], 0x01000000),
                      lo8[:, :-1]], dim=1)
    words = prev | (cat >> 8)
    w16 = lo8[:, -1:] | 0x00800000                         # last byte + 0x80
    zeros = torch.zeros_like(cat[:, :14])
    bitlen = torch.full_like(cat[:, :1], 65 * 8)
    return torch.cat([words, w16, zeros, bitlen], dim=1)


def hash_interior_torch(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: int32[N, 8] x int32[N, 8] -> int32[N, 8]."""
    return sha256_words_torch(_i32(_interior_words(left, right)))


def merkle_wave_torch(new0: torch.Tensor, bounds: torch.Tensor,
                      offs: torch.Tensor) -> tuple:
    """Plain version of merkle_wave: one hash_interior per level, the
    level's pairing shifted by one slot where offs[l] is 1."""
    outs = []
    cur = new0
    level = 0
    while cur.shape[0] >= 2:
        cap = cur.shape[0]
        inp = torch.cat([bounds[level:level + 1], cur], dim=0)
        # off=1: pairing starts AT the boundary (slot 0); off=0: skip it
        shifted = torch.where(offs[level] == 1, inp[:cap], inp[1:cap + 1])
        parents = hash_interior_torch(shifted[0::2], shifted[1::2])
        outs.append(parents)
        cur = parents
        level += 1
    return tuple(outs)


def merkle_reduce_pow2_torch(leaf_digests: torch.Tensor) -> torch.Tensor:
    """Plain version of K7: one hash_interior_torch per level."""
    h = leaf_digests
    while h.shape[0] > 1:
        h = hash_interior_torch(h[0::2], h[1::2])
    return h[0]


# --- kernel wrappers (csrc/sha256.cu) --------------------------------------

_CONFIGURED = False
_ARRIVALS: dict = {}
_REDUCE_LEAVES = 512      # leaves one K7 block reduces (csrc/sha256.cu)
WAVE_THREADS = 512        # k_merkle_wave's block: parents of its widest level
TILE_LEVELS = 10          # levels of one k_merkle_wave_tiled tile
TILED_MAX = 2 * WAVE_THREADS << TILE_LEVELS   # its widest wave, 2^20 leaves
# the interior hash (k_sha256_interior) runs each parent on 4 lanes, in
# blocks of INTERIOR_THREADS_PER_BLOCK threads (a multiple of 4, at most
# 128; read at every launch). On the H100 128 threads were the fastest;
# chip_smoke.py times every setting
INTERIOR_THREADS_PER_ITEM = 4
INTERIOR_THREADS_PER_BLOCK = 128


def _lib() -> ctypes.CDLL:
    global _CONFIGURED
    lib = ops.lib("sha256")
    if not _CONFIGURED:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.sha256_words_launch.argtypes = [vp, vp, ci, ci, vp]
        lib.sha256_interior_launch.argtypes = [vp, vp, ci, vp, vp, vp, ci,
                                               ci, vp]
        lib.merkle_wave_launch.argtypes = [vp, vp, vp, vp, ci, ci, vp]
        lib.merkle_wave_tiled_launch.argtypes = [vp, vp, vp, vp, ci, ci, vp,
                                                 vp]
        lib.merkle_reduce_launch.argtypes = [vp, vp, ci, vp]
        for fn in (lib.sha256_words_launch, lib.sha256_interior_launch,
                   lib.merkle_wave_launch, lib.merkle_wave_tiled_launch,
                   lib.merkle_reduce_launch):
            fn.restype = ci
        _CONFIGURED = True
    return lib


def _arrivals(device: torch.device, stream: int) -> torch.Tensor:
    """The arrival counter of k_merkle_wave_tiled on `stream` of the
    device: int32, zeroed once here, set back to 0 by each launch's last
    block. One per (device, stream): launches on
    one stream run in turn, launches on two may overlap."""
    key = (device, stream)
    c = _ARRIVALS.get(key)
    if c is None:
        c = _ARRIVALS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return c


def _check_digests(name: str, *tensors: torch.Tensor) -> None:
    """int32[N, 8] digests, all on one device."""
    for t in tensors:
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != 8:
            raise ValueError(f"{name}: want int32[N, 8] digests, got "
                             f"{t.dtype}{list(t.shape)}")
        if t.device != tensors[0].device:
            raise ValueError(f"{name}: digests on {tensors[0].device} and "
                             f"{t.device}")


def _check_rows(name: str, *tensors: torch.Tensor) -> None:
    """The interior kernel's rows: digests (as _check_digests) on a CUDA
    device, contiguous, each starting on a 16-byte boundary (it loads
    16-byte halves)."""
    _check_digests(name, *tensors)
    ops.require_cuda(name, *tensors)
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: the kernel loads 16-byte halves; rows "
                         f"must start on a 16-byte boundary")


def _interior_launch(left: torch.Tensor, right_ptr: int, stride: int,
                     bound: torch.Tensor | None, off: torch.Tensor | None,
                     out: torch.Tensor) -> torch.Tensor:
    """One k_sha256_interior launch over out's rows (see csrc/sha256.cu)."""
    if out.shape[0]:
        ops.checked(_lib().sha256_interior_launch(
            ops.ptr(left), ctypes.c_void_p(right_ptr), stride,
            None if bound is None else ops.ptr(bound),
            None if off is None else ops.ptr(off), ops.ptr(out),
            out.shape[0], INTERIOR_THREADS_PER_BLOCK,
            ops.stream_handle(out.device)), "sha256_interior")
        ops.count("sha256_interior")
    return out


def _merkle_level(cur: torch.Tensor, bound: torch.Tensor, off: torch.Tensor,
                  out: torch.Tensor) -> torch.Tensor:
    """One interior-hash launch over a level: parent j (of out's rows)
    hashes shifted rows (2j, 2j + 1) of cur, where shifted[k] = bound if
    k - off < 0 else cur[k - off] and off is the 0/1 flag read from device
    memory. cur int32[2 len(out) or more, 8], bound int32[8]."""
    if bound.shape != (8,):
        raise ValueError(f"sha256_interior: want bound int32[8], got "
                         f"{list(bound.shape)}")
    _check_rows("sha256_interior", cur, bound.view(1, 8), out)
    if off.dtype != torch.int32 or off.device != cur.device or \
            not off.numel():
        raise ValueError("sha256_interior: off must be an int32 flag on "
                         "the rows' device")
    if cur.shape[0] < 2 * out.shape[0]:
        raise ValueError(f"sha256_interior: {out.shape[0]} parents need "
                         f"{2 * out.shape[0]} rows, got {cur.shape[0]}")
    return _interior_launch(cur, cur.data_ptr() + 32, 2, bound, off, out)


def _check_words(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.int32 or t.dim() != 2:
        raise ValueError(f"{name}: want int32[N, W] words, got "
                         f"{t.dtype}{list(t.shape)}")


def sha256_words(msgs: torch.Tensor) -> torch.Tensor:
    """SHA-256 of pre-padded messages: int32[N, 16*B] -> int32[N, 8].
    Padding is part of the hash input, so B must be each message's
    standard (minimal) block count. On CUDA tensors: one K1 launch."""
    _check_words(msgs, "sha256_words")
    if not msgs.is_cuda:
        return sha256_words_torch(msgs)
    ops.require_cuda("sha256_words", msgs)
    n, n_words = msgs.shape
    if n_words % 16:
        raise ValueError("messages must be padded to whole 64-byte blocks")
    if msgs.data_ptr() % 16:
        raise ValueError("sha256_words: K1 loads 16-byte chunks; the words "
                         "must start on a 16-byte boundary")
    out = torch.empty((n, 8), dtype=torch.int32, device=msgs.device)
    if n:
        ops.checked(_lib().sha256_words_launch(
            ops.ptr(msgs), ops.ptr(out), n, n_words // 16,
            ops.stream_handle(msgs.device)), "sha256_words")
        ops.count("sha256_words")
    return out


def hash_interior(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Batched interior-node hash: int32[N, 8] x int32[N, 8] -> int32[N, 8].
    On CUDA tensors: one k_sha256_interior launch on the two tensors as
    they are (contiguous, 16-byte aligned)."""
    _check_digests("hash_interior", left, right)
    if left.shape != right.shape:
        raise ValueError(f"hash_interior: {list(left.shape)} lefts, "
                         f"{list(right.shape)} rights")
    if not left.is_cuda:
        return hash_interior_torch(left, right)
    _check_rows("sha256_interior", left, right)
    out = torch.empty_like(left)
    return _interior_launch(left, right.data_ptr(), 1, None, None, out)


@functools.lru_cache(maxsize=None)
def wave_plan(n: int) -> tuple[tuple[str, int, int, int], ...]:
    """The launches of one append wave over n leaves (a power of two):
    (kernel, level, width, row). "wave" is one k_merkle_wave launch (one
    block, up to 2 WAVE_THREADS leaves) and "tiled" one
    k_merkle_wave_tiled launch (tiles, then a top, up to TILED_MAX) for
    every level; `width` is n and `row` 0, the flat output's row where
    the first parent goes. Level l's parents are rows
    [n - n/2^l, n - n/2^(l+1)) of the flat output. A wider wave is
    refused: TorchTreeHasher declines it, and the ledger hashes it level
    by level."""
    if n > TILED_MAX:
        raise ValueError(f"merkle_wave: {n} leaves, more than the "
                         f"{TILED_MAX} one launch takes")
    if n > 2 * WAVE_THREADS:
        return (("tiled", 0, n, 0),)
    return (("wave", 0, n, 0),) if n >= 2 else ()


def wave_base(offs) -> int:
    """The tiled wave's virtual base B = sum_l offs[l] 2^l: level l's
    input node i is absolute node (B >> l) + i of its level."""
    return sum((int(o) & 1) << l for l, o in enumerate(offs))


def tile_blocks(n: int, base: int) -> range:
    """The tiles (blocks) of k_merkle_wave_tiled over n leaves at virtual
    base `base`: n / 2^TILE_LEVELS + 1 of them, the first and last partial
    (csrc/sha256.cu k_merkle_wave_tiled)."""
    first = base >> TILE_LEVELS
    return range(first, first + (n >> TILE_LEVELS) + 1)


def tile_parents(n: int, base: int, q: int, level: int) -> range:
    """Mirror of csrc/sha256.cu tile_parents: the absolute parents (of
    level + 1) that tile q hashes at `level` < TILE_LEVELS, its
    WAVE_THREADS >> level slots intersected with the level's window."""
    s = WAVE_THREADS >> level
    f = base >> (level + 1)
    return range(max(q * s, f), min((q + 1) * s, f + (n >> (level + 1))))


@functools.lru_cache(maxsize=None)
def wave_rows(n: int) -> tuple[tuple[int, int], ...]:
    """Each level's [start, end) rows in the flat output of a wave over n
    leaves: n/2 rows, then n/4, ..., then 1."""
    rows, width = [], n
    while width >= 2:
        rows.append((n - width, n - width // 2))
        width //= 2
    return tuple(rows)


def merkle_wave_flat(new0: torch.Tensor, bounds: torch.Tensor,
                     offs: torch.Tensor) -> torch.Tensor:
    """merkle_wave's levels in one int32[N - 1, 8] tensor, level l at
    rows wave_rows(N)[l]. On CUDA tensors: the launch of wave_plan(N),
    one k_merkle_wave launch up to N = 2 WAVE_THREADS (the 1,024-leaf
    wave of a 1,000-txn batch), one k_merkle_wave_tiled launch up to
    TILED_MAX."""
    _check_words(new0, "merkle_wave")
    n = new0.shape[0]
    if n & (n - 1) or new0.shape[1] != 8:
        raise ValueError(f"merkle_wave: want int32[N, 8] with N a power of "
                         f"two, got {list(new0.shape)}")
    if not new0.is_cuda:
        outs = merkle_wave_torch(new0, bounds, offs)
        return torch.cat(outs) if outs else new0[:0]
    ops.require_cuda("merkle_wave", new0, bounds, offs)
    depth = n.bit_length() - 1
    if offs.dtype != torch.int32 or bounds.dtype != torch.int32:
        raise ValueError("merkle_wave: bounds and offs must be int32")
    if bounds.shape[0] < depth or bounds.shape[1:] != (8,) or \
            offs.shape[0] < depth:
        raise ValueError(f"merkle_wave: want bounds int32[{depth}, 8] and "
                         f"offs int32[{depth}], got {list(bounds.shape)} "
                         f"and {list(offs.shape)}")
    flat = torch.empty((max(n - 1, 0), 8), dtype=torch.int32,
                       device=new0.device)
    lib, stream = _lib(), ops.stream_handle(new0.device)
    for kernel, level, width, row in wave_plan(n):
        if kernel == "tiled":
            ops.checked(lib.merkle_wave_tiled_launch(
                ops.ptr(new0), ops.ptr(bounds), ops.ptr(offs),
                ops.ptr(flat[row:]), width, level,
                ops.ptr(_arrivals(new0.device, stream)), stream),
                "merkle_wave_tiled")
            ops.count("merkle_wave_tiled")
        else:
            ops.checked(lib.merkle_wave_launch(
                ops.ptr(new0), ops.ptr(bounds), ops.ptr(offs),
                ops.ptr(flat[row:]), width, level, stream), "merkle_wave")
            ops.count("merkle_wave")
    return flat


def merkle_wave(new0: torch.Tensor, bounds: torch.Tensor,
                offs: torch.Tensor) -> tuple:
    """ALL interior levels of one append wave.

    new0:   int32[N, 8], the wave's new level-0 digests, N a power of two
            (lanes past the real count compute garbage the host drops).
    bounds: int32[log2 N, 8], per level the OLD left-boundary node the
            wave's first new node pairs with when offs[l] is 1.
    offs:   int32[log2 N], 0/1 per level — values, read on the device, so
            no host sync between levels.
    Returns each level's parents: int32[N/2, 8], ..., int32[1, 8] (on
    CUDA tensors, views into merkle_wave_flat's one output).
    """
    _check_words(new0, "merkle_wave")
    if not new0.is_cuda:
        return merkle_wave_torch(new0, bounds, offs)
    flat = merkle_wave_flat(new0, bounds, offs)
    return torch.split(flat, [b - a for a, b in wave_rows(new0.shape[0])])


def merkle_reduce_pow2(leaf_digests: torch.Tensor) -> torch.Tensor:
    """Root of a complete power-of-two subtree: int32[N, 8] -> int32[8].
    On CUDA tensors K7 reduces every 512-leaf block in one launch, and
    launches again on the block roots while more than one is left: at
    most two launches for N <= 262,144. The plain version hashes one
    level per call."""
    h = leaf_digests
    _check_words(h, "merkle_reduce_pow2")
    n = h.shape[0]
    if n == 0 or n & (n - 1) or h.shape[1] != 8:
        raise ValueError(f"merkle_reduce_pow2: want int32[N, 8] with N a "
                         f"power of two, got {list(h.shape)}")
    if not h.is_cuda:
        return merkle_reduce_pow2_torch(h)
    ops.require_cuda("merkle_reduce", h)
    while h.shape[0] > 1:
        n = h.shape[0]
        out = torch.empty(((n + _REDUCE_LEAVES - 1) // _REDUCE_LEAVES, 8),
                          dtype=torch.int32, device=h.device)
        ops.checked(_lib().merkle_reduce_launch(
            ops.ptr(h), ops.ptr(out), n, ops.stream_handle(h.device)),
            "merkle_reduce")
        ops.count("merkle_reduce")
        h = out
    return h[0]


# --- host-side packing helpers -------------------------------------------

def pad_to_words(data: bytes) -> np.ndarray:
    """Standard SHA-256 padding; returns uint32 big-endian words (1-D)."""
    return np.frombuffer(_padded(data), dtype=">u4").astype(np.uint32)


def _padded(data: bytes) -> bytes:
    length = len(data)
    return (bytes(data) + b"\x80" + b"\x00" * ((55 - length) % 64)
            + (length * 8).to_bytes(8, "big"))


def n_blocks_for(length: int) -> int:
    """Standard (minimal) SHA-256 block count for a message of `length` bytes."""
    return (length + 9 + 63) // 64


def digests_to_bytes(digests) -> list[bytes]:
    """[N, 8] words (numpy uint32 or an int32 tensor) -> 32-byte digests."""
    if isinstance(digests, torch.Tensor):
        digests = digests.cpu().numpy()
    raw = np.asarray(digests).view(np.uint32).astype(">u4").tobytes()
    return [raw[i:i + 32] for i in range(0, len(raw), 32)]


def bytes_to_digests(hashes: Sequence[bytes]) -> np.ndarray:
    """list of 32-byte digests -> uint32[N, 8]."""
    return np.frombuffer(b"".join(hashes), dtype=">u4").astype(np.uint32).reshape(len(hashes), 8)


def to_tensor(words: np.ndarray, device) -> torch.Tensor:
    """uint32 numpy words -> int32 tensor with the same bits, on device."""
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32)).to(device)


def sha256_batch(msgs: Sequence[bytes], prefix: bytes = b"",
                 device=None) -> list[bytes]:
    """Hash a batch of byte strings: one sha256_words call per standard
    block count (padding is part of the hash, so block count can't be
    fudged). `device` None means the card (ops.default_device)."""
    if not msgs:
        return []
    device = ops.resolve_device(device)
    buckets: dict[int, list[int]] = {}
    for i, m in enumerate(msgs):
        buckets.setdefault(n_blocks_for(len(prefix) + len(m)), []).append(i)
    out: list[bytes] = [b""] * len(msgs)
    for nb, idxs in buckets.items():
        raw = b"".join(_padded(prefix + msgs[i]) for i in idxs)
        words = np.frombuffer(raw, dtype=">u4").astype(np.uint32)
        dig = digests_to_bytes(sha256_words(
            to_tensor(words.reshape(len(idxs), nb * 16), device)))
        for j, i in enumerate(idxs):
            out[i] = dig[j]
    return out
