"""The port's SHA-256 ops (plenum_tpu_torch.ops.sha256) against the JAX
package's jitted programs and hashlib.

Inputs are made with numpy from fixed seeds and handed to both packages;
every comparison is exact (digests are integers). The port's side runs
the kernels' plain PyTorch versions on CPU tensors; the kernels themselves
are held against those plain versions on the card (marked `gpu`).
"""
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plenum_tpu.ops import sha256 as ref
from plenum_tpu_torch import ops
from plenum_tpu_torch.ledger.tree_hasher import TorchTreeHasher
from plenum_tpu_torch.ops import sha256 as port


def _words(rng, n, width):
    return rng.integers(0, 2**32, size=(n, width), dtype=np.uint64).astype(np.uint32)


def _t(words):
    return port.to_tensor(words, "cpu")


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("n_blocks", [1, 3])
def test_sha256_words_matches_jax_and_hashlib(n_blocks):
    rng = np.random.default_rng(n_blocks)
    lo, hi = 64 * (n_blocks - 1) - 8, 64 * n_blocks - 9
    msgs = [rng.bytes(int(rng.integers(max(lo, 0), hi + 1))) for _ in range(8)]
    assert {port.n_blocks_for(len(m)) for m in msgs} == {n_blocks}
    words = np.stack([port.pad_to_words(m) for m in msgs])
    assert np.array_equal(words, np.stack([ref.pad_to_words(m) for m in msgs]))
    got = _u32(port.sha256_words(_t(words)))
    assert np.array_equal(got, np.asarray(ref.sha256_words(jnp.asarray(words))))
    assert port.digests_to_bytes(got) == [hashlib.sha256(m).digest() for m in msgs]


def test_hash_interior_matches_jax_and_hashlib():
    rng = np.random.default_rng(7)
    left, right = _words(rng, 8, 8), _words(rng, 8, 8)
    got = _u32(port.hash_interior(_t(left), _t(right)))
    want = np.asarray(ref.hash_interior(jnp.asarray(left), jnp.asarray(right)))
    assert np.array_equal(got, want)
    expect = [hashlib.sha256(b"\x01" + l + r).digest() for l, r in
              zip(port.digests_to_bytes(left), port.digests_to_bytes(right))]
    assert port.digests_to_bytes(got) == expect


_WAVE8 = np.random.default_rng(11)
_NEW8, _BOUNDS8 = _words(_WAVE8, 8, 8), _words(_WAVE8, 3, 8)


@pytest.mark.parametrize("pattern", range(8))
def test_merkle_wave_every_offs_pattern_n8(pattern):
    offs = np.array([(pattern >> l) & 1 for l in range(3)], dtype=np.int32)
    got = port.merkle_wave(_t(_NEW8), _t(_BOUNDS8), torch.from_numpy(offs))
    want = ref.merkle_wave(jnp.asarray(_NEW8), jnp.asarray(_BOUNDS8),
                           jnp.asarray(offs))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert np.array_equal(_u32(g), np.asarray(w))


def test_merkle_wave_n16_matches_jax():
    rng = np.random.default_rng(16)
    new0, bounds = _words(rng, 16, 8), _words(rng, 4, 8)
    offs = np.array([1, 0, 1, 1], dtype=np.int32)
    got = port.merkle_wave(_t(new0), _t(bounds), torch.from_numpy(offs))
    want = ref.merkle_wave(jnp.asarray(new0), jnp.asarray(bounds),
                           jnp.asarray(offs))
    assert [_u32(g).tolist() for g in got] == [np.asarray(w).tolist() for w in want]


_WAVE_BIG = np.random.default_rng(2048)
_NEW_BIG, _BOUNDS_BIG = _words(_WAVE_BIG, 2048, 8), _words(_WAVE_BIG, 11, 8)


def _offs_pattern(kind, depth):
    if kind == "zeros":
        return [0] * depth
    if kind == "ones":
        return [1] * depth
    if kind == "alternating":
        return [l % 2 for l in range(depth)]
    return np.random.default_rng(depth).integers(0, 2, depth).tolist()


@pytest.mark.parametrize("n", [1024, 2048])
@pytest.mark.parametrize("kind", ["zeros", "ones", "alternating", "random"])
def test_merkle_wave_wide_matches_jax(n, kind):
    """The main path's wave (1,024 leaves) and the first wave wider than
    k_merkle_wave's block (2,048), plain version and its flat form
    against the JAX program, under four offset patterns."""
    depth = n.bit_length() - 1
    new0, bounds = _NEW_BIG[:n], _BOUNDS_BIG[:depth]
    offs = np.array(_offs_pattern(kind, depth), dtype=np.int32)
    got = port.merkle_wave_torch(_t(new0), _t(bounds), torch.from_numpy(offs))
    want = ref.merkle_wave(jnp.asarray(new0), jnp.asarray(bounds),
                           jnp.asarray(offs))
    assert len(got) == len(want) == depth
    for g, w in zip(got, want):
        assert np.array_equal(_u32(g), np.asarray(w))
    flat = port.merkle_wave_flat(_t(new0), _t(bounds), torch.from_numpy(offs))
    assert flat.shape == (n - 1, 8)
    for (a, b), w in zip(port.wave_rows(n), want):
        assert np.array_equal(_u32(flat[a:b]), np.asarray(w))


@pytest.mark.parametrize("log_n", range(1, 19))
def test_wave_plan_covers_every_parent_once(log_n):
    """One launch at every N up to 2^20: k_merkle_wave up to 1,024
    leaves, k_merkle_wave_tiled beyond; its parent rows cover the flat
    output's N - 1 rows once."""
    n = 1 << log_n
    plan = port.wave_plan(n)
    assert len(plan) == 1
    kind, level, width, row = plan[0]
    assert kind == ("wave" if n <= 2 * port.WAVE_THREADS else "tiled")
    assert (level, width, row) == (0, n, 0)
    rows = port.wave_rows(n)
    assert len(rows) == log_n and rows[0] == (0, n // 2)
    assert rows[-1] == (n - 2, n - 1)
    assert sum(b - a for a, b in rows) == n - 1
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))


@pytest.mark.parametrize("log_n", range(19, 23))
def test_wave_plan_refuses_beyond_the_tiled_kernel(log_n):
    """Up to TILED_MAX (2^20) one k_merkle_wave_tiled launch; a wider
    wave is refused, and the device tree hasher declines it, so the
    ledger hashes it level by level."""
    n = 1 << log_n
    if n <= port.TILED_MAX:
        assert port.wave_plan(n) == (("tiled", 0, n, 0),)
        return
    with pytest.raises(ValueError, match="one launch"):
        port.wave_plan(n)
    hasher = TorchTreeHasher(min_batch=1024, device="cpu")
    assert hasher.hash_wave_levels([bytes(32)] * n, [None] * log_n,
                                   [0] * log_n, [n >> 1]) is None


@pytest.mark.parametrize("log_n", range(11, 19))
@pytest.mark.parametrize("kind", ["zeros", "ones", "alternating", "random"])
def test_wave_tiles_own_every_parent_once(log_n, kind):
    """The tiled wave's decomposition (ops/sha256.py's mirror of
    csrc/sha256.cu tile_parents): N/1024 + 1 tiles of at most 512
    level-0 parents; at each of the tiles' levels their parent ranges
    cover the level's window once, in order; every child a tile reads is
    its own node of the level below (level 0: a row of new0) or the
    level's bound, and the bound only where offs[l] is 1; the top's input
    is the n/1024 nodes of the tiles' last level."""
    n, depth, tl = 1 << log_n, log_n, port.TILE_LEVELS
    offs = _offs_pattern(kind, depth)
    base = port.wave_base(offs)
    assert base == sum(o << l for l, o in enumerate(offs))
    tiles = port.tile_blocks(n, base)
    assert len(tiles) == n // 1024 + 1 and tiles.start == base >> tl
    for level in range(tl):
        f_in, f_out = base >> level, base >> (level + 1)
        ranges = [port.tile_parents(n, base, q, level) for q in tiles]
        spans = [r for r in ranges if len(r)]
        assert spans[0].start == f_out
        assert spans[-1].stop == f_out + (n >> (level + 1))
        assert all(a.stop == b.start for a, b in zip(spans, spans[1:]))
        for q, r in zip(tiles, ranges):
            s = port.WAVE_THREADS >> level
            assert len(r) <= s
            if not len(r):
                continue
            assert q * s <= r.start and r.stop <= (q + 1) * s
            lo, hi = 2 * r.start, 2 * r.stop          # children [lo, hi)
            if lo == f_in - 1:                        # the bound
                assert offs[level] == 1
                lo += 1
            assert f_in <= lo and hi <= f_in + (n >> level)
            if level:
                own = port.tile_parents(n, base, q, level - 1)
                assert own.start <= lo and hi <= own.stop
    last = [port.tile_parents(n, base, q, tl - 1) for q in tiles]
    assert sum(len(r) for r in last) == n >> tl
    assert all(len(r) <= 1 for r in last)


def _tiled_wave_hashlib(new0, bounds, offs):
    """A wave hashed with hashlib the way k_merkle_wave_tiled splits it:
    each tile from its own nodes (a dict per tile, so a read of another
    tile's node raises KeyError), every parent stored once, then the top
    levels by the reference's pairing. -> per level, its digests."""
    n, tl = len(new0), port.TILE_LEVELS
    base = port.wave_base(offs)
    levels = [[None] * (n >> (level + 1)) for level in range(len(offs))]

    def h(l, r):
        return hashlib.sha256(b"\x01" + l + r).digest()
    for q in port.tile_blocks(n, base):
        own = {}
        for level in range(tl):
            f_in, f_out = base >> level, base >> (level + 1)
            for a in port.tile_parents(n, base, q, level):
                kids = [bounds[level] if c == f_in - 1
                        else new0[c - base] if level == 0
                        else own[level - 1, c] for c in (2 * a, 2 * a + 1)]
                own[level, a] = h(*kids)
                assert levels[level][a - f_out] is None
                levels[level][a - f_out] = own[level, a]
    for level in range(tl, len(offs)):
        cur = levels[level - 1]
        shifted = ([bounds[level]] + cur)[:len(cur)] if offs[level] else cur
        levels[level] = [h(shifted[2 * j], shifted[2 * j + 1])
                         for j in range(len(cur) // 2)]
    return levels


_WAVE_4096 = np.random.default_rng(4096)
_NEW_4096, _BOUNDS_12 = _words(_WAVE_4096, 4096, 8), _words(_WAVE_4096, 12, 8)


@pytest.mark.parametrize("n", [2048, 4096])
@pytest.mark.parametrize("kind", ["zeros", "ones", "alternating", "random"])
def test_tiled_wave_mirror_matches_jax(n, kind):
    """The tile decomposition, hashed with hashlib, against the JAX
    merkle_wave and the plain version, every level bit for bit."""
    depth = n.bit_length() - 1
    new0, bounds = _NEW_4096[:n], _BOUNDS_12[:depth]
    offs = _offs_pattern(kind, depth)
    got = _tiled_wave_hashlib(port.digests_to_bytes(new0),
                              port.digests_to_bytes(bounds), offs)
    offs_np = np.array(offs, dtype=np.int32)
    want = ref.merkle_wave(jnp.asarray(new0), jnp.asarray(bounds),
                           jnp.asarray(offs_np))
    plain = port.merkle_wave_torch(_t(new0), _t(bounds),
                                   torch.from_numpy(offs_np))
    assert len(got) == len(want) == len(plain) == depth
    for g, w, p in zip(got, want, plain):
        assert g == port.digests_to_bytes(np.asarray(w))
        assert np.array_equal(_u32(p), np.asarray(w))


def test_merkle_reduce_pow2_matches_jax_and_host():
    rng = np.random.default_rng(9)
    leaves = _words(rng, 8, 8)
    got = _u32(port.merkle_reduce_pow2(_t(leaves)))
    assert np.array_equal(got, np.asarray(ref.merkle_reduce_pow2(jnp.asarray(leaves))))
    hs = port.digests_to_bytes(leaves)
    while len(hs) > 1:
        hs = [hashlib.sha256(b"\x01" + hs[i] + hs[i + 1]).digest()
              for i in range(0, len(hs), 2)]
    assert port.digests_to_bytes(got[None]) == hs


_REDUCE = _words(np.random.default_rng(1024), 1024, 8)


@pytest.mark.parametrize("n", [1 << k for k in range(11)])
def test_merkle_reduce_pow2_every_size_to_1024(n):
    """N = 1 ... 1,024 against hashlib, and against the JAX program at a
    few sizes (each size is a compile of its own there)."""
    leaves = _REDUCE[:n]
    got = port.merkle_reduce_pow2(_t(leaves))
    assert got.shape == (8,) and got.dtype == torch.int32
    hs = port.digests_to_bytes(leaves)
    while len(hs) > 1:
        hs = [hashlib.sha256(b"\x01" + hs[i] + hs[i + 1]).digest()
              for i in range(0, len(hs), 2)]
    assert port.digests_to_bytes(got[None]) == hs
    if n in (1, 2, 4, 64, 1024):
        want = np.asarray(ref.merkle_reduce_pow2(jnp.asarray(leaves)))
        assert np.array_equal(_u32(got), want)


def test_merkle_reduce_pow2_rejects_other_sizes():
    for n in (0, 3, 6):
        with pytest.raises(ValueError):
            port.merkle_reduce_pow2(_t(_REDUCE[:n]))


def test_host_helpers_match_reference():
    rng = np.random.default_rng(3)
    for n in (0, 1, 55, 56, 63, 64, 119, 120, 300):
        m = rng.bytes(n)
        assert port.n_blocks_for(n) == ref.n_blocks_for(n)
        assert np.array_equal(port.pad_to_words(m), ref.pad_to_words(m))
    hs = [rng.bytes(32) for _ in range(5)]
    assert np.array_equal(port.bytes_to_digests(hs), ref.bytes_to_digests(hs))
    assert port.digests_to_bytes(port.bytes_to_digests(hs)) == hs
    msgs = [rng.bytes(int(rng.integers(0, 200))) for _ in range(12)]
    assert port.sha256_batch(msgs, prefix=b"\x00", device="cpu") == \
        [hashlib.sha256(b"\x00" + m).digest() for m in msgs]


def test_cpu_tensors_take_the_plain_versions():
    """A wrapper given CPU tensors runs the plain version and launches
    nothing: the launch counters stay where they were."""
    before = dict(ops.LAUNCHES)
    rng = np.random.default_rng(5)
    x = _t(_words(rng, 4, 8))
    port.hash_interior(x, x)
    port.sha256_words(_t(_words(rng, 2, 16)))
    port.merkle_wave(x, x[:2], torch.zeros(2, dtype=torch.int32))
    port.merkle_wave_flat(x, x[:2], torch.zeros(2, dtype=torch.int32))
    port.merkle_reduce_pow2(x)
    assert ops.LAUNCHES == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernels_match_plain_versions_on_card(cuda_device):
    rng = np.random.default_rng(21)
    msgs = port.to_tensor(_words(rng, 300, 48), cuda_device)
    assert torch.equal(port.sha256_words(msgs), port.sha256_words_torch(msgs))
    left = port.to_tensor(_words(rng, 256, 8), cuda_device)
    right = port.to_tensor(_words(rng, 256, 8), cuda_device)
    assert torch.equal(port.hash_interior(left, right),
                       port.hash_interior_torch(left, right))
    bounds = port.to_tensor(_words(rng, 8, 8), cuda_device)
    for pattern in (0, 255, 0b10110010):
        offs = torch.tensor([(pattern >> l) & 1 for l in range(8)],
                            dtype=torch.int32, device=cuda_device)
        for g, w in zip(port.merkle_wave(left, bounds, offs),
                        port.merkle_wave_torch(left, bounds, offs)):
            assert torch.equal(g, w)
    assert torch.equal(port.merkle_reduce_pow2(left),
                       port.merkle_reduce_pow2(left.cpu()).to(cuda_device))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2, 512, 1024, 65536, 262144])
def test_merkle_reduce_kernel_matches_plain_version(cuda_device, n):
    """K7: one launch up to 512 leaves, then one more on the block roots
    (two up to 262,144 leaves)."""
    leaves = _words(np.random.default_rng(n), n, 8)
    before = ops.LAUNCHES["merkle_reduce"]
    got = port.merkle_reduce_pow2(port.to_tensor(leaves, cuda_device))
    assert ops.LAUNCHES["merkle_reduce"] - before == (1 if n <= 512 else 2)
    assert torch.equal(got.cpu(), port.merkle_reduce_pow2(_t(leaves)))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2, 32, 1024, 2048, 4096, 65536, 262144])
def test_merkle_wave_kernel_matches_plain_version(cuda_device, n):
    """K2's wave: one k_merkle_wave launch up to 1,024 leaves, one
    k_merkle_wave_tiled launch beyond, no k_merkle_level launch."""
    depth = n.bit_length() - 1
    rng = np.random.default_rng(n)
    new0, bounds = _words(rng, n, 8), _words(rng, depth, 8)
    tiled = n > 2 * port.WAVE_THREADS
    for kind in ("zeros", "ones", "alternating", "random"):
        offs = np.array(_offs_pattern(kind, depth), dtype=np.int32)
        before = dict(ops.LAUNCHES)
        got = port.merkle_wave(port.to_tensor(new0, cuda_device),
                               port.to_tensor(bounds, cuda_device),
                               torch.from_numpy(offs).to(cuda_device))
        assert {k: ops.LAUNCHES[k] - before[k] for k in
                ("merkle_wave", "merkle_wave_tiled", "sha256_interior")} \
            == {"merkle_wave": int(not tiled), "merkle_wave_tiled": int(tiled),
                "sha256_interior": 0}
        want = port.merkle_wave_torch(_t(new0), _t(bounds),
                                      torch.from_numpy(offs))
        assert len(got) == len(want) == depth
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
def test_tiled_waves_back_to_back(cuda_device):
    """The tiled wave's arrival counter on one stream: waves at
    alternating sizes, queued with no synchronize between them, each
    equal to its plain version (a counter left off 0 would elect no last
    block, or the wrong one)."""
    rng = np.random.default_rng(77)
    got, want = [], []
    for n in (65536, 2048, 262144, 1024, 65536):
        depth = n.bit_length() - 1
        leaves, bounds = _words(rng, n, 8), _words(rng, depth, 8)
        offs = rng.integers(0, 2, depth).astype(np.int32)
        got.append(port.merkle_wave_flat(
            port.to_tensor(leaves, cuda_device),
            port.to_tensor(bounds, cuda_device),
            torch.from_numpy(offs).to(cuda_device)))
        want.append(port.merkle_wave_flat(_t(leaves), _t(bounds),
                                          torch.from_numpy(offs)))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 5, 33, 992])
def test_sha256_words_kernel_every_block_count(cuda_device, n):
    """K1 at 1-9 blocks (9 is more than a group of 8 lanes expands in one
    turn), one launch per call, against the plain version and hashlib."""
    rng = np.random.default_rng(n)
    for nb in range(1, 10):
        lo, hi = max(64 * (nb - 1) - 8, 0), 64 * nb - 9
        msgs = [rng.bytes(int(rng.integers(lo, hi + 1))) for _ in range(n)]
        words = np.stack([port.pad_to_words(m) for m in msgs])
        before = ops.LAUNCHES["sha256_words"]
        got = port.sha256_words(port.to_tensor(words, cuda_device))
        assert ops.LAUNCHES["sha256_words"] == before + 1
        assert torch.equal(got.cpu(), port.sha256_words_torch(_t(words)))
        assert port.digests_to_bytes(got) == \
            [hashlib.sha256(m).digest() for m in msgs]
