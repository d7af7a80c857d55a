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
@pytest.mark.parametrize("n", [2, 512, 1024, 65536])
def test_merkle_reduce_kernel_matches_plain_version(cuda_device, n):
    """K7: one launch up to 512 leaves, two beyond (to 262,144)."""
    leaves = _words(np.random.default_rng(n), n, 8)
    before = ops.LAUNCHES["merkle_reduce"]
    got = port.merkle_reduce_pow2(port.to_tensor(leaves, cuda_device))
    assert ops.LAUNCHES["merkle_reduce"] - before == (1 if n <= 512 else 2)
    assert torch.equal(got.cpu(), port.merkle_reduce_pow2(_t(leaves)))

