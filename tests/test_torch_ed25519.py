"""The port's Ed25519 ops and verifier (plenum_tpu_torch) against the JAX
package's host reference: Python-int field and point math,
`decompress` + `ext_quarters`, `pure_python_verify` and
`CpuEd25519Verifier`.

Every comparison is exact: verdicts and canonical integers. Limb layouts
differ between the packages, so field values are compared as integers.
The port's side runs the kernels' plain PyTorch versions on CPU tensors.
Comparisons that make JAX compile its Ed25519 kernels take minutes on a
CPU and are marked `slow`; the CUDA kernels are held against the plain
versions on the card (marked `gpu`).
"""
import numpy as np
import pytest
import torch

from plenum_tpu.crypto.ed25519 import (CpuEd25519Verifier,
                                       Ed25519Signer as RefSigner,
                                       JaxEd25519Verifier)
from plenum_tpu.ops import ed25519 as ref
from plenum_tpu_torch import ops
from plenum_tpu_torch.convert import verifier_cache_from_reference
from plenum_tpu_torch.crypto.ed25519 import (Ed25519Signer,
                                             TorchEd25519Verifier,
                                             make_verifier)
from plenum_tpu_torch.ops import ed25519 as port

P = ref.P


def _fe(values):
    return torch.tensor([port.fe_from_int(v) for v in values], dtype=torch.int64)


def _ints(t):
    return [port.fe_to_int(row) % P for row in t]


def _canon_ints(t):
    return [port.fe_to_int(row) for row in port.fe_canon(t)]


# --- field arithmetic vs Python ints --------------------------------------

_RNG = np.random.default_rng(0)
_XS = [int.from_bytes(_RNG.bytes(32), "little") % P for _ in range(24)] \
    + [0, 1, P - 1, 2**255 - 20]
_YS = [int.from_bytes(_RNG.bytes(32), "little") % P for _ in range(24)] \
    + [P - 1, 0, 1, 19]


@pytest.mark.parametrize("op,pyop", [
    ("fe_add", lambda x, y: x + y),
    ("fe_sub", lambda x, y: x - y),
    ("fe_mul", lambda x, y: x * y),
    ("fe_sq", lambda x, y: x * x),
])
def test_field_ops_match_bigint(op, pyop):
    fn = getattr(port, op)
    got = fn(_fe(_XS)) if op == "fe_sq" else fn(_fe(_XS), _fe(_YS))
    want = [pyop(x, y) % P for x, y in zip(_XS, _YS)]
    assert _ints(got) == want
    assert _canon_ints(got) == want


def test_field_chains_stay_in_bounds_and_exact():
    """Long chains of subtract-then-multiply keep limbs carried: the
    values stay exact, and canonical form is the unique reduced one."""
    f, g = _fe(_XS), _fe(_YS)
    want = list(_XS)
    for _ in range(40):
        f = port.fe_mul(port.fe_sub(f, g), port.fe_sub(g, f))
        want = [(x - y) * (y - x) % P for x, y in zip(want, _YS)]
        assert int(f.abs().max()) < 2**26 + 2**7
    assert _canon_ints(f) == want
    assert _canon_ints(port.fe_inv(_fe(_XS[:24]))) == [pow(x, P - 2, P) for x in _XS[:24]]
    assert _canon_ints(port.fe_pow_p58(_fe(_XS))) == [pow(x, (P - 5) // 8, P) for x in _XS]


def test_bytes_to_fe_takes_low_255_bits():
    rng = np.random.default_rng(4)
    raw = rng.integers(0, 256, size=(16, 32), dtype=np.uint8)
    got = [port.fe_to_int(r) for r in port.bytes_to_fe(torch.from_numpy(raw))]
    assert got == [int.from_bytes(r.tobytes(), "little") & ((1 << 255) - 1)
                   for r in raw]


def _ext_to_affine_ints(x, y, z):
    zi = pow(z % P, P - 2, P)
    return (x * zi % P, y * zi % P)


def test_point_ops_match_reference_ints():
    b = (ref.BX, ref.BY)
    pts = [ref.ext_scalar_mul(k, b) for k in (1, 2, 7, 123456789)]
    ext = tuple(_fe([p[c] if c < 2 else (1 if c == 2 else p[0] * p[1])
                     for p in pts]) for c in range(4))
    dbl = port.pt_double(ext)
    add = port.pt_add(ext, dbl)
    for i, p in enumerate(pts):
        want_dbl = ref.edwards_add(p, p)
        got = _ext_to_affine_ints(*(port.fe_to_int(c[i]) for c in dbl[:3]))
        assert got == want_dbl
        got = _ext_to_affine_ints(*(port.fe_to_int(c[i]) for c in add[:3]))
        assert got == ref.edwards_add(p, want_dbl)


def test_b_comb_table_equals_reference():
    assert np.array_equal(port.b_comb_table(), ref.b_comb_table())
    ports = port.comb_table_limbs()
    for w, d in ((0, 1), (5, 77), (31, 255)):
        for c in range(3):
            assert port.fe_to_int(ports[w, d, c]) == \
                ref.limbs_to_int(ref.b_comb_table()[w, d, 20 * c:20 * (c + 1)])


# --- keys: decompression vs the reference's host twin ----------------------

_GOOD_KEYS = [RefSigner(bytes([i + 40]) * 32).verkey for i in range(3)]
_BAD_KEYS = [
    (P + 1).to_bytes(32, "little"),            # y >= p (non-canonical)
    (P - 1).to_bytes(32, "little"),            # y = p - 1
    bytes(32),                                 # y = 0
    (1 | (1 << 255)).to_bytes(32, "little"),   # y = 1 -> x = 0, sign = 1
    (2).to_bytes(32, "little"),                # y = 2, off curve
    b"\xff" * 32,                              # y >= p with the sign bit
]


def test_decompress_matches_reference_twin():
    keys = _GOOD_KEYS + _BAD_KEYS
    k_u8 = torch.from_numpy(np.frombuffer(b"".join(keys), np.uint8)
                            .reshape(-1, 32).copy())
    quarters, tables, valid = port.decompress_kernel(k_u8)
    assert quarters.shape == (len(keys), 4, 4, 10)
    assert tables.shape == (len(keys), 4, 16, 4, 10)
    for i, kb in enumerate(keys):
        host = ref.decompress(kb)
        assert bool(valid[i]) == (host is not None), kb.hex()
        if host is None:
            continue
        want = ref.ext_quarters(((P - host[0]) % P, host[1]))
        for q in range(4):
            x, y, z, t = (port.fe_to_int(quarters[i, q, c]) for c in range(4))
            wx, wy, wz = (ref.limbs_to_int(want[q, c]) for c in range(3))
            assert _ext_to_affine_ints(x, y, z) == _ext_to_affine_ints(wx, wy, wz)
            assert t % P == x * y * pow(z, P - 2, P) % P
            # window table entry d = [d] quarter, with 2d*T in place of T
            for d in (0, 1, 5, 15):
                ex, ey, ez, et2d = (port.fe_to_int(tables[i, q, d, c])
                                    for c in range(4))
                pt = ref.edwards_mul(d, _ext_to_affine_ints(x, y, z))
                assert _ext_to_affine_ints(ex, ey, ez) == pt
                assert et2d % P == ref.D2 * ex * ey * pow(ez, P - 2, P) % P


# --- verdicts vs pure_python_verify and the cpu backend -------------------

RFC8032_VECTORS = [
    ("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
     "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a",
     "",
     "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
     "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"),
    ("4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
     "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c",
     "72",
     "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
     "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00"),
    ("c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7",
     "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025",
     "af82",
     "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac"
     "18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a"),
]


def _flip(b: bytes, byte: int, bit: int) -> bytes:
    out = bytearray(b)
    out[byte] ^= 1 << bit
    return bytes(out)


def _cases():
    """(case class, [(msg, sig, vk)]) — 4 signers, so keys repeat (U < N)
    and the batch is not a power of two in length."""
    rng = np.random.default_rng(17)
    signers = [RefSigner(bytes([i + 90]) * 32) for i in range(4)]

    def pick(n):
        return int(rng.integers(n))

    def signed(i):
        s = signers[i % 4]
        msg = rng.bytes(pick(81))
        return msg, s.sign(msg), s.verkey

    cases = {"rfc8032": [(bytes.fromhex(m), bytes.fromhex(sg), bytes.fromhex(pk))
                         for _, pk, m, sg in RFC8032_VECTORS],
             "valid": [signed(i) for i in range(6)]}
    corrupt = {"S": [], "R": [], "A": [], "M": []}
    for i in range(3):
        msg, sig, vk = signed(i)
        corrupt["S"].append((msg, _flip(sig, 32 + pick(31), pick(8)), vk))
        corrupt["R"].append((msg, _flip(sig, pick(32), pick(8)), vk))
        corrupt["A"].append((msg, sig, _flip(vk, pick(32), pick(8))))
        corrupt["M"].append((_flip(msg + b"m", pick(len(msg) + 1), pick(8)),
                             sig, vk))
    cases.update({f"bitflip_{k}": v for k, v in corrupt.items()})
    msg, sig, vk = signed(0)
    cases["noncanonical"] = [
        (msg, (P + 3).to_bytes(32, "little") + sig[32:], vk),      # R: y >= p
        (msg, sig[:32] + (ref.L + 1).to_bytes(32, "little"), vk),  # S >= L
        (msg, sig, (P + 1).to_bytes(32, "little")),                # A: y >= p
    ]
    cases["bad_keys"] = [(msg, sig, k) for k in _BAD_KEYS]
    return cases


_CASES = _cases()


@pytest.fixture(scope="module")
def verdicts():
    """One batched verification per backend over every case class."""
    items = [it for group in _CASES.values() for it in group]
    assert len(items) & (len(items) - 1)            # not a power of two
    got = make_verifier("torch").verify_batch(items)
    out, at = {}, 0
    for name, group in _CASES.items():
        out[name] = got[at:at + len(group)].tolist()
        at += len(group)
    return out


@pytest.mark.parametrize("case", sorted(_CASES))
def test_verdicts_match_reference(case, verdicts):
    group = _CASES[case]
    want_py = [ref.pure_python_verify(*it) for it in group]
    want_cpu = CpuEd25519Verifier().verify_batch(group).tolist()
    assert verdicts[case] == want_py == want_cpu
    if case in ("rfc8032", "valid"):
        assert all(verdicts[case])
    else:
        assert not any(verdicts[case])


@pytest.mark.parametrize("case", range(len(RFC8032_VECTORS)))
def test_signer_reproduces_rfc8032(case):
    seed_h, pub_h, msg_h, sig_h = RFC8032_VECTORS[case]
    s = Ed25519Signer(bytes.fromhex(seed_h))
    assert s.verkey == bytes.fromhex(pub_h)
    assert s.sign(bytes.fromhex(msg_h)) == bytes.fromhex(sig_h)
    sig, vk = port.pure_python_sign(bytes.fromhex(seed_h), bytes.fromhex(msg_h))
    assert (sig, vk) == ref.pure_python_sign(bytes.fromhex(seed_h),
                                             bytes.fromhex(msg_h))


def test_malformed_items_are_false_not_raised():
    items = [(b"m", b"short", b"\x00" * 32), (b"m", b"\x00" * 64, b"bad"),
             ("not bytes", b"\x00" * 64, b"\x00" * 32)]
    assert not TorchEd25519Verifier(device="cpu").verify_batch(items).any()
    assert make_verifier("torch").verify_batch([]).shape == (0,)


# --- against the JAX kernels (minutes of XLA compile on a CPU) -------------

@pytest.mark.slow
def test_verdicts_match_jax_verify_kernel_bytes():
    import jax.numpy as jnp
    items = [it for group in _CASES.values() for it in group]
    v = TorchEd25519Verifier(device="cpu")
    idxs, staged = v.stage_bytes(items)
    got = port.verify_kernel_bytes(*staged)
    want = ref.verify_kernel_bytes(*(jnp.asarray(t.numpy()) for t in staged))
    assert got.tolist() == np.asarray(want).tolist()


@pytest.mark.slow
def test_decompress_matches_jax_decompress_kernel():
    import jax.numpy as jnp
    keys = _GOOD_KEYS + _BAD_KEYS
    k_u8 = np.frombuffer(b"".join(keys), np.uint8).reshape(-1, 32).copy()
    quarters, _, valid = port.decompress_kernel(torch.from_numpy(k_u8))
    (qx, qy, qz, qt), want_valid = ref.decompress_kernel(jnp.asarray(k_u8))
    assert valid.tolist() == np.asarray(want_valid).tolist()
    for i in range(len(keys)):
        if not valid[i]:
            continue
        for q in range(4):
            x, y, z = (port.fe_to_int(quarters[i, q, c]) for c in range(3))
            wx, wy, wz = (ref.limbs_to_int(np.asarray(a)[q, i]) for a in (qx, qy, qz))
            assert _ext_to_affine_ints(x, y, z) == _ext_to_affine_ints(wx, wy, wz)


# --- the limb-staged dispatch (K5 + K6) ------------------------------------

def _limb_verifier(**kw):
    v = TorchEd25519Verifier(device="cpu", **kw)
    v._compressed_dispatch = False
    return v


def _dispatch_cases():
    """The cases of the reference's test_bytes_and_limb_dispatch_agree."""
    import random
    rng = random.Random(11)
    signers = [RefSigner(bytes([i + 60]) * 32) for i in range(3)]
    items = []
    for i in range(19):
        s = signers[i % 3]
        msg = rng.randbytes(20)
        sig = s.sign(msg)
        if i % 4 == 0:
            b = bytearray(sig); b[1] ^= 0x55; sig = bytes(b)
        if i % 7 == 0:
            sig = sig[:32] + (ref.L + i).to_bytes(32, "little")  # S >= L
        items.append((msg, sig, s.verkey))
    items.append((b"m", b"\x01" * 64, bytes(32)))      # y=0 verkey
    items.append((b"m", b"\x01" * 64, (P + 2).to_bytes(32, "little")))
    return items


def test_bytes_and_limb_dispatch_agree():
    items = _dispatch_cases()
    got_b = TorchEd25519Verifier(device="cpu").verify_batch(items)
    got_l = _limb_verifier().verify_batch(items)
    cpu = CpuEd25519Verifier().verify_batch(items)
    assert list(got_b) == list(got_l) == list(cpu)
    assert any(cpu) and not all(cpu)


def test_limb_path_caches_staged_keys():
    """The counterpart of the reference's test_verkey_cache_hits, plus the
    cache's FIFO bound, eviction and rewarm."""
    s = Ed25519Signer(b"\x07" * 32)
    items = [(m, s.sign(m), s.verkey) for m in (b"m%d" % i for i in range(8))]
    v = TorchEd25519Verifier(device="cpu")
    assert v.verify_batch(items).all()
    assert len(v._pt_cache) == 0        # the byte path stages no key rows
    lv = _limb_verifier(cache_size=2)
    assert lv.verify_batch(items).all()
    assert list(lv._pt_cache) == [s.verkey]
    a = ref.decompress(s.verkey)
    assert lv._decompress_cached(s.verkey) == a
    assert np.array_equal(lv._pt_cache[s.verkey],
                          ref.ext_quarters(((P - a[0]) % P, a[1])))
    others = [RefSigner(bytes([i + 1]) * 32).verkey for i in range(2)]
    assert lv._decompress_cached(others[0]) is not None
    off_curve = (2).to_bytes(32, "little")
    assert lv._decompress_cached(off_curve) is None        # invalid: None
    assert list(lv._pt_cache) == [others[0], off_curve]    # oldest went
    lv.evict_key(others[0])
    assert list(lv._pt_cache) == [off_curve]
    lv.rewarm()
    assert not lv._pt_cache


def _affine(pt4):
    x, y, z = (port.fe_to_int(c) for c in pt4[:3])
    zi = pow(z % P, P - 2, P)
    return (x * zi % P, y * zi % P)


def test_quarter_tables_hold_decompress_tables_points():
    """K5's plain tables, built from ext_quarters rows, hold the same
    points as K3's plain tables built from the key bytes. Their projective
    Z differ (host doublings vs the kernel's chain), so entries are
    compared affine, mod p; entry 0 is the identity, and the 2d*T slot
    holds 2d x y."""
    keys = _GOOD_KEYS
    k_u8 = torch.from_numpy(np.frombuffer(b"".join(keys), np.uint8)
                            .reshape(-1, 32).copy())
    _, tab3, valid = port.decompress_torch(k_u8)
    assert valid.all()
    rows = []
    for kb in keys:
        x, y = ref.decompress(kb)
        rows.append(ref.ext_quarters(((P - x) % P, y)))
    tab5 = port.quarter_tables(torch.from_numpy(np.stack(rows)))
    assert tab5.shape == tab3.shape and tab5.dtype == torch.int32
    for i in range(len(keys)):
        for q in range(4):
            for d in range(16):
                e3, e5 = tab3[i, q, d], tab5[i, q, d]
                assert _affine(e3) == _affine(e5), (i, q, d)
                x, y = _affine(e5)
                t2d = port.fe_to_int(e5[3]) * pow(port.fe_to_int(e5[2]), P - 2, P)
                assert t2d % P == ref.D2 * x * y % P
            assert _affine(tab5[i, q, 0]) == (0, 1)


def _carried(limbs: np.ndarray, k: int) -> np.ndarray:
    """Another carried representation of the same value mod p: the 13-bit
    limbs of v + k p (k >= 1), then a borrow (limb i - 1 += 2^13, limb i
    -= 1) wherever both limbs stay in [-2, 2^13 + 3]."""
    v = ref.limbs_to_int(limbs) + k * P
    out = np.array([(v >> (13 * i)) & 8191 for i in range(19)]
                   + [v >> (13 * 19)], dtype=np.int64)
    for i in range(1, 20):
        if out[i - 1] <= 3 and out[i] >= -1:
            out[i - 1] += 8192
            out[i] -= 1
    assert ref.limbs_to_int(out) == v and out.min() >= -2 and out.max() <= 8195
    return out.astype(np.int32)


def _staged(items):
    idxs, staged = _limb_verifier().stage_limbs(items)
    return idxs, [torch.from_numpy(np.ascontiguousarray(a)) for a in staged]


def test_limbs13_to_fe_keeps_signs():
    rng = np.random.default_rng(23)
    rows = rng.integers(-2, 8196, size=(64, 20)).astype(np.int32)
    rows[0] = -2
    rows[1] = 8195
    rows[2] = 0
    got = port.limbs13_to_fe(torch.from_numpy(rows))
    assert int(got.abs().max()) < 2**26 + 2**7
    assert [port.fe_to_int(r) % P for r in got] == \
        [ref.limbs_to_int(r) % P for r in rows]
    canon = port.fe_canon(got)
    assert port.fe_to_limbs13(canon).tolist() == \
        [ref.int_to_limbs(ref.limbs_to_int(r) % P).tolist() for r in rows]


def test_carried_quarter_rows_give_the_same_verdicts():
    items = _dispatch_cases()
    idxs, (sd, hd, aq, idx, ry, rs) = _staged(items)
    want = port.verify_kernel_indexed(sd, hd, aq, idx, ry, rs)
    carried = torch.from_numpy(np.stack([
        np.stack([np.stack([_carried(aq[u, q, c].numpy(), 1 + (u + q + c) % 31)
                            for c in range(4)]) for q in range(4)])
        for u in range(aq.shape[0])]))
    assert not torch.equal(carried, aq)
    assert torch.equal(port.verify_kernel_indexed(sd, hd, carried, idx, ry, rs),
                       want)
    # verify_kernel: one row per signature, the same verdicts
    assert torch.equal(port.verify_kernel(sd, hd, carried[idx.long()], ry, rs),
                       want)
    got = np.zeros(len(items), dtype=bool)
    got[idxs] = want.numpy()
    assert got.tolist() == CpuEd25519Verifier().verify_batch(items).tolist()


def test_r_limbs_are_compared_exactly():
    """The reference compares canonical y' with ry limb for limb and never
    reduces ry: an R whose y limbs are borrowed (the same integer) or
    whose sign word is not 0/1 fails; an index out of range fails."""
    items = [it for it in _dispatch_cases() if CpuEd25519Verifier().verify(*it)]
    _, (sd, hd, aq, idx, ry, rs) = _staged(items)
    base = port.verify_kernel_indexed(sd, hd, aq, idx, ry, rs)
    assert base.all()
    ry_b = ry.clone()
    i = int(torch.nonzero(ry_b[0, 1:] >= 1)[0]) + 1    # borrow into limb i-1
    ry_b[0, i - 1] += 8192
    ry_b[0, i] -= 1
    assert ref.limbs_to_int(ry_b[0].numpy()) == ref.limbs_to_int(ry[0].numpy())
    rs_b = rs.clone()
    rs_b[1] += 2
    idx_b = idx.clone()
    idx_b[2] = aq.shape[0]
    idx_b[3] = -1
    got = port.verify_kernel_indexed(sd, hd, aq, idx_b, ry_b, rs_b)
    assert got.tolist() == [False] * 4 + [True] * (len(items) - 4)


def test_verifier_cache_seeded_from_reference(monkeypatch):
    """A reference verifier's staged key rows carried into the port's
    verifier: the limb path then stages no key anew."""
    items = _dispatch_cases()
    ref_v = JaxEd25519Verifier()
    for _, _, vk in items:
        ref_v._neg_a_limbs(vk)
    v = verifier_cache_from_reference(ref_v._pt_cache, _limb_verifier())
    assert list(v._pt_cache) == list(ref_v._pt_cache)
    monkeypatch.setattr(port, "ext_quarters", None)     # would raise if used
    monkeypatch.setattr(port, "decompress", None)
    assert v.verify_batch(items).tolist() == \
        CpuEd25519Verifier().verify_batch(items).tolist()
    small = verifier_cache_from_reference(ref_v._pt_cache,
                                          _limb_verifier(cache_size=2))
    assert list(small._pt_cache) == list(ref_v._pt_cache)[-2:]
    with pytest.raises(ValueError):
        verifier_cache_from_reference({b"k" * 32: np.zeros((4, 4, 10))}, v)


def test_limb_kernels_on_cpu_launch_nothing():
    before = dict(ops.LAUNCHES)
    _, (sd, hd, aq, idx, ry, rs) = _staged(_dispatch_cases()[:3])
    port.verify_kernel_indexed(sd, hd, aq, idx, ry, rs)
    assert ops.LAUNCHES == before


@pytest.mark.slow
def test_limb_kernels_match_jax_verify_kernel():
    """verify_kernel and verify_kernel_indexed against the JAX package's,
    on the same staged numpy arrays."""
    import jax.numpy as jnp
    items = _dispatch_cases()
    _, staged = _limb_verifier().stage_limbs(items)
    sd, hd, aq, idx, ry, rs = staged
    got_i = port.verify_kernel_indexed(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in staged))
    want_i = ref.verify_kernel_indexed(*(jnp.asarray(a) for a in staged))
    assert got_i.tolist() == np.asarray(want_i).tolist()
    rows = np.ascontiguousarray(aq[idx])
    got = port.verify_kernel(*(torch.from_numpy(np.ascontiguousarray(a))
                               for a in (sd, hd, rows, ry, rs)))
    want = ref.verify_kernel(*(jnp.asarray(a) for a in (sd, hd, rows, ry, rs)))
    assert got.tolist() == np.asarray(want).tolist() == got_i.tolist()


# --- the kernels on the card ------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernels_match_plain_versions_on_card(cuda_device):
    items = [it for group in _CASES.values() for it in group]
    idxs, staged = TorchEd25519Verifier(device=cuda_device).stage_bytes(items)
    s_u8, h_u8, k_u8, idx, r_u8 = staged
    got3 = port.decompress_kernel(k_u8)
    want3 = port.decompress_torch(k_u8)
    for g, w in zip(got3, want3):
        assert torch.equal(g, w)
    _, tables, valid = got3
    assert torch.equal(port.verify_tables(s_u8, h_u8, r_u8, idx, tables, valid),
                       port.verify_tables_torch(s_u8, h_u8, r_u8, idx, tables,
                                                valid))
    assert make_verifier("cuda").verify_batch(items).tolist() == \
        CpuEd25519Verifier().verify_batch(items).tolist()


@pytest.mark.gpu
def test_limb_kernels_match_plain_versions_on_card(cuda_device):
    items = _dispatch_cases()
    _, staged = _staged(items)
    on_card = [t.to(cuda_device) for t in staged]
    sd, hd, aq, idx, ry, rs = on_card
    assert torch.equal(port.quarter_tables(aq).cpu(),
                       port.quarter_tables_torch(staged[2]))
    tables = port.quarter_tables(aq)
    assert torch.equal(port.verify_staged(sd, hd, ry, rs, idx, tables).cpu(),
                       port.verify_staged_torch(*staged[:2], staged[4],
                                                staged[5], staged[3],
                                                tables.cpu()))
    v = make_verifier("cuda")
    v._compressed_dispatch = False
    assert v.verify_batch(items).tolist() == \
        CpuEd25519Verifier().verify_batch(items).tolist()

