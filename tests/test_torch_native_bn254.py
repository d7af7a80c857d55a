"""The port's copy of tests/test_native_bn254.py, run on plenum_tpu_torch.

Differential tests: the C++ BN254 library vs the pure-Python twin.

The native library (plenum_tpu_torch/native/bn254.cpp) carries the 3PC BLS hot
path; the Python implementation (crypto/bn254.py) is the authoritative
reference. Every exported operation is checked against it on random inputs —
the correctness bar SURVEY.md §7 sets for native pairing code.
"""
import ctypes
import random

import pytest

from plenum_tpu_torch.crypto import bn254 as c
from plenum_tpu_torch.crypto.bn254 import _dec_g1, _dec_g2, _enc_g1, _enc_g2
from plenum_tpu_torch.native import bn254_lib, have_native_bn254

pytestmark = pytest.mark.skipif(not have_native_bn254(),
                                reason="native toolchain unavailable")

rng = random.Random(0xB254)


def py_g1_mul(a, k):
    out = None
    while k:
        if k & 1:
            out = c.g1_add(out, a)
        a = c.g1_add(a, a)
        k >>= 1
    return out


def py_g2_mul(a, k):
    out = None
    while k:
        if k & 1:
            out = c.g2_add(out, a)
        a = c.g2_add(a, a)
        k >>= 1
    return out


def f12_to_bytes(f):
    (a, b, d), (e, g, h) = f
    vals = [a[0], a[1], b[0], b[1], d[0], d[1],
            e[0], e[1], g[0], g[1], h[0], h[1]]
    return b"".join(x.to_bytes(32, "big") for x in vals)


def f12_from_bytes(raw):
    v = [int.from_bytes(raw[i * 32:(i + 1) * 32], "big") for i in range(12)]
    return (((v[0], v[1]), (v[2], v[3]), (v[4], v[5])),
            ((v[6], v[7]), (v[8], v[9]), (v[10], v[11])))


def test_g1_mul_differential():
    for _ in range(5):
        k = rng.randrange(1, c.R)
        assert c.g1_mul(c.G1_GEN, k) == py_g1_mul(c.G1_GEN, k)


def test_g2_mul_differential():
    for _ in range(2):
        k = rng.randrange(1, c.R)
        assert c.g2_mul(c.G2_GEN, k) == py_g2_mul(c.G2_GEN, k)


def test_g1_g2_add_differential():
    a = c.g1_mul(c.G1_GEN, 7)
    b = c.g1_mul(c.G1_GEN, 11)
    buf = ctypes.create_string_buffer(64)
    assert bn254_lib.pc_g1_add(_enc_g1(a), _enc_g1(b), buf) == 0
    assert _dec_g1(buf.raw) == c.g1_add(a, b)
    qa = c.g2_mul(c.G2_GEN, 7)
    qb = c.g2_mul(c.G2_GEN, 11)
    buf2 = ctypes.create_string_buffer(128)
    assert bn254_lib.pc_g2_add(_enc_g2(qa), _enc_g2(qb), buf2) == 0
    assert _dec_g2(buf2.raw) == c.g2_add(qa, qb)


def test_miller_loop_differential():
    p1 = c.g1_mul(c.G1_GEN, 123)
    q2 = c.g2_mul(c.G2_GEN, 45)
    buf = ctypes.create_string_buffer(384)
    assert bn254_lib.pc_miller(_enc_g2(q2), _enc_g1(p1), buf) == 0
    assert f12_from_bytes(buf.raw) == c.miller_loop(q2, p1)


def test_final_exp_differential():
    m = c.miller_loop(c.g2_mul(c.G2_GEN, 9), c.g1_mul(c.G1_GEN, 31))
    buf = ctypes.create_string_buffer(384)
    assert bn254_lib.pc_final_exp(f12_to_bytes(m), buf) == 0
    assert f12_from_bytes(buf.raw) == c.final_exponentiation(m)


def test_pairing_check_bilinearity_random():
    for _ in range(3):
        a = rng.randrange(1, c.R)
        b = rng.randrange(1, c.R)
        ok = c.pairing_check([
            (c.g2_mul(c.G2_GEN, a), c.g1_mul(c.G1_GEN, b)),
            (c.g2_mul(c.G2_GEN, a * b % c.R), c.g1_neg(c.G1_GEN))])
        assert ok


def test_pairing_check_rejects_wrong():
    p1 = c.g1_mul(c.G1_GEN, 31337)
    assert not c.pairing_check([(c.G2_GEN, c.g1_neg(p1)),
                                (c.g2_mul(c.G2_GEN, 2), c.G1_GEN)])


def test_native_agrees_with_python_backend():
    """The exact same pairing_check answer with and without the native lib."""
    p1 = c.g1_mul(c.G1_GEN, 777)
    q2 = c.g2_mul(c.G2_GEN, 777)
    pairs = [(c.G2_GEN, c.g1_neg(p1)), (q2, c.G1_GEN)]
    native = c.pairing_check(pairs)
    python = c.multi_pairing(pairs) == c.F12_ONE
    assert native == python == True      # noqa: E712


def test_subgroup_check_differential():
    assert c.g2_in_subgroup(c.G2_GEN)
    assert c.g2_in_subgroup(c.g2_mul(c.G2_GEN, 12345))


def test_infinity_handling():
    assert c.g1_mul(c.G1_GEN, c.R) is None
    assert c.g2_mul(c.G2_GEN, c.R) is None
    assert c.pairing_check([(c.G2_GEN, None), (None, c.G1_GEN)])
