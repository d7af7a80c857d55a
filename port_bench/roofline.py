"""Rooflines counted from the algorithm's work, never from the port's
instructions, so that they stay put when a kernel changes.

Ed25519 verification (RFC 8032 section 5.1.7), in 32x32->64-bit products
of GF(2^255 - 19) arithmetic on 8 words (a multiplication 64 of them, a
squaring 36):

- per signature, one interleaved [S]B - [k]A in extended coordinates:
  254 doublings at 4M + 4S, 49 additions at 9M for a width-5 NAF of A, 32
  mixed additions at 7M for a width-7 NAF of B, an inversion of 254S +
  11M and 2M to encode R' = 1,694 M + 1,270 S = 154,136 products;
- per distinct key of a dispatch, its decompression (ref10's 2^252 - 3
  chain): 19 M + 255 S = 10,396 products;
- bytes: 101 a signature (R, S, the 32-byte digest k, 5 of index and
  flags) and 32 a key, each read once.

The peak of one H100 at 700 W: 132 SMs x 1,980 MHz x 64 integer
multiplies a clock an SM (CUDA C++ Programming Guide, compute capability
9.0) = 1.673e13 products/s, and 3.35e12 bytes/s of HBM.
"""
from __future__ import annotations

MUL, SQR = 64, 36                      # products of a multiply, a square
SIG_M, SIG_S = 1694, 1270
KEY_M, KEY_S = 19, 255
SIG_PRODUCTS = SIG_M * MUL + SIG_S * SQR          # 154,136
KEY_PRODUCTS = KEY_M * MUL + KEY_S * SQR          # 10,396
SIG_BYTES, KEY_BYTES = 101, 32
PEAK_PRODUCTS_S = 132 * 1.98e9 * 64               # 1.673e13
PEAK_BYTES_S = 3.35e12

# the kernels whose device time the Ed25519 work is read against: K3
# (decompression and tables) and K4 (verification), by the profiler's
# names of csrc/ed25519.cu's kernels
ED25519_KERNELS = ("k_ed25519_decompress", "k_ed25519_verify")


def ed25519_products(sigs: int, keys: int) -> int:
    return sigs * SIG_PRODUCTS + keys * KEY_PRODUCTS


def ed25519_bytes(sigs: int, keys: int) -> int:
    return sigs * SIG_BYTES + keys * KEY_BYTES


def ed25519_floor_s(sigs: int, keys: int) -> tuple[float, str]:
    """The least time the card could take for this work -> (seconds,
    "compute" or "memory", whichever bounds it)."""
    compute = ed25519_products(sigs, keys) / PEAK_PRODUCTS_S
    memory = ed25519_bytes(sigs, keys) / PEAK_BYTES_S
    return (compute, "compute") if compute >= memory else (memory, "memory")


def kernel_seconds(device_s_by_name: dict, kernels=ED25519_KERNELS) -> float:
    """Device seconds of the named kernels: an operation's name up to its
    argument list or template arguments (`k_ed25519_verify(unsigned char
    const*, ...)`); K6, `k_ed25519_verify_staged`, is another kernel."""
    return sum(s for name, s in device_s_by_name.items()
               if name.split("(", 1)[0].split("<", 1)[0].strip() in kernels)


def ed25519_roofline_percent(sigs: int, keys: int,
                             device_s: float) -> float | None:
    """100 x the floor over the kernels' device time; None without work
    or device time."""
    if sigs <= 0 or device_s <= 0:
        return None
    return 100.0 * ed25519_floor_s(sigs, keys)[0] / device_s
