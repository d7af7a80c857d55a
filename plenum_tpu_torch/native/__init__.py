"""Native (C++) acceleration for the crypto hot paths.

The reference leans on native libraries for exactly these ops (Rust Ursa for
BLS BN254, libsodium for Ed25519 — SURVEY.md §2.1); here the equivalents are
in-tree C++ compiled on first use with the system toolchain and loaded via
ctypes (no pybind11 in this environment). Everything degrades gracefully: if
the toolchain is missing or the build fails, callers fall back to the pure-
Python twins (which stay authoritative for differential testing).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))


def _cache_dir() -> str:
    """User-owned 0700 build cache — NEVER the world-writable temp dir: the
    source is public and the artifact name predictable, so a shared /tmp path
    would let any local user pre-plant a malicious .so for us to dlopen.
    The port's own directory, never the reference package's; under the
    user's home, not the checkout, so a checkout copied to another host never
    loads a `-march=native` library built for a different CPU."""
    base = os.environ.get("XDG_CACHE_HOME") or \
        os.path.join(os.path.expanduser("~"), ".cache")
    path = os.path.join(base, "plenum_tpu_torch", "native")
    os.makedirs(path, mode=0o700, exist_ok=True)
    os.chmod(path, 0o700)
    return path


def _build(src_name: str, tag: str) -> Optional[ctypes.CDLL]:
    src = os.path.join(_DIR, src_name)
    try:
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        so_path = os.path.join(_cache_dir(), f"{tag}_{digest}.so")
        if not os.path.exists(so_path):
            tmp = so_path + f".build-{os.getpid()}"
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                 "-std=c++17", "-o", tmp, src],
                check=True, capture_output=True, timeout=300)
            os.replace(tmp, so_path)      # atomic: concurrent builds race safely
        return ctypes.CDLL(so_path)
    except Exception:
        return None


_bn254 = _build("bn254.cpp", "bn254")

if _bn254 is not None:
    _u8p = ctypes.POINTER(ctypes.c_uint8)
    _bn254.pc_pairing_check.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                        ctypes.c_int]
    _bn254.pc_pairing_check.restype = ctypes.c_int
    for fn in (_bn254.pc_g1_mul, _bn254.pc_g2_mul,
               _bn254.pc_g1_add, _bn254.pc_g2_add):
        fn.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p]
        fn.restype = ctypes.c_int
    _bn254.pc_g2_in_subgroup.argtypes = [ctypes.c_char_p]
    _bn254.pc_g2_in_subgroup.restype = ctypes.c_int
    # differential-test surface
    _bn254.pc_miller.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                 ctypes.c_char_p]
    _bn254.pc_miller.restype = ctypes.c_int
    _bn254.pc_final_exp.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    _bn254.pc_final_exp.restype = ctypes.c_int

bn254_lib: Optional[ctypes.CDLL] = _bn254


def have_native_bn254() -> bool:
    return bn254_lib is not None
