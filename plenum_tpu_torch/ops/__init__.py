"""Device kernels (the GPU plane): build seam, launch checks and counters.

Takes the place of the JAX package's persistent compile-cache setup. The
kernels are CUDA C++ sources under `plenum_tpu_torch/csrc/`, each with a
plain C interface. At first use a source is compiled by `nvcc` for Hopper
(`sm_90a`) into a shared library under `build/plenum_tpu_torch/` at the
repository root, and loaded with `ctypes`: no PyTorch headers, so a build
takes seconds. A library's file name carries a hash of its sources and
flags, so an edited source is rebuilt and never mixed with a stale build.

Every launch goes through `checked()`, which raises when the C side
reports a CUDA error, and `count()`, which keeps one launch counter per
kernel in `LAUNCHES` — the evidence that a run really went through the
kernels. Nothing here is imported or built when the package is imported:
the CPU tests import every module on a host with no `nvcc`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "plenum_tpu_torch")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# one counter per kernel, bumped by its wrapper where it launches it
LAUNCHES: dict[str, int] = {
    "sha256_words": 0,        # K1, csrc/sha256.cu
    "sha256_interior": 0,     # the interior hash, csrc/sha256.cu
    "merkle_wave": 0,         # K2, a wave's levels (k_merkle_wave), csrc/sha256.cu
    "merkle_wave_tiled": 0,   # K2, a wide wave's levels (k_merkle_wave_tiled)
    "ed25519_decompress": 0,  # K3, csrc/ed25519.cu
    "ed25519_verify": 0,      # K4, csrc/ed25519.cu
    "ed25519_quarter_tables": 0,  # K5, csrc/ed25519.cu
    "ed25519_verify_staged": 0,   # K6, csrc/ed25519.cu
    "merkle_reduce": 0,       # K7, csrc/sha256.cu
    "field_chain": 0,         # K8, csrc/ed25519.cu
}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def count(kernel: str) -> None:
    LAUNCHES[kernel] += 1


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def default_device() -> torch.device:
    """The entry points' device: the card. Raises when there is none —
    the CPU is reached only by asking for it (backend "torch")."""
    return resolve_device(None)


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device, None meaning the card. Raises when a
    CUDA device is asked for and there is none: no silent CPU fallback."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the cuda backend needs an NVIDIA GPU; pass "
            "device='cpu' (backend 'torch') to run the plain versions")
    return dev


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "host with the CUDA toolkit")


def _sources(name: str) -> list[str]:
    """The .cu file plus every header of csrc/ (all hashed into the key)."""
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    return ([os.path.join(CSRC_DIR, name + ".cu")]
            + [os.path.join(CSRC_DIR, h) for h in headers])


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(name):
        with open(path, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _start_build(name: str):
    """-> (final path, temporary path, nvcc process or None when built)."""
    path = _lib_path(name)
    if os.path.exists(path):
        return path, None, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
    return path, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)


def build(names=("sha256", "ed25519")) -> dict[str, str]:
    """Compile the named sources, one nvcc process each, all at once;
    -> {name: library path}. Already-built libraries are reused."""
    with _LOCK:
        started = {n: _start_build(n) for n in names}
        for n, (path, tmp, proc) in started.items():
            if proc is None:
                continue
            out, _ = proc.communicate()
            with open(path + ".log", "w") as fh:
                fh.write(out)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for csrc/{n}.cu:\n{out}")
            os.replace(tmp, path)
        return {n: path for n, (path, _, _) in started.items()}


def lib(name: str) -> ctypes.CDLL:
    """The loaded kernel library for csrc/<name>.cu, built at first use."""
    got = _LIBS.get(name)
    if got is None:
        path = build((name,))[name]
        with _LOCK:
            got = _LIBS.get(name)
            if got is None:
                got = _LIBS[name] = ctypes.CDLL(path)
    return got


def build_log(name: str) -> str:
    """nvcc's output (ptxas register/spill lines) for a built source."""
    try:
        with open(_lib_path(name) + ".log") as fh:
            return fh.read()
    except OSError:
        return ""


def build_preflight(names=("sha256", "ed25519")) -> dict:
    """This host's kernel build cache (the counterpart of the JAX
    package's compile-cache preflight): for each source, the library its
    current text and flags name and whether it is built under BUILD_DIR,
    so a caller knows whether this host starts warm or pays nvcc; `stale`
    counts libraries of other sources or flags beside them. Never
    raises, never builds."""
    out = {"build_dir": BUILD_DIR, "libraries": {}, "warm": True,
           "stale": 0}
    current = set()
    for name in names:
        try:
            path = _lib_path(name)
        except OSError:
            out["libraries"][name] = None
            out["warm"] = False
            continue
        built = os.path.exists(path)
        current.add(os.path.basename(path))
        out["libraries"][name] = {"library": os.path.basename(path),
                                  "built": built}
        out["warm"] = out["warm"] and built
    try:
        out["stale"] = sum(1 for f in os.listdir(BUILD_DIR)
                           if f.startswith("lib") and f.endswith(".so")
                           and f not in current)
    except OSError:
        pass
    return out


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def checked(rc: int, kernel: str) -> None:
    """Raise on the cudaError_t a C launcher returned (cudaGetLastError
    right after the launch: a refused launch never runs, and a later
    synchronize would not report it)."""
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {kernel} failed: error {rc}")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def require_cuda(kernel: str, *tensors: torch.Tensor) -> None:
    """A wrapper given CUDA tensors launches its kernel or raises: every
    tensor must be contiguous and on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{kernel}: tensors must be contiguous and on "
                             f"one device (got {t.device})")
