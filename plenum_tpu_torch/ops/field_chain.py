"""The field squaring chain x^(2^k) mod p: kernel K8 and its plain version.

Counterpart of the JAX package's one Pallas program,
probes/pallas_sqr_experiment.py:57 `make_pallas_chain`: a microbench of
the serial squaring chain that the Ed25519 ladders are built from (the
quarter points run 64 squarings per doubling chain, an inversion 254).
It lies on no path of the system; `chip_smoke.py` drives it on its own,
at the probe's shape (N = 2,048 columns, k = 64).

Layout as in the probe: x int32[20, N], limb-major (limb i of column j at
x[i, j]), 20 13-bit limbs per value, carried or canonical. K8 (in
csrc/ed25519.cu) converts a column to the port's ten-limb layout in
registers, runs k squarings and writes the canonical 13-bit limbs back;
on one thread a column each squaring is `fe_sq`, on a quad of lanes
`fe_sq_lanes` (the lanes split fe_sq's products and swap their sums: the
same integers). The plain version runs the same limb
operations. The probe's output is carried, so the two packages agree on
values mod p.
"""
from __future__ import annotations

import torch

from plenum_tpu_torch import ops
from plenum_tpu_torch.ops import ed25519 as ed

# K8's default geometry: lanes per column and threads per block. On the
# H100 the quad beat one thread a column at every block size (PERF.md);
# one thread a column stays for K4's lock-step inversion, which
# chip_smoke.py's inversion_share line measures
THREADS_PER_ITEM = 4
THREADS_PER_BLOCK = 32


def field_chain_torch(x: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version of K8: int32[20, N] -> int32[20, N], x^(2^k)."""
    z = ed._pow2k(ed.limbs13_to_fe(x.T), k)
    return ed.fe_to_limbs13(ed.fe_canon(z)).T.contiguous().to(torch.int32)


def field_chain(x: torch.Tensor, k: int,
                threads_per_item: int = THREADS_PER_ITEM,
                threads_per_block: int = THREADS_PER_BLOCK) -> torch.Tensor:
    """x^(2^k) mod p for each column of x int32[20, N] (13-bit limbs,
    limb-major) -> the canonical 13-bit limbs, int32[20, N]. On a CUDA
    tensor: one K8 launch, each column on threads_per_item lanes (1 or 4)
    in blocks of threads_per_block threads (32, 64, 96 or 128)."""
    if x.dtype != torch.int32 or x.dim() != 2 or x.shape[0] != ed.NLIMB:
        raise ValueError(f"field_chain: want int32[20, N], got "
                         f"{x.dtype}{list(x.shape)}")
    if k < 0:
        raise ValueError("field_chain: k must be >= 0")
    if threads_per_item not in (1, 4) or \
            threads_per_block not in (32, 64, 96, 128):
        raise ValueError(f"field_chain: {threads_per_item} lanes per column "
                         f"in blocks of {threads_per_block}: want 1 or 4 "
                         f"lanes in blocks of 32, 64, 96 or 128 threads")
    if not x.is_cuda:
        return field_chain_torch(x, k)
    ops.require_cuda("field_chain", x)
    n = x.shape[1]
    out = torch.empty_like(x)
    if n:
        ops.checked(ed.lib().field_chain_launch(
            ops.ptr(x), ops.ptr(out), n, k, threads_per_item,
            threads_per_block, ops.stream_handle(x.device)), "field_chain")
        ops.count("field_chain")
    return out
