"""Multi-host distributed initialization for the crypto batch plane (the
JAX package's parallel/multihost.py, on torch.distributed).

Reference behavior being replaced: the NCCL/MPI-style scale-out story — the
reference's pool spans hosts via per-node ZMQ processes; here the DEVICE
side additionally spans hosts: every host runs the same crypto-plane
program over one global mesh of lanes, each process driving its own
lanes, with the collectives (all_gather of Merkle subtree roots, a sum of
verdict counts) on a torch.distributed process group: `nccl` between
cards, `gloo` between CPU lanes.

Usage (one call per host process, before any collective):

    from plenum_tpu_torch.parallel.multihost import (init_multihost,
                                                     global_mesh,
                                                     shard_host_batch)
    init_multihost(coordinator="10.0.0.1:8476",
                   num_processes=4, process_id=HOST_RANK)
    mesh = global_mesh()                  # spans ALL hosts' lanes
    plane = ShardedCryptoPlane(mesh)      # the same code on every host
    ok, root, n_ok = plane.step_bytes(*(
        shard_host_batch(mesh, a, spec)   # this host's slice of each input
        for a, spec in zip(host_arrays, STEP_BYTES_SPECS)))

Each host passes its own slice of the batch and gets back its block of
the verdicts and the job's root and count. The suite runs this with TWO
real OS processes joining one `gloo` group over a localhost address, 4
explicit CPU lanes each -> one 8-lane global mesh
(tests/test_torch_multihost.py). NCCL refuses two ranks on one GPU, so
on one card the group has world size 1.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .mesh import Mesh, lane_roster, mesh_shape_for

_initialized = False


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   backend: str = "nccl") -> dict:
    """Join (or bootstrap) the job's process group. Idempotent. With no
    coordinator on a single host this is a no-op that marks the process
    initialized (one process needs no group). `coordinator` is the
    rank-0 host's "address:port" (a tcp:// rendezvous); `backend` is
    "nccl" for the card (the default) or "gloo" for CPU lanes.

    Returns this host's kernel build cache (ops.build_preflight): which
    libraries of the current sources are built under ops.BUILD_DIR, and
    so whether THIS host starts warm or pays nvcc — the counterpart of
    the reference's compile-cache preflight."""
    global _initialized
    from plenum_tpu_torch.ops import build_preflight
    if _initialized:
        return build_preflight()
    if coordinator is not None:
        import torch.distributed as dist
        dist.init_process_group(backend=backend,
                                init_method=f"tcp://{coordinator}",
                                world_size=num_processes or 1,
                                rank=process_id or 0)
    _initialized = True
    return build_preflight()


def process_count() -> int:
    """Processes in the job: the group's world size, or 1 without one."""
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank in the job, 0 without a group."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0

# NOTE on lanes vs the global mesh: the multi-device pipeline's lanes
# are per-chip dispatch streams and must be able to place tensors from
# this process, so a multi-host job runs one N-lane pipeline PER HOST
# over `parallel.mesh.lane_roster()` (local devices only), while the
# plane over `global_mesh()` remains the one-program-spans-all-hosts
# story. The THIRD cross-host shape is the federated pipeline
# (parallel/federation.py): remote crypto-service hosts rostered below
# join THIS host's ring as extra lanes — rented verification capacity
# over the service wire rather than one program — with work-stealing
# between backlogged lanes.


def crypto_host_roster(config=None,
                       hosts: Optional[str] = None) -> list[str]:
    """Remote crypto-host roster for the federated pipeline: the
    comma-separated crypto_service socket paths of rostered hosts
    (config.PIPELINE_REMOTE_HOSTS, or an explicit override string).
    Empty roster -> empty list -> the single-host classes construct
    exactly (the federation gate in pipeline.make_crypto_pipeline)."""
    raw = hosts if hosts is not None else str(
        getattr(config, "PIPELINE_REMOTE_HOSTS", "") or "")
    return [h.strip() for h in raw.split(",") if h.strip()]


def global_mesh(n_devices: Optional[int] = None,
                devices: Optional[Sequence] = None) -> Mesh:
    """("inst", "sig") mesh over EVERY lane in the job (all hosts): each
    process's local lanes (`devices`, default this host's CUDA devices),
    in rank order, the first n_devices of the job split evenly over its
    processes. `mesh.local` is this process's slice of `mesh.flat`, the
    lanes it drives; the other entries name the other processes' lanes
    by this process's handles and are never driven here. Inside a
    process group `mesh.in_group` is set: the plane then combines its
    shards across the group's processes."""
    local = lane_roster(None, devices)
    if not local:
        from plenum_tpu_torch import ops
        ops.resolve_device("cuda")       # raises: no CUDA device
        raise ValueError("global_mesh: no devices")
    rank, world = process_index(), process_count()
    if n_devices is not None:
        if n_devices % world:
            raise ValueError(f"{n_devices} lanes do not split over "
                             f"{world} processes")
        local = local[:n_devices // world]
    inst, sig = mesh_shape_for(len(local) * world)
    mesh = Mesh(local * world, inst, sig)
    mesh.local = slice(rank * len(local), (rank + 1) * len(local))
    import torch.distributed as dist
    mesh.in_group = dist.is_initialized()
    return mesh


def shard_host_batch(mesh: Mesh, arr: np.ndarray, spec) -> list:
    """Place this host's slice of a batch on its local lanes: `arr` is
    the part of the global array that this process holds under `spec`
    (all of it on one process); it comes back cut into one block per
    lane of `mesh.local`, each on its lane (`Mesh.shard`), which is how
    the plane's steps take an input."""
    return mesh.shard(torch.as_tensor(np.ascontiguousarray(arr)), spec)
