"""Device meshes for the crypto plane (the JAX package's parallel/mesh.py).

The two mesh axes mirror the two protocol batch axes:

  - "inst": RBFT protocol instances (master + backups) — each instance
            validates the same traffic, so the axis is embarrassingly
            parallel.
  - "sig":  requests within a 3PC batch (Max3PCBatchSize) — the inner
            axis of the verify and hash kernels.

A mesh here is a grid of torch devices. One process drives every device
of its mesh, as the reference's shard_map does: the plane launches each
shard's kernels on its device's current stream and gathers the results
with peer copies (parallel/crypto_plane.py). A device may appear more
than once: a roster longer than the device list wraps, so four shards
can share one card.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from plenum_tpu_torch import ops


def mesh_shape_for(n_devices: int) -> tuple[int, int]:
    """Factor n_devices into (inst, sig) — sig axis gets the larger factor,
    since request batches are far wider than the instance count (f+1)."""
    inst = 1
    for cand in (2, 3):
        if n_devices % cand == 0 and n_devices > cand:
            inst = cand
            break
    return inst, n_devices // inst


def lane_roster(n_lanes: Optional[int] = None,
                devices: Optional[Sequence] = None) -> list[torch.device]:
    """The devices of this process in order, as torch devices: `devices`
    when given, else every CUDA device (none on a host without a GPU).
    n_lanes truncates the list, and wraps it when it asks for more
    devices than there are (several lanes then share a device: still
    correct, no scaling)."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
    else:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if not devs:
        return []
    if n_lanes is None or n_lanes <= 0:
        return devs
    return [devs[i % len(devs)] for i in range(n_lanes)]


class Mesh:
    """A ("inst", "sig") grid of torch devices: `devices` is the grid as
    an object array [inst, sig], `shape` the axis sizes by name, and
    `flat` the devices in shard order (inst-major)."""

    def __init__(self, devices: Sequence[torch.device], inst: int, sig: int):
        if len(devices) != inst * sig:
            raise ValueError(f"{len(devices)} devices for a {inst}x{sig} mesh")
        self.flat = [ops.resolve_device(d) for d in devices]
        self.devices = np.empty((inst, sig), dtype=object)
        for k, d in enumerate(self.flat):
            self.devices[k // sig, k % sig] = d
        self.shape = {"inst": inst, "sig": sig}

    @property
    def size(self) -> int:
        return len(self.flat)


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over `devices` (default: every CUDA device), cut to the
    first n_devices, shaped by mesh_shape_for. Raises when it would be
    empty or names a CUDA device on a host that has none."""
    devs = lane_roster(None, devices)
    if n_devices is not None:
        devs = devs[:n_devices]
    if not devs:
        ops.resolve_device("cuda")      # raises: no CUDA device
        raise ValueError("make_mesh: no devices")
    inst, sig = mesh_shape_for(len(devs))
    return Mesh(devs, inst, sig)
