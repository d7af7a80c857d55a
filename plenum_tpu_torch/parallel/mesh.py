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
    an object array [inst, sig], `shape` the axis sizes by name,
    `flat` the devices in shard order (inst-major), and `local` the
    slice of `flat` this process drives. A mesh of one process drives
    all of it; `multihost.global_mesh` makes a mesh over a job's
    process group (`in_group`), whose other entries name the other
    processes' lanes."""

    def __init__(self, devices: Sequence[torch.device], inst: int, sig: int):
        if len(devices) != inst * sig:
            raise ValueError(f"{len(devices)} devices for a {inst}x{sig} mesh")
        self.flat = [ops.resolve_device(d) for d in devices]
        self.devices = np.empty((inst, sig), dtype=object)
        for k, d in enumerate(self.flat):
            self.devices[k // sig, k % sig] = d
        self.shape = {"inst": inst, "sig": sig}
        self.local = slice(0, len(self.flat))
        self.in_group = False

    @property
    def size(self) -> int:
        return len(self.flat)

    def local_grid(self) -> tuple[int, int]:
        """The shards this process drives, `flat[local]`, as a block of
        the grid -> (rows, columns) of shards: whole "inst" rows, or a
        run of one row's "sig" columns. Local shard j sits at
        (j // columns, j % columns) of the block."""
        start, n = self.local.start, self.local.stop - self.local.start
        sig = self.shape["sig"]
        if n > 0 and n % sig == 0 and start % sig == 0:
            return n // sig, sig
        if n > 0 and sig % n == 0 and start % sig + n <= sig:
            return 1, n
        raise ValueError(f"lanes {start}..{start + n - 1} are no block of "
                         f"the {self.shape['inst']}x{sig} mesh")

    def shard(self, t: torch.Tensor, spec) -> list[torch.Tensor]:
        """Cut `t`, this process's part of an input laid out by `spec`,
        into one block per lane it drives, each on its lane. `spec` names
        each axis of t as the reference's PartitionSpec does: None (not
        cut), "inst" or "sig" (cut over that mesh axis) or ("inst",
        "sig") (cut over the flattened mesh); spec None gives every lane
        all of t. Raises when an axis does not split evenly."""
        lanes = self.flat[self.local]
        if spec is None:
            return [t.contiguous().to(d) for d in lanes]
        rows, cols = self.local_grid()
        out = []
        for j, dev in enumerate(lanes):
            parts = {None: (1, 0), "inst": (rows, j // cols),
                     "sig": (cols, j % cols), ("inst", "sig"): (len(lanes), j)}
            index = []
            for ax, name in enumerate(spec):
                n_parts, k = parts[name]
                size = t.shape[ax]
                if size % n_parts:
                    raise ValueError(f"axis {ax} of {list(t.shape)} does not "
                                     f"tile {n_parts} {name} shards")
                step = size // n_parts
                index.append(slice(k * step, (k + 1) * step))
            out.append(t[tuple(index)].contiguous().to(dev))
        return out


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
