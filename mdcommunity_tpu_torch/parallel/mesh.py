"""The graph-parallel (gp) mesh: node shards and the collectives between them.

The counterpart of the JAX package's parallel/mesh.py for its 'gp' axis.
Nodes, and with them the band blocks of a DenseBandGraph, are split into gp
contiguous shards; shard i lives on mesh.devices[i].  A device may repeat:
on one card every shard sits on it, and the sharded engine
(parallel/band_partition.py) runs the same kernels and collectives as on a
host with one card a shard, with no copy between neighbours.

The collectives are what the JAX package's engine does with ppermute and
all_gather: `ring_halos` hands each shard its left neighbour's tail and its
right neighbour's head (wrapping around, as the ppermute ring does), and
`all_gather` gives each device the shards' pieces joined in shard order.
Where two shards share a device a halo is a view of the neighbour's rows and
a gathered table is built once for the device; otherwise the pieces move
with `.to(device, non_blocking=True)`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from mdcommunity_tpu_torch.utils.device import resolve_device

Device = Union[str, torch.device]


@dataclasses.dataclass(frozen=True)
class GpMesh:
    """gp shards, shard i on devices[i] (devices may repeat)."""

    gp: int
    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        if self.gp < 1 or len(self.devices) != self.gp:
            raise ValueError(f"a gp={self.gp} mesh needs {self.gp} devices, "
                             f"got {len(self.devices)}")


def make_mesh(gp: int, devices: Optional[Union[Device, Sequence[Device]]] = None) -> GpMesh:
    """A gp mesh: one device a shard.  `devices` is a list of gp devices, or
    one device for every shard; by default the card (utils/device.
    resolve_device), so the shards run on CUDA unless the caller passes
    "cpu"."""
    if devices is None or isinstance(devices, (str, torch.device)):
        devices = [resolve_device(devices)] * gp
    return GpMesh(gp, tuple(_indexed(torch.device(d)) for d in devices))


def _indexed(d: torch.device) -> torch.device:
    """"cuda" as the card it means ("cuda:<current>"), as tensors report it."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _to(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """x on `device`: x itself (or the view it is) where it is there already."""
    return x.to(device, non_blocking=True)


def split_nodes(mesh: GpMesh, x: torch.Tensor) -> List[torch.Tensor]:
    """A node vector or matrix [n, ...] (n a multiple of gp) as its gp
    contiguous row pieces, piece i on shard i's device (a view where x is
    there)."""
    if x.shape[0] % mesh.gp:
        raise ValueError(f"{x.shape[0]} rows do not split into gp={mesh.gp} shards")
    return [_to(p, d) for p, d in zip(torch.chunk(x, mesh.gp), mesh.devices)]


def gather_nodes(mesh: GpMesh, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The row pieces joined in shard order, on the first shard's device."""
    return torch.cat([_to(p, mesh.devices[0]) for p in parts])


def gather_rows(mesh: GpMesh, parts: Sequence[torch.Tensor], idx: torch.Tensor) -> torch.Tensor:
    """x[idx] for the node tensor x whose row pieces are `parts` (equal
    lengths), on the first shard's device: each shard gives the rows it owns
    and the rows are put back in idx's order.  Differentiable in parts."""
    dev0 = mesh.devices[0]
    idx = idx.to(dev0).long()
    n_local = parts[0].shape[0]
    owner = torch.div(idx, n_local, rounding_mode="floor")
    rows, where = [], []
    for i, (p, dev) in enumerate(zip(parts, mesh.devices)):
        pos = torch.nonzero(owner == i).flatten()
        rows.append(_to(p[_to(idx[pos] - i * n_local, dev)], dev0))
        where.append(pos)
    return torch.cat(rows)[torch.argsort(torch.cat(where))]


def ring_halos(mesh: GpMesh, parts: Sequence[torch.Tensor], width: int):
    """(left, right) halo lists: left[i] is the last `width` rows of shard
    i-1, right[i] the first `width` rows of shard i+1, with the ring wrapping
    around (shard 0's left halo is the last shard's tail), on shard i's
    device."""
    gp = mesh.gp
    left = [_to(parts[(i - 1) % gp][-width:], mesh.devices[i]) for i in range(gp)]
    right = [_to(parts[(i + 1) % gp][:width], mesh.devices[i]) for i in range(gp)]
    return left, right


def all_gather(mesh: GpMesh, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """For each shard, the pieces joined in shard order on its device; the
    shards of one device share one tensor."""
    return per_device(mesh, lambda dev: torch.cat([_to(p, dev) for p in parts]))


def per_device(mesh: GpMesh, fn) -> List:
    """fn(device) once for each distinct device of the mesh, as a list over
    the shards (the shards of one device share the result)."""
    done: Dict[torch.device, object] = {}
    for dev in mesh.devices:
        if dev not in done:
            done[dev] = fn(dev)
    return [done[dev] for dev in mesh.devices]
