"""Edge-partitioned aggregation for large duplex graphs (graph parallelism):
the JAX package's parallel/partition.py on the port's gp mesh.

A layer's edge list is split into gp equal contiguous slices, slice i on
shard i's device (`shard_edges`).  Every shard aggregates its slice into
the full node space, out_i[dst] += w · h[src], as a destination-sorted
segment sum over its edges (each row adds its edges in their stored order,
so the result is the same on every run, where CUDA's `index_add_` adds
with atomics in a changing order).  The partials are then summed in shard
order, the counterpart of the JAX package's psum over 'gp', and the sum is
replicated: each shard gets it on its device (shards of one device share
one tensor).  h is replicated too.  Autograd gives the gradients for h and
w, through the gathers, the segment sums and the copies.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch

from mdcommunity_tpu_torch.parallel.mesh import GpMesh, per_device

Parts = List[torch.Tensor]


def _local_spmm(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor, h: torch.Tensor
                ) -> torch.Tensor:
    """One shard's partial: its edges' messages summed into every node."""
    order = torch.argsort(dst, stable=True)
    msg = h[src[order]] * w[order, None]
    lengths = torch.bincount(dst, minlength=h.shape[0])
    return torch.segment_reduce(msg, "sum", lengths=lengths, axis=0, unsafe=True)


def shard_edges(mesh: GpMesh, src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor
                ) -> Tuple[Parts, Parts, Parts]:
    """The COO arrays as gp equal contiguous slices, slice i on shard i's
    device (pad E to a multiple of gp first, with w = 0 edges)."""
    if src.shape[0] % mesh.gp:
        raise ValueError(f"{src.shape[0]} edges do not split into gp={mesh.gp} shards; "
                         f"pad them first")
    return tuple([p.to(d, non_blocking=True) for p, d in zip(torch.chunk(x, mesh.gp),
                                                              mesh.devices)]
                 for x in (src, dst, w))


def spmm_edge_partitioned(mesh: GpMesh, src: Union[torch.Tensor, Sequence[torch.Tensor]],
                          dst, w, h: torch.Tensor) -> Parts:
    """A @ H with the edges split over the gp shards and H replicated.

    src, dst, w: [E] tensors (E divisible by gp) or their shard_edges slices;
    h: [N, D].  Returns the [N, D] sum on each shard's device."""
    if isinstance(src, torch.Tensor):
        src, dst, w = shard_edges(mesh, src, dst, w)
    if not len(src) == len(dst) == len(w) == mesh.gp:
        raise ValueError(f"expected {mesh.gp} edge slices, got {len(src)}")
    hs = per_device(mesh, lambda dev: h.to(dev, non_blocking=True))
    parts = [_local_spmm(s, d, x, hh) for s, d, x, hh in zip(src, dst, w, hs)]
    dev0 = mesh.devices[0]
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(dev0, non_blocking=True)
    return per_device(mesh, lambda dev: total.to(dev, non_blocking=True))
