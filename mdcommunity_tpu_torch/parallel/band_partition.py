"""The gp-sharded band operator: halo exchange and the halo-mode kernel K3.

The counterpart of both sharded engines of the JAX package's
parallel/band_partition.py (the XLA one, spmm_band_sharded, and the Pallas
one, spmm_band_packed_sharded), collapsed into one operator as the port
collapsed the unsharded ones (ops/dense_band.py):

  * Nodes, and with them the band blocks, are split contiguously over the gp
    shards of a GpMesh (parallel/mesh.py).  shard_band_graph splits the
    block-major arrays (base, slot_of_row, mirror_node), as views where a
    shard shares the graph's device, and replicates the mirror COO and its
    weights once a device.
  * Each shard contracts its own blocks with kernel K3
    (ops/band_kernels.spmm_band_halo), whose windows run linearly over
    [left halo | local rows | right halo].  The halos are the ring
    neighbours' B boundary rows (parallel/mesh.ring_halos).  With three or
    more local blocks the interior blocks, whose windows never reach a halo,
    are issued first and the two boundary blocks after, as the JAX package
    splits its kernel into three calls (commit eedc811): on a mesh of cards
    the halo copies can then run beside the interior call.
  * The mirror overflow is shard-local up to one all-gather: a block's
    mirror nodes are its own rows, so each shard compacts its own mirror
    rows, the table is gathered in shard order, the sorted segment sum runs
    over the whole table, and each shard expands its own slice.

So a sharded call computes the same values in the same order as K1 on the
whole graph, and gives its bits.  The sharded engine carries band and
mirror only: a build with spill edges is refused.  ShardedBandSpmm is its
autograd Function; its backward is the same sharded operator with the row
and column scales swapped (the stored operator is symmetric).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from mdcommunity_tpu_torch.ops.band_kernels import spmm_band_halo
from mdcommunity_tpu_torch.ops.dense_band import (
    DenseBandGraph,
    band_versions,
    check_band_versions,
    clear_cells,
    mirror_compact,
    sever_cells,
)
from mdcommunity_tpu_torch.ops.spmm_csr import build_sorted_coo, spmm_sorted
from mdcommunity_tpu_torch.parallel.mesh import GpMesh, all_gather, per_device, ring_halos

Parts = List[torch.Tensor]


@dataclasses.dataclass
class ShardedBandGraph:
    """One layer's band operator split over a gp mesh.

    shards : a DenseBandGraph for each shard (n = local_n): its own base
             blocks [nb_l, S+C, W2] (W2/2 with nibble: K3's nibble mode
             reads them) and slot_of_row [nb_l, S], its mirror
             slots' nodes in local ids; the whole graph's mirror COO, w_cov
             and c_key (one copy a device); no spill.
    n      : the whole graph's node count
    """

    mesh: GpMesh
    shards: List[DenseBandGraph]
    n: int
    S: int
    B: int
    C: int

    @property
    def n_blocks(self) -> int:
        return self.mesh.gp * self.shards[0].n_blocks

    @property
    def pad_n(self) -> int:
        return self.n_blocks * self.S

    @property
    def local_n(self) -> int:
        return self.shards[0].pad_n


def shard_band_graph(mesh: GpMesh, dbg: DenseBandGraph) -> ShardedBandGraph:
    """Split `dbg` over the mesh's shards (views where a shard's device is
    dbg's).  Raises ValueError on spill edges or on a block count that the
    shards do not divide, as the JAX package does."""
    if dbg.spill.nnz:
        raise ValueError("the sharded band operator needs an empty spill set; raise "
                         "the mirror capacity or improve the ordering")
    if dbg.n_blocks % mesh.gp:
        raise ValueError(f"n_blocks={dbg.n_blocks} not divisible by gp={mesh.gp}")
    nb_l = dbg.n_blocks // mesh.gp
    local_n = nb_l * dbg.S

    def replicated(dev):
        none = np.zeros(0, np.int64)
        return dict(
            ccoo=dbg.ccoo.to(dev),
            w_cov=dbg.w_cov.to(dev), c_key=dbg.c_key.to(dev),
            spill=build_sorted_coo(none, none, local_n, dev),
            w_spill=dbg.w_spill.to(dev), s_key=torch.empty(0, dtype=torch.int64, device=dev),
        )

    shards = []
    for i, (dev, rep) in enumerate(zip(mesh.devices, per_device(mesh, replicated))):
        blocks = slice(i * nb_l, (i + 1) * nb_l)
        node = dbg.mirror_node[blocks]
        shards.append(DenseBandGraph(
            base=dbg.base[blocks].to(dev),
            mirror_node=torch.where(node >= 0, node - i * local_n, node).to(dev),
            slot_of_row=dbg.slot_of_row[blocks].to(dev),
            n=local_n, S=dbg.S, B=dbg.B, C=dbg.C, nibble=dbg.nibble, **rep,
        ))
    return ShardedBandGraph(mesh, shards, dbg.n, dbg.S, dbg.B, dbg.C)


def _check_mesh(mesh: GpMesh, sdbg: ShardedBandGraph, *parts: Sequence) -> None:
    if mesh != sdbg.mesh:
        raise ValueError("the operator was sharded over another mesh")
    for p in parts:
        if len(p) != mesh.gp:
            raise ValueError(f"expected {mesh.gp} shard pieces, got {len(p)}")


def mirror_subs(sdbg: ShardedBandGraph, col: Parts, h: Parts, precise: bool = True) -> Parts:
    """Each shard's slice [nb_l·C, D] of the mirror-space result
    (ops/dense_band.mirror_sub on the whole graph): shard-local compaction,
    the all-gather, one sorted segment sum over the whole table a device."""
    D = h[0].shape[1]
    if not sdbg.C:
        return [c.new_zeros((0, D)) for c in col]
    tables = all_gather(sdbg.mesh, [mirror_compact(s, c, x, precise)
                                    for s, c, x in zip(sdbg.shards, col, h)])
    done, subs = {}, []
    m = sdbg.shards[0].n_blocks * sdbg.C
    for i, (s, t) in enumerate(zip(sdbg.shards, tables)):
        if id(t) not in done:
            done[id(t)] = spmm_sorted(s.ccoo, s.w_cov, t)
        subs.append(done[id(t)][i * m: (i + 1) * m])
    return subs


def block_split(nb_l: int):
    """(interior, boundary) block ranges of a shard of nb_l blocks: with
    three or more, the interior [1, nb_l − 1), whose windows read no halo,
    and the two boundary blocks; else no interior and one range of all."""
    if nb_l >= 3:
        return [(1, nb_l - 1)], [(0, 1), (nb_l - 1, nb_l)]
    return [], [(0, nb_l)]


def spmm_band_sharded(mesh: GpMesh, sdbg: ShardedBandGraph, row: Parts, col: Parts,
                      h: Parts, precise: bool = True,
                      counter: Optional[str] = None) -> Parts:
    """out = (A ⊙ row⊗col) @ h with every node tensor given as its gp shard
    pieces (row, col [local_n], h [local_n, D] on each shard's device):
    the shards' output pieces.  precise and h's storage dtype as in
    ops/dense_band.spmm_dense_band; K3's launches count under `counter`
    (by default the mode's own).  Not differentiable: spmm_band_sharded_grad
    is."""
    _check_mesh(mesh, sdbg, row, col, h)
    subs = mirror_subs(sdbg, col, h, precise)
    interior, boundary = block_split(sdbg.shards[0].n_blocks)
    outs = [torch.empty_like(x) for x in h]
    # the interior blocks read no halo: issued before the exchange
    for s, r, c, x, sub, o in zip(sdbg.shards, row, col, h, subs, outs):
        for blocks in interior:
            spmm_band_halo(s, r, c, x, None, None, None, None, sub, blocks, o, counter,
                           precise)
    lh, rh = ring_halos(mesh, h, sdbg.B)
    lc, rc = ring_halos(mesh, col, sdbg.B)
    for i, (s, r, c, x, sub, o) in enumerate(zip(sdbg.shards, row, col, h, subs, outs)):
        for blocks in boundary:
            spmm_band_halo(s, r, c, x, lh[i], rh[i], lc[i], rc[i], sub, blocks, o,
                           counter, precise)
    return outs


class ShardedBandSpmm(torch.autograd.Function):
    """The sharded band operator, differentiable in h (the custom VJPs of
    the JAX package's sharded engines): the backward is the same sharded
    operator with row and col swapped, kernel K3 counted under
    launches["band_halo_bwd"]; with precise=False both run K3's bf16 mode,
    the backward counted under band_halo_bf16_bwd (the JAX package's VJP,
    band_partition.py:312-327).  apply(sdbg, precise, *row, *col, *h) with
    gp pieces each; returns the gp output pieces.  It raises in the
    backward if a shard's band operands were edited since the forward
    (ops/dense_band.BandSpmm's guard; shard bases that are views share
    their storage's edit counter, so a sever through the whole graph's base
    is seen)."""

    @staticmethod
    def forward(ctx, sdbg, precise, *tensors):
        gp = sdbg.mesh.gp
        row, col, h = tensors[:gp], tensors[gp:2 * gp], tensors[2 * gp:]
        ctx.sdbg = sdbg
        ctx.precise = precise
        ctx.versions = band_versions(sdbg)
        ctx.save_for_backward(*row, *col)  # autograd checks their versions
        return tuple(spmm_band_sharded(sdbg.mesh, sdbg, list(row), list(col),
                                       [x.contiguous() for x in h], precise))

    @staticmethod
    def backward(ctx, *gs):
        sdbg = ctx.sdbg
        check_band_versions(sdbg, ctx.versions)
        gp = sdbg.mesh.gp
        saved = ctx.saved_tensors
        name = "band_halo_bwd" if ctx.precise else "band_halo_bf16_bwd"
        dh = spmm_band_sharded(sdbg.mesh, sdbg, list(saved[gp:]), list(saved[:gp]),
                               [g.contiguous() for g in gs], ctx.precise, counter=name)
        return (None,) * (2 + 2 * gp) + tuple(dh)


def spmm_band_sharded_grad(mesh: GpMesh, sdbg: ShardedBandGraph, row: Parts, col: Parts,
                           h: Parts, precise: bool = True) -> Parts:
    """spmm_band_sharded with a gradient for h (ShardedBandSpmm), in either
    mode.  row and col must not require grad."""
    _check_mesh(mesh, sdbg, row, col, h)
    if any(t.requires_grad for t in (*row, *col)):
        raise ValueError("the band operator is differentiable in h only")
    return list(ShardedBandSpmm.apply(sdbg, precise, *row, *col, *h))


# ---------------------------------------------------------------- severs


def sever_sharded(sdbg: ShardedBandGraph, src: torch.Tensor, dst: torch.Tensor,
                  valid: torch.Tensor) -> ShardedBandGraph:
    """ops/dense_band.sever_edges on the sharded operator, in place: each
    in-band cell is zeroed (a nibble base's nibble set, clear_cells) in the
    shard that owns its destination block, each mirror edge's weight in
    every device's copy."""
    dev0 = sdbg.mesh.devices[0]
    src, dst = src.to(dev0, torch.int64), dst.to(dev0, torch.int64)
    valid = valid.to(dev0, torch.bool)
    blk, lr, lc, in_band = sever_cells(sdbg.S, sdbg.B, sdbg.pad_n, src, dst)
    ib = in_band & valid
    nb_l = sdbg.shards[0].n_blocks
    for i, s in enumerate(sdbg.shards):
        m = ib & (torch.div(blk, nb_l, rounding_mode="floor") == i)
        dev = s.base.device
        clear_cells(s.base, s.nibble, (blk[m] - i * nb_l).to(dev), lr[m].to(dev),
                    lc[m].to(dev))
    sev = valid & ~in_band
    if sdbg.shards[0].c_key.numel() and bool(sev.any()):
        keys = src[sev] * sdbg.pad_n + dst[sev]
        for s in _unique_shards(sdbg):
            s.w_cov[torch.isin(s.c_key, keys.to(s.c_key.device))] = 0.0
    return sdbg


def _unique_shards(sdbg: ShardedBandGraph) -> List[DenseBandGraph]:
    """One shard for each distinct w_cov copy (one a device)."""
    seen = {}
    for s in sdbg.shards:
        seen.setdefault(id(s.w_cov), s)
    return list(seen.values())


def fork_sharded(sdbg: ShardedBandGraph) -> ShardedBandGraph:
    """A copy whose severs leave `sdbg` as it is: each shard's base and each
    device's w_cov cloned, the graph constants shared."""
    w_cov = {id(s.w_cov): s.w_cov.clone() for s in _unique_shards(sdbg)}
    return dataclasses.replace(sdbg, shards=[
        dataclasses.replace(s, base=s.base.clone(), w_cov=w_cov[id(s.w_cov)])
        for s in sdbg.shards])


def restore_sharded(dst: ShardedBandGraph, src: ShardedBandGraph) -> ShardedBandGraph:
    """Copy src's severable tensors (base, w_cov) into dst's, in place."""
    for d, s in zip(dst.shards, src.shards):
        d.base.copy_(s.base)
        d.w_cov.copy_(s.w_cov)
    return dst
