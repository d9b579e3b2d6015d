"""Block-banded dense adjacency: the large-graph aggregation engine's storage.

After a locality ordering (graphs/ordering.py) a duplex layer's adjacency is
banded, and a banded matrix is a dense matrix in block-band storage: the
window of destination block i covers source rows [i·S − B, i·S + S + B) mod
pad_n (circular over the padded ring), so aggregation is one contraction per
S-row block against that window.  Edges outside the band go through compact
mirror lanes: each block's C extra base rows are one-hots that gather the
block's overflow-touched nodes into a [nb·C, D] mirror table, the overflow
edges run as a sorted-COO SpMM inside that small table, and the result is
expanded back through the same one-hots.  Blocks with more than C touched
rows spill to a COO over all nodes.

Adjacency values are graph constants: all per-step dynamics ride two per-node
scale vectors (w[u, v] = base[u, v] · row[dst] · col[src]), and
cascade-severed edges are edits of the base (sever_edges).

The host build (numpy) gives the same arrays as the JAX package's
build_dense_band, moved to a torch device.  On top it keeps two index arrays
that the CUDA kernels and the wrapper use instead of the one-hot lanes:
`mirror_node[b, c]` (the node of mirror slot c of block b, or -1) and its
inverse `slot_of_row[b, s]` (the slot that row s of block b owns, or -1).
The band contraction itself is ops/band_kernels.spmm_band (kernel K1).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from mdcommunity_tpu_torch.ops.spmm_csr import SortedCOO, build_sorted_coo, spmm_sorted


@dataclasses.dataclass
class DenseBandGraph:
    """Block-banded dense adjacency for one layer (+ mirror lanes).

    base        : int8 [nb, S+C, W2]; rows 0..S the band values (window
                  columns cover source rows [i·S − B, i·S + S + B) mod
                  pad_n), rows S..S+C the one-hot mirror lanes, hot at column
                  B + local_row
    mirror_node : int64 [nb, C] node of each mirror slot, -1 if unused
    slot_of_row : int32 [nb, S] mirror slot each row owns, -1 if none
    ccoo        : SortedCOO over the nb·C mirror space (overflow edges)
    w_cov       : f32 [E_ov] overflow edge values (ccoo destination order)
    c_key       : int64 [E_ov] src·pad_n + dst of each overflow edge
    spill       : SortedCOO over pad_n, edges past their block's C lanes
    w_spill     : f32 [E_spill]
    s_key       : int64 [E_spill] src·pad_n + dst of each spill edge

    sever_edges edits base, w_cov and w_spill in place.
    """

    base: torch.Tensor
    mirror_node: torch.Tensor
    slot_of_row: torch.Tensor
    ccoo: SortedCOO
    w_cov: torch.Tensor
    c_key: torch.Tensor
    spill: SortedCOO
    w_spill: torch.Tensor
    s_key: torch.Tensor
    n: int
    S: int
    B: int
    C: int

    @property
    def W2(self) -> int:
        return self.S + 2 * self.B

    @property
    def n_blocks(self) -> int:
        return -(-self.n // self.S)

    @property
    def pad_n(self) -> int:
        return self.n_blocks * self.S

    @property
    def device(self) -> torch.device:
        return self.base.device


def band_slots(
    src: np.ndarray, dst: np.ndarray, n: int, S: int, B: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(in_band, blk, local_row, local_col) for directed edges.

    An edge is in band iff BOTH directions fall inside their destination
    block's circular window; the symmetric test keeps the band matrix
    symmetric (Aᵀ = A)."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    pad_n = -(-n // S) * S
    W2 = S + 2 * B

    def fits(s, d):
        return (s - ((d // S) * S - B)) % pad_n < W2

    blk = dst // S
    lr = dst - blk * S
    lc = (src - (blk * S - B)) % pad_n
    ib = fits(src, dst) & fits(dst, src)
    return ib, blk, lr, lc


def _pow2ceil(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def build_dense_band(
    src: np.ndarray,
    dst: np.ndarray,
    n: int,
    S: int = 256,
    B: int = 128,
    max_mirror: int = 64,
    device="cpu",
) -> DenseBandGraph:
    """Host build from directed unit-weight edges (out[dst] += h[src]);
    duplicate edges accumulate.  The edge set must be symmetric.  The arrays
    equal the JAX package's build_dense_band(w=None, dtype=int8)."""
    assert B <= S and S % 8 == 0 and B % 8 == 0
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    w = np.ones(len(src), np.float32)
    nb = -(-n // S)
    pad_n = nb * S
    ib, blk, lr, lc = band_slots(src, dst, n, S, B)
    W2 = S + 2 * B
    band = np.zeros((nb, S, W2), np.float32)
    flat = (blk[ib] * S + lr[ib]) * W2 + lc[ib]
    uniq, inv = np.unique(flat, return_inverse=True)
    band.reshape(-1)[uniq] = np.bincount(inv, weights=w[ib])
    assert np.abs(band).max(initial=0) < 127, "int8 base needs small counts"
    ov_src, ov_dst, ov_w = src[~ib], dst[~ib], w[~ib]

    # mirror lanes: rank of each overflow-touched row within its block
    touched = np.unique(np.concatenate([ov_src, ov_dst]))
    tblk = touched // S
    rank = np.zeros(len(touched), np.int64)
    if len(touched):
        starts = np.flatnonzero(np.r_[True, tblk[1:] != tblk[:-1]])
        rank = np.arange(len(tblk)) - np.repeat(
            starts, np.diff(np.r_[starts, len(tblk)])
        )
    max_count = int(rank.max(initial=-1)) + 1
    C = min(_pow2ceil(max(max_count, 1)), max_mirror) if len(touched) else 0

    slotted = rank < C
    slot_of_node = np.full(pad_n, -1, np.int64)
    slot_of_node[touched[slotted]] = tblk[slotted] * C + rank[slotted]
    mirror_node = np.full((nb, max(C, 0)), -1, np.int64)
    mirror_node[tblk[slotted], rank[slotted]] = touched[slotted]
    slot_of_row = np.full((nb, S), -1, np.int32)
    slot_of_row[tblk[slotted], touched[slotted] - tblk[slotted] * S] = rank[slotted]

    cs = slot_of_node[ov_src]
    cd = slot_of_node[ov_dst]
    ok = (cs >= 0) & (cd >= 0)
    order = np.argsort(cd[ok], kind="stable")
    ccoo = build_sorted_coo(cs[ok][order], cd[ok][order], max(nb * C, 1), device)
    c_src, c_dst = ov_src[ok][order], ov_dst[ok][order]

    sp_s, sp_d, sp_w = ov_src[~ok], ov_dst[~ok], ov_w[~ok]
    sorder = np.argsort(sp_d, kind="stable")
    spill = build_sorted_coo(sp_s[sorder], sp_d[sorder], pad_n, device)

    lanes = np.zeros((nb, C, W2), np.int8)
    lanes[tblk[slotted], rank[slotted], B + touched[slotted] - tblk[slotted] * S] = 1
    base = np.concatenate([band.astype(np.int8), lanes], axis=1)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return DenseBandGraph(
        base=dev(base),
        mirror_node=dev(mirror_node),
        slot_of_row=dev(slot_of_row),
        ccoo=ccoo,
        w_cov=dev(ov_w[ok][order]),
        c_key=dev(c_src * pad_n + c_dst),
        spill=spill,
        w_spill=dev(sp_w[sorder]),
        s_key=dev(sp_s[sorder] * pad_n + sp_d[sorder]),
        n=n,
        S=S,
        B=B,
        C=C,
    )


def sever_edges(
    dbg: DenseBandGraph, src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor
) -> DenseBandGraph:
    """Zero individual directed edges (cascade-severed), in place.

    src/dst: int [K], valid: bool [K].  In-band slots are set to zero;
    mirror and spill edges zero their matching weights.  Invalid entries are
    dropped with the mask before any write, and every write is a zero, so
    duplicated indices give one defined result (the JAX package instead
    redirects invalid entries to cell (0, 0, 0) and writes back the value it
    read there, which can undo a real sever of that cell)."""
    S, B, pad_n, W2 = dbg.S, dbg.B, dbg.pad_n, dbg.W2
    src = src.to(dbg.device, torch.int64)
    dst = dst.to(dbg.device, torch.int64)
    valid = valid.to(dbg.device, torch.bool)
    blk = torch.div(dst, S, rounding_mode="floor")
    lr = dst - blk * S
    lc = torch.remainder(src - (blk * S - B), pad_n)
    # the same symmetric in-band test as band_slots (keeps Aᵀ = A)
    lc_t = torch.remainder(dst - (torch.div(src, S, rounding_mode="floor") * S - B), pad_n)
    in_band = (lc < W2) & (lc_t < W2)
    ib = in_band & valid
    dbg.base[blk[ib], lr[ib], lc[ib]] = 0

    sev = valid & ~in_band
    if bool(sev.any()):
        keys = src[sev] * pad_n + dst[sev]
        if dbg.c_key.numel():
            dbg.w_cov[torch.isin(dbg.c_key, keys)] = 0.0
        if dbg.s_key.numel():
            dbg.w_spill[torch.isin(dbg.s_key, keys)] = 0.0
    return dbg


def mirror_sub(dbg: DenseBandGraph, col: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The mirror-space half of the operator: compaction
    mir[b, c] = col[node(b, c)] · h[node(b, c)] (a gather over mirror_node),
    then the overflow SpMM inside the mirror table.  Returns sub [nb·C, D],
    which the band kernels expand back through slot_of_row.  The JAX
    package computes the same outside its kernel (band_pallas.mirror_compact
    and the spmm_sorted that follows it)."""
    D = h.shape[1]
    if not dbg.C:
        return h.new_zeros((0, D))
    node = dbg.mirror_node.reshape(-1)
    used = node >= 0
    safe = node.clamp(min=0)
    mir = (h[safe] * col[safe, None]) * used[:, None].to(h.dtype)
    return spmm_sorted(dbg.ccoo, dbg.w_cov, mir)


def spmm_dense_band(
    dbg: DenseBandGraph, row: torch.Tensor, col: torch.Tensor, h: torch.Tensor
) -> torch.Tensor:
    """out = (A ⊙ row⊗col) @ h for the full stored operator (band + mirror
    overflow + spill), in f32.

    row : f32 [pad_n] destination-side scale (0 = dead node)
    col : f32 [pad_n] source-side scale
    h   : f32 [pad_n, D]
    The band and the mirror expansion run in kernel K1 (on the CPU its plain
    version); the spill COO is added after it, as the JAX package does."""
    from mdcommunity_tpu_torch.ops.band_kernels import spmm_band

    out = spmm_band(dbg, row, col, h, mirror_sub(dbg, col, h))
    if dbg.spill.nnz:
        sp = spmm_sorted(dbg.spill, dbg.w_spill, h * col[:, None])
        out = out + sp * row[:, None]
    return out
