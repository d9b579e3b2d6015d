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

nibble=True stores the base at half its bytes, two window columns a byte
(byte = a[w] + 16·a[w+1] for even w, each value in [0, 7]: simple graphs),
as the JAX package's pack_band(nibble=True) does for its kernel; the port
keeps its own row layout (no column or row parity split).  Every band
kernel reads it, and gives the int8 build's bits.

The host build (numpy) gives the same arrays as the JAX package's
build_dense_band, moved to a torch device.  On top it keeps two index arrays
that the CUDA kernels and the wrapper use instead of the one-hot lanes:
`mirror_node[b, c]` (the node of mirror slot c of block b, or -1) and its
inverse `slot_of_row[b, s]` (the slot that row s of block b owns, or -1).
The band contraction itself is ops/band_kernels.spmm_band (kernel K1); the
training loss differentiates through it with BandSpmm, whose backward is K1
with the scales swapped.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from mdcommunity_tpu_torch.ops.spmm_csr import SortedCOO, build_sorted_coo, spmm_sorted
from mdcommunity_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class DenseBandGraph:
    """Block-banded dense adjacency for one layer (+ mirror lanes).

    base        : int8 [nb, S+C, W2]; rows 0..S the band values (window
                  columns cover source rows [i·S − B, i·S + S + B) mod
                  pad_n), rows S..S+C the one-hot mirror lanes, hot at column
                  B + local_row; with nibble, [nb, S+C, W2/2], columns w and
                  w + 1 (w even) in one byte (pack_nibbles)
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
    nibble: bool = False

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


def pack_nibbles(base: np.ndarray) -> np.ndarray:
    """int8 [..., W2] with values in [0, 7] -> [..., W2/2], byte = column w
    + 16·column w+1 (w even).  Refuses other values, as the JAX package's
    pack_band(nibble=True) does."""
    if base.min(initial=0) < 0 or base.max(initial=0) > 7:
        raise ValueError("nibble storage needs band values in [0, 7] (a simple graph); "
                         "build with nibble=False for heavier multi-edges")
    return (base[..., 0::2] + 16 * base[..., 1::2]).astype(np.int8)


def unpack_nibbles(base: torch.Tensor) -> torch.Tensor:
    """The inverse of pack_nibbles: [..., W2/2] -> int8 [..., W2]."""
    b = base.to(torch.int16)
    return torch.stack([b % 16, b // 16], dim=-1).flatten(-2).to(torch.int8)


def band_rows(dbg: DenseBandGraph, b0: int = 0, b1: Optional[int] = None) -> torch.Tensor:
    """The band rows of blocks [b0, b1) (all by default) as int8 [·, S, W2],
    unpacked from a nibble base."""
    band = dbg.base[b0:b1, : dbg.S]
    return unpack_nibbles(band) if dbg.nibble else band


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
    device=None,
    nibble: bool = False,
) -> DenseBandGraph:
    """Host build from directed unit-weight edges (out[dst] += h[src]);
    duplicate edges accumulate.  The edge set must be symmetric.  The arrays
    equal the JAX package's build_dense_band(w=None, dtype=int8).  The
    result lies on `device`: CUDA unless the caller names one.  nibble=True
    stores the base in nibbles (pack_nibbles; a band value above 7 raises
    ValueError)."""
    assert B <= S and S % 8 == 0 and B % 8 == 0
    device = resolve_device(device)
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
    if nibble:
        base = pack_nibbles(base)

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
        nibble=nibble,
    )


def sever_cells(S: int, B: int, pad_n: int, src: torch.Tensor, dst: torch.Tensor):
    """(blk, lr, lc, in_band) of directed edges src -> dst: the base cell
    [blk, lr, lc] of each, and whether it lies in the band, by the same
    symmetric test as band_slots (keeps Aᵀ = A)."""
    W2 = S + 2 * B
    blk = torch.div(dst, S, rounding_mode="floor")
    lr = dst - blk * S
    lc = torch.remainder(src - (blk * S - B), pad_n)
    lc_t = torch.remainder(dst - (torch.div(src, S, rounding_mode="floor") * S - B), pad_n)
    return blk, lr, lc, (lc < W2) & (lc_t < W2)


def clear_cells(base: torch.Tensor, nibble: bool, blk: torch.Tensor, lr: torch.Tensor,
                lc: torch.Tensor) -> None:
    """Zero the band cells [blk, lr, lc] of `base`, in place.  Every write
    is a set, so duplicated cells give one result.  A nibble base clears the
    cell's nibble in two parity passes, each a gather then a set
    (band_pallas.py:221-245): within a pass the entries that hit one byte
    are one cell and write one value, and the odd pass gathers the even
    pass's result, so two cells of one byte both clear.  A subtraction would
    count a duplicated sever twice."""
    if not nibble:
        base[blk, lr, lc] = 0
        return
    for parity in (0, 1):
        m = (lc % 2) == parity
        b, r, c = blk[m], lr[m], lc[m] // 2
        old = base[b, r, c].to(torch.int16)
        kept = (old // 16) * 16 if parity == 0 else old % 16
        base[b, r, c] = kept.to(torch.int8)


def sever_edges(
    dbg: DenseBandGraph, src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor
) -> DenseBandGraph:
    """Zero individual directed edges (cascade-severed), in place.

    src/dst: int [K], valid: bool [K].  In-band slots are set to zero (a
    nibble base's nibble, clear_cells); mirror and spill edges zero their
    matching weights.  Invalid entries are
    dropped with the mask before any write, and every write is a zero, so
    duplicated indices give one defined result (the JAX package instead
    redirects invalid entries to cell (0, 0, 0) and writes back the value it
    read there, which can undo a real sever of that cell)."""
    pad_n = dbg.pad_n
    src = src.to(dbg.device, torch.int64)
    dst = dst.to(dbg.device, torch.int64)
    valid = valid.to(dbg.device, torch.bool)
    blk, lr, lc, in_band = sever_cells(dbg.S, dbg.B, pad_n, src, dst)
    ib = in_band & valid
    clear_cells(dbg.base, dbg.nibble, blk[ib], lr[ib], lc[ib])

    sev = valid & ~in_band
    if bool(sev.any()):
        keys = src[sev] * pad_n + dst[sev]
        if dbg.c_key.numel():
            dbg.w_cov[torch.isin(dbg.c_key, keys)] = 0.0
        if dbg.s_key.numel():
            dbg.w_spill[torch.isin(dbg.s_key, keys)] = 0.0
    return dbg


def mirror_compact(dbg: DenseBandGraph, col: torch.Tensor, h: torch.Tensor,
                   precise: bool = True) -> torch.Tensor:
    """The mirror table's rows [nb·C, D] before the overflow SpMM:
    mir[b, c] = col[node(b, c)] · h[node(b, c)] (a gather over mirror_node),
    0 for an unused slot, in the compute dtype (col's); precise=False rounds
    it to bf16 (see mirror_sub)."""
    dt = col.dtype
    node = dbg.mirror_node.reshape(-1)
    used = node >= 0
    safe = node.clamp(min=0)
    mir = h[safe].to(dt) * col[safe, None]
    if not precise:
        mir = mir.to(torch.bfloat16).to(dt)
    return mir * used[:, None].to(dt)


def mirror_sub(dbg: DenseBandGraph, col: torch.Tensor, h: torch.Tensor,
               precise: bool = True) -> torch.Tensor:
    """The mirror-space half of the operator: compaction (mirror_compact),
    then the overflow SpMM inside the mirror table.  Returns sub [nb·C, D]
    in the compute dtype (f32 for bf16 storage), which the band kernels
    expand back through slot_of_row.  The JAX package computes the same
    outside its kernel (band_pallas.mirror_compact and the spmm_sorted that
    follows it).  precise=False gathers bf16(col ⊙ h), as the JAX package's
    XLA engine (out_ext[:, S:] of the bf16 contraction); mirror_compact's
    bf16(h)·col is the same for col in {0, 1}, the live mask of the eval."""
    if not dbg.C:
        return h.new_zeros((0, h.shape[1]), dtype=col.dtype)
    return spmm_sorted(dbg.ccoo, dbg.w_cov, mirror_compact(dbg, col, h, precise))


def spmm_dense_band(
    dbg: DenseBandGraph,
    row: torch.Tensor,
    col: torch.Tensor,
    h: torch.Tensor,
    counter: Optional[str] = None,
    precise: bool = True,
) -> torch.Tensor:
    """out = (A ⊙ row⊗col) @ h for the full stored operator (band + mirror
    overflow + spill).

    row : f32 [pad_n] destination-side scale (0 = dead node)
    col : f32 [pad_n] source-side scale
    h   : f32 [pad_n, D], or bf16 with precise=False
    The band and the mirror expansion run in kernel K1 (on the CPU its plain
    version), whose launch counts under `counter` (by default the mode's
    own); the spill COO is added after it in f32, on the unrounded col ⊙ h,
    as the JAX package does, and the result is in h's storage dtype.
    precise=False is K1's bf16 mode (ops/band_kernels.py).  Not
    differentiable: the training loss aggregates through
    spmm_dense_band_grad."""
    from mdcommunity_tpu_torch.ops.band_kernels import spmm_band

    out = spmm_band(dbg, row, col, h, mirror_sub(dbg, col, h, precise), counter, precise)
    if dbg.spill.nnz:
        hc = h.to(row.dtype) * col[:, None]
        sp = spmm_sorted(dbg.spill, dbg.w_spill, hc)
        out = (out.to(sp.dtype) + sp * row[:, None]).to(h.dtype)
    return out


def live_scales(dbg: DenseBandGraph, covered: torch.Tensor, aggregator: str = "sum",
                precise: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(row, col) scale pair of a covered-node mask (the JAX package's
    live_scales): sum gives the 0/1 liveness on both sides, mean row =
    live/live_deg and col = live, gcn live/sqrt(live_deg) on both sides.
    The live degree is one band pass at D = 1 (kernel K1, in the mode
    `precise` selects; its operands are 0/1 and its sums small integers,
    exact in either)."""
    live = (~covered[: dbg.pad_n]).to(torch.float32)
    if aggregator == "sum":
        return live, live
    if aggregator not in ("mean", "gcn"):
        raise ValueError(aggregator)
    ones = torch.ones((dbg.pad_n, 1), dtype=torch.float32, device=live.device)
    deg = spmm_dense_band(dbg, live, live, ones, precise=precise)[:, 0]
    safe = torch.clamp(deg, min=1.0)
    if aggregator == "mean":
        return live / safe, live
    s = live / torch.sqrt(safe)
    return s, s


def band_versions(dbg) -> Tuple:
    """The in-place edit counters of the tensors sever_edges writes; of
    every shard's for a ShardedBandGraph (parallel/band_partition.py), where
    a shard base that is a view shares its storage's counter."""
    if hasattr(dbg, "shards"):
        return tuple(band_versions(s) for s in dbg.shards)
    return dbg.base._version, dbg.w_cov._version, dbg.w_spill._version


def check_band_versions(dbg, versions: Tuple) -> None:
    """Raise if the band operands were edited since `versions` was taken: a
    gradient would then mix two graph states."""
    if band_versions(dbg) != versions:
        raise RuntimeError(
            "the band operands were edited (a sever) between the forward "
            "and the backward of the band operator; the gradient would be "
            "wrong"
        )


class BandSpmm(torch.autograd.Function):
    """The band operator, differentiable in h (the counterpart of the JAX
    package's dense_band custom VJP and of band_pallas's VJP of kernel K1).

    The stored operator is symmetric (band, mirror COO and spill COO all
    hold both directions of every edge, and a sever zeroes both), so with
    (R·A·C)ᵀ = C·A·R the backward is the same operator with row and col
    swapped: kernel K1 again (its nibble mode on a nibble graph), counted
    under launches["band_spmm_bwd"] (band_spmm_bwd_nib).  precise=False
    runs K1's bf16 mode both ways, the backward on bf16(row ⊙ g) as the JAX
    package's VJP at precise=False (dense_band.py:321-343,
    band_pallas.py:811-829), counted under band_spmm_bf16_bwd[_nib].  Its
    mirror and spill parts reuse the sorted segment sums, so the gradient is
    deterministic.  dbg, row and col are graph constants; the backward
    raises if the band operands or the scales were edited since the
    forward."""

    @staticmethod
    def forward(ctx, dbg, row, col, h, precise=True):
        ctx.dbg = dbg
        ctx.precise = precise
        ctx.versions = band_versions(dbg)
        ctx.save_for_backward(row, col)  # autograd checks their versions
        return spmm_dense_band(dbg, row, col, h.contiguous(), precise=precise)

    @staticmethod
    def backward(ctx, g):
        check_band_versions(ctx.dbg, ctx.versions)
        row, col = ctx.saved_tensors
        name = "band_spmm_bwd" if ctx.precise else "band_spmm_bf16_bwd"
        dh = spmm_dense_band(ctx.dbg, col, row, g.contiguous(), name, ctx.precise)
        return None, None, None, dh, None


class _BandGuard(torch.autograd.Function):
    """Identity on its tensors; its backward raises if the band operands of
    `dbgs` were edited since its forward."""

    @staticmethod
    def forward(ctx, dbgs, *xs):
        ctx.dbgs = dbgs
        ctx.versions = [band_versions(d) for d in dbgs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        for dbg, versions in zip(ctx.dbgs, ctx.versions):
            check_band_versions(dbg, versions)
        return (None, *gs)


def guard_band_operands(dbgs, *xs):
    """xs unchanged, but a backward through them raises if any of `dbgs`
    was edited after this call.  A checkpointed (recomputed) forward needs
    it: its BandSpmm calls run again in the backward and record the
    operands as they are then."""
    return _BandGuard.apply(tuple(dbgs), *xs)


def spmm_dense_band_grad(
    dbg: DenseBandGraph, row: torch.Tensor, col: torch.Tensor, h: torch.Tensor,
    precise: bool = True,
) -> torch.Tensor:
    """spmm_dense_band with a gradient for h (BandSpmm), in either mode.
    row and col must not require grad: the operator has no gradient for its
    scales."""
    if row.requires_grad or col.requires_grad:
        raise ValueError("the band operator is differentiable in h only")
    return BandSpmm.apply(dbg, row, col, h, precise)
