"""Banded SpMM: neighbourhood aggregation as block-diagonal dense matmuls
(the JAX package's ops/band_spmm.py).

With a locality-ordered graph (graphs/ordering.py) most edges lie near the
diagonal, and out[v] = Σ_k band[v, k] · h[v + k - B] is a banded matmul.
With rows grouped into S-row blocks (B <= S) it splits exactly into three
batched dense matmuls per block row,

    out_i = C_i @ H_i  +  L_i @ tail_B(H_{i-1})  +  R_i @ head_B(H_{i+1}),

where C, L and R are the [S, S], [S, B] and [S, B] slices of the band.
Edges outside the band go to a COO overflow (ops/spmm_csr.py).  The dense
<-> band conversions use the flat-reshape diagonal trick (band[r, k] <->
dense[r, r + k] through a width-(S + 2B + 1) reshape), no scatter, so the
banded SDDMM of the backward (dw = g_row · h_col) is three batched matmuls
and a reshape.

These are the JAX package's own einsums, computed outside any Pallas kernel,
so the port runs them as `torch.bmm` (on the card with TF32 off: run under
utils/device.matmul_precision(True) or set_precise_matmul, as every precise
path of the port does).  `spmm_band` is differentiable in the band weights,
the overflow weights and h (`SpmmBand`, the JAX package's custom VJP); its
dh assumes a symmetric adjacency, as the JAX package's does.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mdcommunity_tpu_torch.ops.spmm_csr import (
    SortedCOO,
    build_sorted_coo,
    sddmm_sorted,
    spmm_sorted_raw,
    spmm_sorted_t,
)
from mdcommunity_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class BandGraph:
    """Banded layout of one layer's directed edges.

    n (true nodes), S (block rows), B (half bandwidth, B <= S), Wb = 2B + 1
    slots a row; overflow: the out-of-band edges' SortedCOO over pad_n rows
    (may be empty), on the graph's device.
    """

    overflow: SortedCOO
    n: int
    S: int
    B: int

    @property
    def Wb(self) -> int:
        return 2 * self.B + 1

    @property
    def n_blocks(self) -> int:
        return -(-self.n // self.S)

    @property
    def pad_n(self) -> int:
        return self.n_blocks * self.S

    @property
    def device(self) -> torch.device:
        return self.overflow.d_src.device


def build_band(
    src: np.ndarray, dst: np.ndarray, n: int, S: int = 512, B: int = 256, device=None
) -> Tuple[BandGraph, np.ndarray, np.ndarray, np.ndarray]:
    """The band layout of directed edges (out[dst] += w · h[src]), on
    `device` (CUDA unless named).

    Returns (bg, slot_row, slot_col, in_band), the last three host arrays:
      in_band  : bool[E], the edge fits the band (|src - dst| <= B)
      slot_row : int32[E_in] = dst of the in-band edges
      slot_col : int32[E_in] = src - dst + B
    The out-of-band edges keep their (src, dst) order in the overflow
    SortedCOO; `band_weights` scatters per-edge weights into the band."""
    if B > S:
        raise ValueError(f"the band half-width B={B} exceeds the block size S={S}")
    device = resolve_device(device)
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    off = src - dst
    in_band = np.abs(off) <= B
    slot_row = dst[in_band].astype(np.int32)
    slot_col = (off[in_band] + B).astype(np.int32)
    pad_n = -(-n // S) * S  # the overflow's output matches the padded band
    bg = BandGraph(overflow=build_sorted_coo(src[~in_band], dst[~in_band], pad_n, device),
                   n=int(n), S=int(S), B=int(B))
    return bg, slot_row, slot_col, in_band


def band_weights(bg: BandGraph, slot_row, slot_col, w_edges) -> torch.Tensor:
    """f32[pad_n, Wb] band of per-edge weights (duplicate slots add up, in
    edge order, on the host), on the graph's device; built once a graph."""
    wb = np.zeros((bg.pad_n, bg.Wb), np.float32)
    np.add.at(wb, (np.asarray(slot_row), np.asarray(slot_col)),
              np.asarray(w_edges, np.float32))
    return torch.from_numpy(wb).to(bg.device)


def _shift_blocks(hb: torch.Tensor, B: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """hb [nb, S, D] -> (prev_tail, next_head), each [nb, B, D]: the last B
    rows of the block before and the first B of the block after, zeros past
    the ends (no wraparound)."""
    prev_tail = F.pad(hb[:, -B:, :], (0, 0, 0, 0, 1, 0))[:-1]
    next_head = F.pad(hb[:, :B, :], (0, 0, 0, 0, 0, 1))[1:]
    return prev_tail, next_head


def _band_to_dense_blocks(wb: torch.Tensor, bg: BandGraph) -> torch.Tensor:
    """[pad_n, Wb] band -> [nb, S, S + 2B] dense block rows with entry
    (i, r, r + k) = wb[i·S + r, k] (the flat-reshape diagonal trick)."""
    S, B, Wb, nb = bg.S, bg.B, bg.Wb, bg.n_blocks
    W2 = S + 2 * B
    blk = F.pad(wb.reshape(nb, S, Wb), (0, W2 + 1 - Wb))  # width S + 2B + 1
    return blk.reshape(nb, S * (W2 + 1))[:, : S * W2].reshape(nb, S, W2)


def _dense_blocks_to_band(p: torch.Tensor, bg: BandGraph) -> torch.Tensor:
    """The inverse trick: [nb, S, S + 2B] -> [pad_n, Wb] with
    band[i·S + r, k] = p[i, r, r + k]."""
    S, B, Wb, nb = bg.S, bg.B, bg.Wb, bg.n_blocks
    W2 = S + 2 * B
    flat = F.pad(p.reshape(nb, S * W2), (0, S))  # room for the +1 stride
    return flat.reshape(nb, S, W2 + 1)[:, :, :Wb].reshape(bg.pad_n, Wb)


def spmm_band_raw(bg: BandGraph, wb: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """out = A_band @ h from the band alone (no overflow): three batched
    matmuls a block row, added in the JAX package's order (C, L, R)."""
    S, B = bg.S, bg.B
    dense = _band_to_dense_blocks(wb, bg)
    L = dense[:, :, :B]
    C = dense[:, :, B: B + S]
    R = dense[:, :, B + S:]
    hb = h[: bg.pad_n].reshape(bg.n_blocks, S, -1)
    prev_tail, next_head = _shift_blocks(hb, B)
    out = torch.bmm(C, hb)
    out = out + torch.bmm(L, prev_tail)
    out = out + torch.bmm(R, next_head)
    return out.reshape(bg.pad_n, -1)


def sddmm_band_raw(bg: BandGraph, g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """dw[v, k] = g[v] · h[v + k - B] for every band slot: three batched
    matmuls and the inverse diagonal reshape."""
    S, B = bg.S, bg.B
    gb = g[: bg.pad_n].reshape(bg.n_blocks, S, -1)
    hb = h[: bg.pad_n].reshape(bg.n_blocks, S, -1)
    prev_tail, next_head = _shift_blocks(hb, B)
    PL = torch.bmm(gb, prev_tail.transpose(1, 2))
    PC = torch.bmm(gb, hb.transpose(1, 2))
    PR = torch.bmm(gb, next_head.transpose(1, 2))
    return _dense_blocks_to_band(torch.cat([PL, PC, PR], dim=2), bg)


class SpmmBand(torch.autograd.Function):
    """out = A @ h through the band and the overflow; the backward is the
    JAX package's VJP (band_spmm.py:195-209): dh = A g (the adjacency is
    symmetric) with the overflow's part by the source-order segment sum, dw
    the banded SDDMM, dw_ov the overflow's per-edge dot."""

    @staticmethod
    def forward(ctx, bg, wb, w_ov, h):
        ctx.bg = bg
        ctx.save_for_backward(wb, w_ov, h)
        out = spmm_band_raw(bg, wb, h)
        if bg.overflow.nnz:
            out = out + spmm_sorted_raw(bg.overflow, w_ov, h)
        return out

    @staticmethod
    def backward(ctx, g):
        wb, w_ov, h = ctx.saved_tensors
        bg = ctx.bg
        g = g.contiguous()
        dh = spmm_band_raw(bg, wb, g)
        dw = sddmm_band_raw(bg, g, h)
        if bg.overflow.nnz:
            dh = dh + spmm_sorted_t(bg.overflow, w_ov, g)
            dw_ov = sddmm_sorted(bg.overflow, h, g)
        else:
            dw_ov = torch.zeros_like(w_ov)
        return None, dw, dw_ov, dh


def spmm_band(bg: BandGraph, wb: torch.Tensor, w_ov: torch.Tensor, h: torch.Tensor
              ) -> torch.Tensor:
    """out = A @ h.  wb: f32[pad_n, Wb] band weights (0 on empty slots);
    w_ov: f32[E_ov] overflow weights in destination-sorted order (an empty
    tensor when the overflow is empty); h: [pad_n, D].  Differentiable in
    (wb, w_ov, h); dh assumes a symmetric adjacency (both orientations of
    each edge stored with equal weights)."""
    return SpmmBand.apply(bg, wb, w_ov, h)


def band_live_mask(bg: BandGraph, covered: torch.Tensor) -> torch.Tensor:
    """f32[pad_n, Wb] multiplier, 1 where both endpoints of the slot are
    uncovered.  covered: bool[pad_n] (padding rows should be True)."""
    cov = covered[: bg.pad_n]
    colpad = F.pad(cov, (bg.B, bg.B), value=True)
    col_live = ~colpad.unfold(0, bg.Wb, 1)[: bg.pad_n]  # [v, k] = ~colpad[v + k]
    return ((~cov)[:, None] & col_live).to(torch.float32)
