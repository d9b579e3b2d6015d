"""Dual-sorted COO SpMM: the sparse pieces of the band operators.

It carries the irregular parts of a layer's adjacency that a dense band does
not hold: the mirror-space overflow COO and the spill COO of
ops/dense_band.py, and the overflow of ops/band_spmm.py.  Graph structure is
static (liveness is a weight), so both edge orders are kept, as the JAX
package's spmm_csr.py keeps them:

  * destination-sorted: the forward `out[dst] += w * h[src]` is one segment
    sum over the edges in this order, so each output row adds its edges in
    their stored order and the result is the same on every run (an
    `index_add_` on CUDA adds with atomics, in an order that changes from
    run to run, and near-equal Q values then flip between runs);
  * source-sorted: the backward `dh[src] += w * g[dst]` is the same kind of
    segment sum the other way;
  * dw is the per-edge dot dw_e = h[src_e] · g[dst_e].

`spmm_sorted` is differentiable in the weights and h (`SpmmSorted`, the
JAX package's custom VJP).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SortedCOO:
    """Edges of one layer in both stable orders, on the graph's device.

    d_src/d_dst : int64[E] edges sorted by destination (forward order)
    lengths     : int64[n] edges per destination (forward segment lengths)
    s_src/s_dst : int64[E] edges sorted by source (backward order)
    s_lengths   : int64[n] edges per source (backward segment lengths)
    s2d         : int64[E] source-order position j -> destination-order index
                  (w in source order = w_d[s2d])
    n           : number of output rows
    """

    d_src: torch.Tensor
    d_dst: torch.Tensor
    lengths: torch.Tensor
    s_src: torch.Tensor
    s_dst: torch.Tensor
    s_lengths: torch.Tensor
    s2d: torch.Tensor
    n: int

    @property
    def nnz(self) -> int:
        return int(self.d_src.shape[0])

    def to(self, device) -> "SortedCOO":
        """The same COO with its index tensors on `device`."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name != "n"})


def build_sorted_coo(
    src: np.ndarray, dst: np.ndarray, n: int, device: torch.device
) -> SortedCOO:
    """Host build from directed edges; the same stable orders as the JAX
    package's build_sorted_coo."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    od = np.argsort(dst, kind="stable")
    osrc = np.argsort(src, kind="stable")
    pos_d = np.empty_like(od)
    pos_d[od] = np.arange(len(src))

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return SortedCOO(
        d_src=dev(src[od]),
        d_dst=dev(dst[od]),
        lengths=dev(np.bincount(dst, minlength=n).astype(np.int64)),
        s_src=dev(src[osrc]),
        s_dst=dev(dst[osrc]),
        s_lengths=dev(np.bincount(src, minlength=n).astype(np.int64)),
        s2d=dev(pos_d[osrc]),
        n=int(n),
    )


def _segment_sum(values: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    return torch.segment_reduce(values, "sum", lengths=lengths, axis=0, unsafe=True)


def spmm_sorted_raw(coo: SortedCOO, w_d: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """out = A @ h, the destination-order segment sum (no autograd)."""
    if not coo.nnz:
        return h.new_zeros((coo.n, h.shape[1]))
    return _segment_sum(h[coo.d_src] * w_d[:, None], coo.lengths)


def spmm_sorted_t(coo: SortedCOO, w_d: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Aᵀ @ g: dh[src] += w · g[dst], the source-order segment sum."""
    if not coo.nnz:
        return g.new_zeros((coo.n, g.shape[1]))
    return _segment_sum(g[coo.s_dst] * w_d[coo.s2d][:, None], coo.s_lengths)


def sddmm_sorted(coo: SortedCOO, h: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dw_e = h[src_e] · g[dst_e] in destination order."""
    return torch.sum(h[coo.d_src] * g[coo.d_dst], dim=-1)


class SpmmSorted(torch.autograd.Function):
    """out = A @ h with per-edge weights w_d in destination order; the
    backward is the JAX package's VJP (spmm_csr.py:79-86): dh by the
    source-order segment sum, dw by the per-edge dot."""

    @staticmethod
    def forward(ctx, coo, w_d, h):
        ctx.coo = coo
        ctx.save_for_backward(w_d, h)
        return spmm_sorted_raw(coo, w_d, h)

    @staticmethod
    def backward(ctx, g):
        w_d, h = ctx.saved_tensors
        coo = ctx.coo
        dw = sddmm_sorted(coo, h, g) if ctx.needs_input_grad[1] else None
        dh = spmm_sorted_t(coo, w_d, g) if ctx.needs_input_grad[2] else None
        return None, dw, dh


def spmm_sorted(coo: SortedCOO, w_d: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """out = A @ h with per-edge weights w_d in destination-sorted order;
    differentiable in w_d and h."""
    return SpmmSorted.apply(coo, w_d, h)
