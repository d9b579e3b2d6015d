"""Destination-sorted COO SpMM: the small sparse pieces of the band operator.

It carries the two irregular parts of a layer's adjacency that the dense band
does not hold (ops/dense_band.py): the mirror-space overflow COO and the
spill COO over all nodes.  `out[dst] += w * h[src]` runs as one segment sum
over the destination-sorted edges: each output row adds its edges in their
stored order, so the result is the same on every run (an `index_add_` on CUDA
adds with atomics, in an order that changes from run to run, and near-equal
Q values then flip between runs).

Only the forward order is kept: the eval path has no backward.  The JAX
package's source-sorted copy (for its VJP) comes with training.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SortedCOO:
    """Edges of one layer sorted by destination (stable).

    d_src/d_dst : int64[E] on the graph's device
    lengths     : int64[n] edges per output row (segment lengths)
    n           : number of output rows
    """

    d_src: torch.Tensor
    d_dst: torch.Tensor
    lengths: torch.Tensor
    n: int

    @property
    def nnz(self) -> int:
        return int(self.d_src.shape[0])


def build_sorted_coo(
    src: np.ndarray, dst: np.ndarray, n: int, device: torch.device
) -> SortedCOO:
    """Host build from directed edges; the same stable destination order as
    the JAX package's build_sorted_coo."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    od = np.argsort(dst, kind="stable")
    return SortedCOO(
        d_src=torch.from_numpy(src[od]).to(device),
        d_dst=torch.from_numpy(dst[od]).to(device),
        lengths=torch.from_numpy(np.bincount(dst, minlength=n).astype(np.int64)).to(device),
        n=int(n),
    )


def spmm_sorted(coo: SortedCOO, w_d: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """out = A @ h with per-edge weights w_d in destination-sorted order."""
    if not coo.nnz:
        return h.new_zeros((coo.n, h.shape[1]))
    return torch.segment_reduce(
        h[coo.d_src] * w_d[:, None], "sum", lengths=coo.lengths, axis=0,
        unsafe=True,
    )
