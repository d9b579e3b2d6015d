"""Neighbourhood aggregation over edge lists, and row-wise helpers.

The reference's hot operation is `torch_sparse.spmm(index, value, m, n, H)`
(MultiDismantler_net_graphsage.py:139,146,199,290,297,350,377).  The JAX
package's ops/aggregate.py has two regimes, kept here:

* small graphs (training: 30-50 nodes): the live adjacency as a dense
  [N, N] matrix (`dense_adjacency`), and A @ H as one batched matmul;
* larger graphs: a per-edge segment sum (`segment_spmm`).  The port's form
  is destination-sorted: each output row adds its edges in their stored
  order, so the result is the same on every run (an `index_add_` on CUDA
  adds with atomics, in an order that changes from run to run).

Edge weights follow the reference's aggregators
(PrepareBatchGraph.n2n_construct :236-245): 0 = sum (w = 1), 1 = mean
(w = 1/deg_dst), 2 = GCN norm (w = 1/sqrt((deg_u+1)(deg_v+1))).
All functions take edge arrays with any leading (batch) axes.
"""

from __future__ import annotations

import math

import torch


def _flat(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Indices [..., E] into rows of n -> indices into the flattened
    leading axes' rows, [prod(...) · E]."""
    lead = idx.reshape(-1, idx.shape[-1])
    offs = torch.arange(lead.shape[0], device=idx.device)[:, None] * n
    return (lead + offs).reshape(-1)


def dense_adjacency(src, dst, weight, pad_n: int) -> torch.Tensor:
    """COO (src, dst, weight) [..., E] -> dense [..., pad_n, pad_n] with
    A[dst, src] += w: row i aggregates into node i.  Padding edges carry
    w = 0 and real edges are unique, so every cell sums at most one nonzero
    and the result is exact in any order."""
    lead = src.shape[:-1]
    cell = _flat(dst * pad_n + src, pad_n * pad_n)
    a = torch.zeros(math.prod(lead) * pad_n * pad_n,
                    dtype=weight.dtype, device=weight.device)
    a.index_put_((cell,), weight.reshape(-1), accumulate=True)
    return a.reshape(lead + (pad_n, pad_n))


def segment_spmm(src, dst, weight, h, pad_n: int) -> torch.Tensor:
    """Sparse A @ H as a destination-sorted segment sum: out[dst] += w·h[src].

    src, dst, weight [..., E]; h [..., pad_n, D] -> [..., pad_n, D].  The
    weight already encodes the aggregator's normalisation and the edge's
    liveness (0 for dead and padding edges)."""
    D = h.shape[-1]
    fs, fd = _flat(src, pad_n), _flat(dst, pad_n)
    order = torch.argsort(fd, stable=True)
    msg = h.reshape(-1, D)[fs[order]] * weight.reshape(-1)[order, None]
    lengths = torch.bincount(fd, minlength=h.numel() // D)
    out = torch.segment_reduce(msg, "sum", lengths=lengths, axis=0, unsafe=True)
    return out.reshape(h.shape)


def spmm_coo(src, dst, weight, h, pad_n: int) -> torch.Tensor:
    """The COO SpMM entry point: segment_spmm.  (The blocked-pair kernel K4
    is ops/blocked_kernels.spmm_block over a BlockCOO.)"""
    return segment_spmm(src, dst, weight, h, pad_n)


def edge_weights(src, dst, live, pad_n: int, aggregator_id: int = 0) -> torch.Tensor:
    """Aggregation weights per directed edge [..., E] (0 where dead)."""
    w = live.to(torch.float32)
    if aggregator_id == 0:
        return w
    lead = w.shape[:-1]
    deg = torch.zeros(lead + (pad_n,), dtype=w.dtype, device=w.device)
    deg.scatter_add_(-1, dst, w)
    if aggregator_id == 1:
        return w / torch.clamp(torch.gather(deg, -1, dst), min=1.0)
    if aggregator_id == 2:
        return w / torch.sqrt((torch.gather(deg, -1, src) + 1.0)
                              * (torch.gather(deg, -1, dst) + 1.0))
    raise ValueError(f"unknown aggregator_id {aggregator_id}")


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row-wise L2 normalization over the last axis, x * rsqrt(max(Σx², eps²)):
    torch.nn.functional.normalize's value, with zero rows staying zero (the
    JAX package's form, kept for parity)."""
    sq = torch.sum(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=eps * eps))
