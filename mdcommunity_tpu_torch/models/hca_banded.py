"""HCA-Dismantler's large-graph forward: band-operator pooling and
fixed-order community sums (the JAX package's models/hca_banded.py).

The dense HCA path (models/hca.py) materialises [2, N, N] adjacency and
[2, C, N] membership, O(N²) memory, out of reach at the reference's
14k–18k-node real datasets (HCA-Dismantler/testReal.py:27-68).  This
module computes the same math with large-graph operands:

  * adjacency pooling  A_live @ h      the band operator (kernel K1 on the
    card, ops/dense_band.spmm_dense_band), rank-1 liveness scales
  * community pooling  member @ h      a sum over each community's nodes of
    (f_roi + 1e-6)·h, in a fixed order: the nodes sorted once by community
    (comm_id is static for a graph), each community summed in node order
    (torch.segment_reduce), so a relaunch gives the same bits and a near-tie
    ranks the same way each time; the JAX package's segment_sum
  * community graph    (Mᵀ A_live M > 0) with self loops, the only form
    the head uses: one hand-written CUDA pass a layer over the stored live
    edges (ops/hca_kernels.comm_adj -> csrc/hca.cu), which stores 1 at each
    live inter-community pair and writes the diagonal; binarised + self
    loops as comm_adj_construct (:491-541).  It reads the storage that K1
    reads and severs edit, so it is exact and independent of thread order.
    Its launches count under ops/hca_kernels.launches["hca_comm_adj"].
    community_graph, the counts Mᵀ(A_live M) by K1 on the one-hot
    membership, is kept as the pass's independent check
  * decoder broadcast  memberᵀ ops     per-node gathers from [c_pad, *] tables

The JAX package's banded_hca_forward_packed has no counterpart, for the
reason models/net_packed.py has none: the port's kernels read
DenseBandGraph.base directly, so there is no packed layout to run.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from mdcommunity_tpu_torch.models.hca import HcaQNet, hca_decode, hca_head
from mdcommunity_tpu_torch.ops import hca_kernels
from mdcommunity_tpu_torch.ops.aggregate import l2_normalize
from mdcommunity_tpu_torch.ops.dense_band import spmm_dense_band
from mdcommunity_tpu_torch.utils.device import resolve_device
from mdcommunity_tpu_torch.utils.profiling import span

COMM_CHUNK = 256  # K1's widest right-hand side (csrc/band.cu)


@dataclasses.dataclass(frozen=True)
class HcaBandData:
    """Static HCA node data in BANDED (locality-ordered, padded) node order.

    comm_id  : int64[2, pad_n] community index (padding rows 0)
    n_comms  : (int, int)      real community counts
    hca_feat : f32[pad_n, 3]   [f_het, f_impact, f_roi] (padding rows 0)
    c_pad    : int             the community tables' rows
    order    : int64[2, pad_n] nodes sorted by community (stable), a layer
    lengths  : int64[2, c_pad] nodes a community, a layer
    """

    comm_id: torch.Tensor
    n_comms: Tuple[int, int]
    hca_feat: torch.Tensor
    c_pad: int
    order: torch.Tensor
    lengths: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.hca_feat.device


def make_hca_band_data(comm_id: np.ndarray, n_comms: np.ndarray, hca_feat: np.ndarray,
                       perm: np.ndarray, pad_n: int, c_pad: Optional[int] = None,
                       device=None) -> HcaBandData:
    """Permute the host's HCA arrays (graphs/hca.py, original ids, length n)
    into banded order and pad to pad_n; perm maps banded position ->
    original id (build_banded_duplex's).  c_pad defaults to the least power
    of two >= 8 that holds every layer's communities; a c_pad that holds
    fewer raises (the tables would merge communities).  On `device`,
    CUDA unless named."""
    device = resolve_device(device)
    n = len(perm)
    if c_pad is None:
        c_pad = 8
        while c_pad < int(np.max(n_comms, initial=1)):
            c_pad *= 2
    cid = np.zeros((2, pad_n), np.int64)
    cid[:, :n] = np.asarray(comm_id, np.int64)[:, perm]
    most = max(int(np.max(n_comms, initial=0)), int(cid.max(initial=0)) + 1)
    if most > c_pad:
        raise ValueError(f"c_pad {c_pad} holds fewer than a layer's {most} communities")
    feat = np.zeros((pad_n, 3), np.float32)
    feat[:n] = np.asarray(hca_feat, np.float32)[perm]
    order = np.argsort(cid, axis=1, kind="stable")
    lengths = np.stack([np.bincount(c, minlength=c_pad) for c in cid])

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return HcaBandData(comm_id=t(cid), n_comms=tuple(int(c) for c in n_comms),
                       hca_feat=t(feat), c_pad=int(c_pad), order=t(order), lengths=t(lengths))


def community_sum(hd: HcaBandData, layer: int, x: torch.Tensor) -> torch.Tensor:
    """Σ over each community's nodes of x's rows, [c_pad, D]: the nodes in
    community order, each community summed in node order (a fixed order on
    every device)."""
    return torch.segment_reduce(x[hd.order[layer]], "sum", lengths=hd.lengths[layer],
                                axis=0)


def community_graph(bdx, hd: HcaBandData, layer: int, live: torch.Tensor,
                    precise: bool = True) -> torch.Tensor:
    """The live community graph Mᵀ(A_live M) [c_pad, c_pad] (counts of live
    edges between communities): K1 on the one-hot membership, COMM_CHUNK
    columns a launch.  The forward no longer runs it: this K1 form is kept
    as the independent check of ops/hca_kernels.comm_adj, which must equal
    (community_graph(...) > 0) · (1 − I) + I · real bit for bit."""
    counter = "band_spmm_comm" if precise else "band_spmm_comm_bf16"
    cid = hd.comm_id[layer]
    cols = []
    for c0 in range(0, hd.c_pad, COMM_CHUNK):
        ids = torch.arange(c0, min(c0 + COMM_CHUNK, hd.c_pad), device=cid.device)
        onehot = (cid[:, None] == ids[None, :]).to(live.dtype)
        am = spmm_dense_band(bdx.dbg(layer), live, live, onehot, counter, precise)
        cols.append(community_sum(hd, layer, am))
    return torch.cat(cols, dim=1)


@torch.no_grad()
def banded_hca_forward(net: HcaQNet, bdx, hd: HcaBandData, covered: torch.Tensor,
                       max_bp_iter: int = 3, top_frac: float = 0.3, precise: bool = True,
                       ref_quirks: bool = False, row: Optional[dict] = None) -> torch.Tensor:
    """Q(s, ·) over all nodes of a BandedDuplex with HCA heads: [pad_n];
    dead nodes -inf.  The math of models/hca.hca_forward at B = 1 (see its
    docstring for ref_quirks).  precise=False runs K1's bf16 mode for the
    node pooling, as the JAX package's precise flag does; the community
    pass (ops/hca_kernels.comm_adj) is exact in either mode; the dense
    layers run at the caller's matmul precision
    (utils/device.matmul_precision).  Spans (utils/profiling.span) into
    `row`: hca_node_pool (the rounds' pooling, K1 over the node adjacency
    and the community sums), hca_comm_graph (the community pass) and
    hca_decode (the decoder and the gate)."""
    row = {} if row is None else row
    c_pad = hd.c_pad
    # HCA keeps isolated survivors active (PrepareBatchGraph :49-58)
    active = (~covered) & bdx.node_mask
    live = active.to(net.w_n2l.dtype)
    feat = hd.hca_feat.to(live.dtype)
    node_input = torch.where(active[:, None], feat, torch.zeros_like(feat))
    h0 = l2_normalize(torch.relu(node_input @ net.w_n2l))
    member_w = torch.where(active, feat[:, 2] + 1e-6, torch.zeros_like(live))

    def pools(layer):
        def comm_adj():
            with span(row, "hca_comm_graph"):
                return hca_kernels.comm_adj(bdx.dbg(layer), hd.comm_id[layer], active,
                                            hd.n_comms[layer], c_pad, live.dtype)

        def node_pool(h):
            with span(row, "hca_node_pool"):
                return spmm_dense_band(bdx.dbg(layer), live, live, h, precise=precise)

        def comm_pool(h):
            with span(row, "hca_node_pool"):
                return community_sum(hd, layer, member_w[:, None] * h)

        return node_pool, comm_pool, comm_adj

    real = torch.stack([torch.arange(c_pad, device=live.device) < k for k in hd.n_comms])
    hf, y_f = hca_head(net, h0, node_input[:, 0:1], c_pad, pools, max_bp_iter)
    h_f = hf * active[None, :, None]

    def member_q(layer, mask, y):
        cid = hd.comm_id[layer]
        return member_w * mask[cid], member_w[:, None] * y[cid]

    with span(row, "hca_decode"):
        return hca_decode(net, h_f, y_f, real, member_q, active, top_frac, ref_quirks)
