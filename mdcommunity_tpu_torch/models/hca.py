"""HCA-Dismantler: the hierarchical community-aware Q-network, batched and
masked (the JAX package's models/hca.py).

Reference: HCA-Dismantler/MultiDismantler_net_graphsage.py (train_forward
:112-305).  Differences from the base model:

  * input = static HCA node features [f_het, f_impact, f_roi] ([N, 3], shared
    by both layers), with a cross-layer heterogeneity bias
    h_l += 5·f_het·h before message passing (:160-166)
  * virtual nodes are COMMUNITIES (Louvain per layer), pooled with
    f_roi + 1e-6 weights (HCA PrepareBatchGraph.subg_construct :442-473)
  * a macro community-GCN after the rounds:
    Y = l2n(relu((A_comm @ Y) @ w_macro)) with A_comm built from live
    inter-community edges + self loops (comm_adj_construct :491-541)
  * cross-layer fusion (BitwiseMultipyLogis) over node and community rows,
    WITHOUT the base net's post-fusion re-normalization (:208-222)
  * divide-and-conquer decoder: per-layer community scores against the mean
    community embedding, the top 30% of communities projected to their
    nodes, node Q = [h_u ; f_roi·h_comm(u)] @ w_micro_score with unselected
    nodes at -1e9 (:234-278); a per-layer softmax gate from the mean
    community embedding (:283-295)
  * the aux features and the base Q head (h1/h2/cross_product) are unused.

The JAX package's documented choices hold here too: the decoder's mean and
top-k run per graph; active nodes are all uncovered nodes (HCA keeps
isolated survivors); the true membership matrix, not the reference's
collapsed one.  The community ranking is a stable sort (jnp.argsort's), so
equal scores keep index order.

The products are torch.matmul / einsum, as they are XLA products in the
JAX package; the large-graph forward (models/hca_banded.py) runs the band
operator, kernel K1, for the node and community pooling.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple, Union

import numpy as np
import torch

from mdcommunity_tpu_torch.env.cascade import endpoints_alive
from mdcommunity_tpu_torch.models.fusion import bitwise_logis_fuse
from mdcommunity_tpu_torch.models.net import DuplexQNet, _param, init_params
from mdcommunity_tpu_torch.ops.aggregate import dense_adjacency, l2_normalize
from mdcommunity_tpu_torch.parallel.mesh import add_in_order, gather_parts

HCA_HEADS = ("w_macro", "w_comm_score", "w_micro_score")


class HcaQNet(DuplexQNet):
    """DuplexQNet's parameters (w_n2l [3, D]) and the HCA heads w_macro
    [D, D], w_comm_score and w_micro_score [2D, 1].  h1_weight, h2_weight
    and cross_product are kept for the checkpoint's shape, unused."""

    def __init__(self, params: Mapping[str, Union[np.ndarray, Mapping]]):
        super().__init__(params)
        for k in HCA_HEADS:
            self.register_parameter(k, _param(params[k]))

    def forward(self, *args, **kwargs):
        raise TypeError("HcaQNet runs through models/hca.hca_forward or "
                        "models/hca_banded.banded_hca_forward")


def init_hca_params(generator: torch.Generator, embedding_size: int = 64,
                    reg_hidden: int = 32, aux_dim: int = 4, gate_hidden: int = 128,
                    w_init_std: float = 1.0) -> Dict:
    """The base parameter tree with a 3-wide input and the HCA heads (the
    JAX package's init_hca_params: the same distributions, other draws)."""
    p = init_params(generator, embedding_size=embedding_size, reg_hidden=reg_hidden,
                    aux_dim=aux_dim, node_feat_dim=3, gate_hidden=gate_hidden,
                    w_init_std=w_init_std)
    d = embedding_size

    def normal(*shape):
        return torch.fmod(torch.randn(shape, generator=generator) * w_init_std, 2.0).numpy()

    p["w_macro"] = normal(d, d)
    p["w_comm_score"] = normal(2 * d, 1)
    p["w_micro_score"] = normal(2 * d, 1)
    return p


@dataclasses.dataclass(frozen=True)
class HcaInputs:
    """Operands for a batch of HCA states (leading axis B).

    adj        : f32[B, 2, N, N]   live adjacency
    member     : f32[B, 2, C, N]   f_roi-weighted community membership (active)
    comm_adj   : f32[B, 2, C, C]   live community graph + self loops
    comm_real  : bool[B, 2, C]     community index < n_comms
    active     : bool[B, N]        uncovered nodes
    node_input : f32[B, N, 3]      masked HCA features
    deg        : f32[B, 2, N]      live degrees (Laplacian loss)
    n_dir_live : f32[B, 2]
    """

    adj: torch.Tensor
    member: torch.Tensor
    comm_adj: torch.Tensor
    comm_real: torch.Tensor
    active: torch.Tensor
    node_input: torch.Tensor
    deg: torch.Tensor
    n_dir_live: torch.Tensor


def make_hca_inputs(g, covered: torch.Tensor, sever: torch.Tensor, c_pad: int) -> HcaInputs:
    """HcaInputs of a batched DuplexGraph in states (covered [B, N], sever
    [B, 2, E]).  Every cell of member and comm_adj receives at most one
    nonzero (each node lies in one community; comm_adj is binarised), so
    they are exact in any order.  The operands take hca_feat's dtype (f32;
    f64 for a float64 reference run)."""
    B, pad_n = covered.shape
    dt = g.hca_feat.dtype
    live = g.edge_mask & ~sever & endpoints_alive(g.src, g.dst, covered)  # [B, 2, E]
    w = live.to(dt)
    deg = torch.zeros(w.shape[:-1] + (pad_n,), dtype=dt, device=w.device).scatter_add_(
        -1, g.src, w)
    active = (~covered) & g.node_mask
    adj = dense_adjacency(g.src, g.dst, w, pad_n)

    f_roi = g.hca_feat[..., 2]
    member_w = torch.where(active, f_roi + 1e-6, torch.zeros_like(f_roi))      # [B, N]
    cid = torch.clamp(g.comm_id, 0, c_pad - 1)                                 # [B, 2, N]
    member = torch.zeros(B, 2, c_pad, pad_n, dtype=dt, device=w.device).scatter_add_(
        2, cid[:, :, None, :], member_w[:, None, None, :].expand(B, 2, 1, pad_n))
    comm_real = torch.arange(c_pad, device=w.device) < g.n_comms[..., None]   # [B, 2, C]

    # live inter-community edges, binarised, and self loops on real communities
    cell = torch.gather(cid, 2, g.dst) * c_pad + torch.gather(cid, 2, g.src)
    a = torch.zeros(B, 2, c_pad * c_pad, dtype=dt, device=w.device).scatter_add_(2, cell, w)
    a = (a > 0).to(dt).reshape(B, 2, c_pad, c_pad)
    eye = torch.eye(c_pad, dtype=dt, device=w.device)
    comm_adj = a * (1.0 - eye) + eye * comm_real[..., None].to(dt)

    node_input = torch.where(active[..., None], g.hca_feat, torch.zeros_like(g.hca_feat))
    return HcaInputs(adj=adj, member=member, comm_adj=comm_adj, comm_real=comm_real,
                     active=active, node_input=node_input, deg=deg,
                     n_dir_live=torch.sum(w, dim=-1))


def _sage(net, pool, h):
    """One round's dense layer: l2n(relu([pool @ c1 ; h @ c2] @ c3))."""
    h_new = torch.cat([pool @ net.p_node_conv, h @ net.p_node_conv2], -1)
    return l2_normalize(torch.relu(h_new @ net.p_node_conv3))


def hca_head(net: HcaQNet, h0: torch.Tensor, f_het: torch.Tensor, c_pad: int,
             pools, max_bp_iter: int):
    """The per-layer rounds, the community GCN and the fusion, shared by the
    dense and the banded forward: pools(layer) gives (node_pool(h),
    comm_pool(h), comm_adj) for a layer.  h0 [..., N, D], f_het [..., N, 1].
    Returns (fused node rows [2, ..., N, D], fused community rows [2, ..., C, D])."""
    d = net.embedding_size
    y0 = l2_normalize(torch.relu(torch.ones(3, dtype=h0.dtype, device=h0.device) @ net.w_n2l))
    node_embs, comm_embs = [], []
    for layer in range(2):
        node_pool, comm_pool, comm_adj = pools(layer)
        h = h0 + 5.0 * f_het * h0
        y = y0.expand(h0.shape[:-2] + (c_pad, d))
        for _ in range(max_bp_iter):
            pool, ypool = node_pool(h), comm_pool(h)
            h = _sage(net, pool, h)
            y = _sage(net, ypool, y)
        y = l2_normalize(torch.relu((comm_adj() @ y) @ net.w_macro))
        node_embs.append(h)
        comm_embs.append(y)
    fp = net.fusion_params()
    hf = torch.stack(bitwise_logis_fuse(fp, node_embs[0], node_embs[1]))
    yf = torch.stack(bitwise_logis_fuse(fp, comm_embs[0], comm_embs[1]))
    return hf, yf


def top_communities(scores: torch.Tensor, real: torch.Tensor, n_real: torch.Tensor,
                    top_frac: float) -> torch.Tensor:
    """The decoder's community mask [..., C]: the k_top = max(1, ⌊n_real ·
    top_frac⌋) (in f32, as JAX forms it) best-scoring real communities,
    equal scores in index order (a stable sort, jnp.argsort's)."""
    c_pad = scores.shape[-1]
    k_top = torch.clamp(
        (n_real.to(torch.float32) * torch.tensor(top_frac, dtype=torch.float32))
        .to(torch.int32), min=1)
    order = torch.argsort(-scores, dim=-1, stable=True)
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(c_pad, device=scores.device).expand_as(order).contiguous())
    return (rank < k_top[..., None]) & real


def hca_decode(net: HcaQNet, h_f, y_f, real, member_q, active, top_frac: float,
               ref_quirks: bool):
    """The divide-and-conquer decoder on fused rows h_f [2, ..., N, D] and
    y_f [2, ..., C, D]: real [2, ..., C] marks real communities and
    member_q(layer, mask, y) gives (node_sel [..., N], h_comm_b [..., N, D])
    for a community mask and table.  Returns Q [..., N], -inf off active."""
    c_pad = y_f.shape[-2]
    q_layers, gates = [], []
    for layer in range(2):
        y, re = y_f[layer], real[layer]
        n_real = torch.clamp(torch.sum(re, dim=-1), min=1)
        y_masked = y * re[..., None]
        h_global = torch.sum(y_masked, dim=-2) / n_real[..., None].to(y.dtype)
        score_in = torch.cat([y, h_global[..., None, :].expand_as(y)], -1)
        scores = (score_in @ net.w_comm_score)[..., 0]
        scores = torch.where(re, scores, torch.full_like(scores, -float("inf")))
        comm_mask = top_communities(scores, re, n_real, top_frac)
        node_sel, h_comm_b = member_q(layer, comm_mask.to(y.dtype), y)
        q_raw = (torch.cat([h_f[layer], h_comm_b], -1) @ net.w_micro_score)[..., 0]
        q_layers.append(torch.where(node_sel > 0, q_raw, torch.full_like(q_raw, -1e9)))
        # the reference gate averages all c_pad post-fusion rows, padding
        # included (HCA net :283-295); the default, the real ones
        gate_in = torch.sum(y, dim=-2) / float(c_pad) if ref_quirks else h_global
        gates.append((torch.relu(gate_in @ net.w_layer1) @ net.w_layer2)[..., 0])
    wsm = torch.softmax(torch.stack(gates), dim=0)
    q = wsm[0][..., None] * q_layers[0] + wsm[1][..., None] * q_layers[1]
    return torch.where(active, q, torch.full_like(q, -float("inf")))


def hca_forward(net: HcaQNet, inputs: HcaInputs, max_bp_iter: int = 3,
                top_frac: float = 0.3, ref_quirks: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Q over all nodes of a batch: (q_all [B, N] with -inf at dead nodes,
    fused node embeddings [2, B, N, D] for the Laplacian loss).

    ref_quirks=True replicates the reference net's layer-gate quirk (its
    gate averages all c_pad post-fusion community rows, the padding that
    fusion has made non-zero included, HCA net :283-295), for exact-parity
    tests; the default averages the real communities, as the decoder does."""
    c_pad = inputs.member.shape[2]
    x = inputs.node_input
    h0 = l2_normalize(torch.relu(x @ net.w_n2l))

    def pools(layer):
        return (lambda h: torch.matmul(inputs.adj[:, layer], h),
                lambda h: torch.matmul(inputs.member[:, layer], h),
                lambda: inputs.comm_adj[:, layer])

    hf, y_f = hca_head(net, h0, x[..., 0:1], c_pad, pools, max_bp_iter)
    h_f = hf * inputs.active[None, :, :, None]

    def member_q(layer, mask, y):
        m = inputs.member[:, layer]
        return (torch.einsum("bcn,bc->bn", m, mask), torch.einsum("bcn,bcd->bnd", m, y))

    q = hca_decode(net, h_f, y_f, inputs.comm_real.transpose(0, 1), member_q,
                   inputs.active, top_frac, ref_quirks)
    return q, h_f


def hca_laplacian(h_f: torch.Tensor, inputs: HcaInputs, mesh=None) -> torch.Tensor:
    """The base trainer's Laplacian embedding regularizer over the live
    subgraphs (HCA calc_loss mirrors the base): Σ_l 2(Σ deg·|h|² − Σ h·Ah)
    / max(directed live edges, 1).  With a dp mesh, this replica's part:
    its rows' terms over the whole batch's directed live edges."""
    total = 0.0
    for layer in range(2):
        h = h_f[layer]
        quad = torch.sum(inputs.deg[:, layer] * torch.sum(h * h, dim=-1))
        cross = torch.sum(h * torch.matmul(inputs.adj[:, layer], h))
        count = torch.sum(inputs.n_dir_live[:, layer])
        if mesh is not None:
            count = add_in_order(gather_parts(mesh, [count], "dp"))
        denom = torch.clamp(count, min=1.0)
        total = total + 2.0 * (quad - cross) / denom
    return total
