"""The duplex dismantling Q-network: banded large-graph eval forward.

The model family is the reference's (MultiDismantler_net_graphsage.py): per
duplex layer, 3 rounds of GraphSAGE-style message passing with a virtual
node, cross-layer fusion, then a bilinear state-action Q head with a learned
per-layer softmax gate.

Math map (reference file:line):
  input           x_l = deg/maxdeg duplicated         net :102-111
  embed init      H0 = l2n(relu(x @ w_n2l))           net :113-130
  virtual init    Y0 = l2n(relu([1,1] @ w_n2l))       net :121-136
  rounds (×3)     pool = A_l @ H                      net :139-140
                  H' = l2n(relu([pool@c1 ; H@c2]@c3)) net :143-159
                  ypool = Σ_active H                  net :146-150
                  Y' = l2n(relu([ypool@c1; Y@c2]@c3)) net :150-169
  fusion          BitwiseMultipyLogis, then l2n       net :176-186
  Q (test)        e = H_f[l] * (Y_f[l]·cross)         net :343-393
                  q_l = [relu(e@h1) ; aux_l] @ h2
                  gate_l = softmax_l(relu(Y_f[l]@W1)@W2)

This slice ports the banded eval forward (`banded_test_forward`), where the
aggregation A_l @ H is the dense-band operator of ops/dense_band.py.  With
fuse_sage=True each round runs as one fused SAGE step (kernel K2): the
concat-matmul algebra concat(pool@c1, H@c2)@c3 = pool@(c1@c3[:d]) +
H@(c2@c3[d:]) lets the dense layer and the normalisation ride the pooled
tile.  Dead nodes get -inf.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch
from torch import nn

from mdcommunity_tpu_torch.models.fusion import fuse
from mdcommunity_tpu_torch.ops.aggregate import l2_normalize
from mdcommunity_tpu_torch.ops.band_kernels import sage_step
from mdcommunity_tpu_torch.ops.dense_band import mirror_sub, spmm_dense_band

_DENSE = (
    "w_n2l", "p_node_conv", "p_node_conv2", "p_node_conv3", "h1_weight",
    "h2_weight", "cross_product", "w_layer1", "w_layer2",
)


class DuplexQNet(nn.Module):
    """The Q-network's parameters (the JAX package's parameter tree, one
    tensor each; fusion parameters under `fusion`) and its banded forward.
    Eval only: parameters do not require grad."""

    def __init__(self, params: Mapping[str, Union[np.ndarray, Mapping]]):
        super().__init__()
        for k in _DENSE:
            self.register_parameter(k, _param(params[k]))
        self.fusion = nn.ParameterDict(
            {k: _param(v) for k, v in params["fusion"].items()}
        )

    @property
    def embedding_size(self) -> int:
        return int(self.p_node_conv.shape[0])

    def fusion_params(self) -> Dict[str, torch.Tensor]:
        return dict(self.fusion.items())

    def forward(self, banded, covered: torch.Tensor, fuse_sage: bool = False,
                max_bp_iter: int = 3) -> torch.Tensor:
        return banded_test_forward(self, banded, covered, fuse_sage, max_bp_iter)


def _param(a) -> nn.Parameter:
    t = torch.as_tensor(np.asarray(a, np.float32))
    return nn.Parameter(t, requires_grad=False)


def from_jax_params(params: Mapping, device="cpu") -> DuplexQNet:
    """The port's module from the JAX package's parameter tree (numpy
    arrays, as in a checkpoint's `params`), on `device`."""
    return DuplexQNet(params).to(device)


def _graph_sum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """A sum over all nodes, accumulated in f64 and rounded to f32 once.

    The result then does not depend on the order of the rows (to within
    the f64 error, 2^-29 of an f32 ulp per 2^20 rows).  That keeps exact
    ties exact: when the live graph is symmetric under swapping its two
    layers, both layers' virtual nodes and aux features come out
    bit-equal, the gate is exactly 0.5/0.5, and layer-swapped nodes get
    bit-equal Q, so the lowest-index rule decides between them.  An f32
    sum rounds differently for the two layers' row orders and breaks such
    ties at random."""
    return torch.sum(x, dim=dim, dtype=torch.float64).to(x.dtype)


def _banded_inputs(net: DuplexQNet, bdx, covered: torch.Tensor):
    """Per-layer model inputs of a BandedDuplex + covered mask (unit cost):
    (node_input [2, pad_n, 2], aux [2, 4], active [pad_n], live [pad_n]).

    One unit-scale band pass per layer, with D = 2 ([live, mask] as the
    right-hand side), gives both the live degree and the unsevered degree;
    the severed-edge record lives in the base itself, so the covered-edge
    aux counter is unsevered minus live edges."""
    dt = net.w_n2l.dtype
    live = (~covered) & bdx.node_mask
    livef = live.to(dt)
    maskf = bdx.node_mask.to(dt)
    ones = torch.ones(bdx.pad_n, dtype=dt, device=bdx.device)
    rhs = torch.stack([livef, maskf], dim=-1)
    degs, counters = [], []
    for layer in range(2):
        both = spmm_dense_band(bdx.dbg(layer), ones, ones, rhs)
        deg = both[:, 0] * livef
        deg_u = both[:, 1] * maskf
        degs.append(deg)
        counters.append(_graph_sum(deg_u) / 2.0 - _graph_sum(deg) / 2.0)
    deg = torch.stack(degs)  # [2, pad_n]
    active = live & (deg[0] > 0)

    zero = torch.zeros((), dtype=dt, device=bdx.device)
    maxdeg = torch.amax(torch.where(active[None, :], deg, zero), dim=1)
    nd = deg / torch.clamp(maxdeg, min=1e-12)[:, None]
    nd = torch.where(active[None, :], nd, zero)
    node_input = torch.stack([nd, nd], dim=-1)

    n_f = float(bdx.n_nodes)
    cov_frac = torch.sum(covered & bdx.node_mask).to(dt) / n_f
    e_cnt = torch.clamp(
        torch.tensor(bdx.n_edges, dtype=dt, device=bdx.device), min=1.0
    )
    wedges = _graph_sum(deg * (deg - 1.0) / 2.0, dim=1)
    aux = torch.stack(
        [
            cov_frac.expand(2),
            torch.stack(counters) / e_cnt,
            wedges / (n_f * n_f),
            torch.ones(2, dtype=dt, device=bdx.device),
        ],
        dim=-1,
    )
    return node_input, aux, active, livef


@torch.no_grad()
def banded_test_forward(
    net: DuplexQNet,
    bdx,
    covered: torch.Tensor,
    fuse_sage: bool = False,
    max_bp_iter: int = 3,
) -> torch.Tensor:
    """Q(s, ·) over all nodes of a BandedDuplex: [pad_n]; dead nodes -inf.
    `covered` is bool [pad_n] (padding rows True).  It computes in the
    model's dtype: f32, or on the CPU f64 (`net.double()`), a reference
    for telling an f32 near-tie from a real difference.

    fuse_sage=True runs each message-passing round as one fused SAGE step
    (kernel K2), as the JAX package's
    net_packed.banded_test_forward_packed(fuse_sage=True) does; it needs
    both layers' spill sets to be empty.  Otherwise each round aggregates
    with kernel K1 and runs the dense layer in torch.matmul.  Both compute
    the JAX package's net.banded_test_forward in f32."""
    if fuse_sage and not bdx.spill_free:
        raise ValueError("fuse_sage needs empty spill sets in both layers")
    node_input, aux, active, live = _banded_inputs(net, bdx, covered)
    d = net.embedding_size
    c1, c2, c3 = net.p_node_conv, net.p_node_conv2, net.p_node_conv3
    if fuse_sage:
        sage_a = c1 @ c3[:d]
        sage_b = c2 @ c3[d:]
    ones_feat = torch.ones(2, dtype=net.w_n2l.dtype, device=bdx.device)

    node_embs, virt_embs = [], []
    for layer in range(2):
        dbg = bdx.dbg(layer)
        h = l2_normalize(torch.relu(node_input[layer] @ net.w_n2l))
        y = l2_normalize(torch.relu(ones_feat @ net.w_n2l))
        for _ in range(max_bp_iter):
            ypool = _graph_sum(h)  # inactive rows are exactly 0
            y_new = torch.cat([ypool @ c1, y @ c2])
            if fuse_sage:
                h = sage_step(dbg, live, live, h, mirror_sub(dbg, live, h),
                              sage_a, sage_b)
            else:
                pool = spmm_dense_band(dbg, live, live, h)
                h = l2_normalize(torch.relu(torch.cat([pool @ c1, h @ c2], -1) @ c3))
            y = l2_normalize(torch.relu(y_new @ c3))
        node_embs.append(h)
        virt_embs.append(y)

    fp = net.fusion_params()
    h0, h1 = fuse(fp, node_embs[0], node_embs[1])
    y0, y1 = fuse(fp, virt_embs[0][None], virt_embs[1][None])
    actf = active.to(h0.dtype)[:, None]
    h_f = [l2_normalize(h0) * actf, l2_normalize(h1) * actf]
    y_f = torch.stack([l2_normalize(y0)[0], l2_normalize(y1)[0]])  # [2, D]

    q_layers = []
    for layer in range(2):
        scal = y_f[layer] @ net.cross_product                      # [1]
        hidden = torch.relu((h_f[layer] * scal) @ net.h1_weight)   # [pad_n, R]
        aux_l = aux[layer].expand(hidden.shape[0], aux.shape[-1])
        last = torch.cat([hidden, aux_l], dim=-1)
        q_layers.append((last @ net.h2_weight)[:, 0])
    s = torch.relu(y_f @ net.w_layer1) @ net.w_layer2               # [2, 1]
    w = torch.softmax(s[:, 0], dim=0)
    q = w[0] * q_layers[0] + w[1] * q_layers[1]
    return torch.where(active, q, torch.full_like(q, -float("inf")))
