"""The duplex dismantling Q-network: padded small-graph forward, banded
large-graph forward and loss.

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
  loss            MSE(Q[a], target) + α·Laplacian     MultiDismantler_torch :410-431

`test_forward` and `train_forward` run a batch of padded graphs
(env/batch.py's operands), aggregating with a dense matmul, a segment sum
or, over a BlockedDuplex, the blocked-pair kernel K4 (make_blocked_aggregate).
Over a BandedDuplex the aggregation A_l @ H is the dense-band operator of
ops/dense_band.py: `banded_test_forward` is the large-graph eval forward;
with fuse_sage=True each round runs as one fused SAGE step (kernel K2): the
concat-matmul algebra
concat(pool@c1, H@c2)@c3 = pool@(c1@c3[:d]) + H@(c2@c3[d:]) lets the dense
layer and the normalisation ride the pooled tile.  Dead nodes get -inf.
`banded_train_loss` is the training loss, differentiable in the parameters
through BandSpmm (kernel K1, and K1 with swapped scales for its backward).
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from mdcommunity_tpu_torch.models.fusion import fuse
from mdcommunity_tpu_torch.ops.aggregate import l2_normalize, segment_spmm
from mdcommunity_tpu_torch.ops.band_kernels import sage_step
from mdcommunity_tpu_torch.ops.blocked_kernels import blocked_spmm
from mdcommunity_tpu_torch.ops.dense_band import (
    guard_band_operands,
    mirror_sub,
    spmm_dense_band,
    spmm_dense_band_grad,
)
from mdcommunity_tpu_torch.utils.device import resolve_device

_DENSE = (
    "w_n2l", "p_node_conv", "p_node_conv2", "p_node_conv3", "h1_weight",
    "h2_weight", "cross_product", "w_layer1", "w_layer2",
)


class DuplexQNet(nn.Module):
    """The Q-network's parameters (the JAX package's parameter tree, one
    tensor each; fusion parameters under `fusion`) and its banded forward.
    Parameters are made with requires_grad=False, for the eval;
    `net.requires_grad_()` makes them trainable (rl/big_trainer does)."""

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


def from_jax_params(params: Mapping, device=None) -> DuplexQNet:
    """The port's module from the JAX package's parameter tree (numpy
    arrays, as in a checkpoint's `params`), on `device`: CUDA unless the
    caller names one."""
    return DuplexQNet(params).to(resolve_device(device))


def to_jax_params(net: DuplexQNet) -> Dict[str, Union[np.ndarray, Dict[str, np.ndarray]]]:
    """The inverse of from_jax_params: the JAX package's parameter tree, as
    f32 numpy arrays (fusion leaves under "fusion")."""

    def leaf(t: torch.Tensor) -> np.ndarray:
        return t.detach().to("cpu", torch.float32).numpy().copy()

    tree: Dict = {k: leaf(getattr(net, k)) for k in _DENSE}
    tree["fusion"] = {k: leaf(v) for k, v in net.fusion.items()}
    return tree


def init_params(
    generator: torch.Generator,
    embedding_size: int = 64,
    reg_hidden: int = 32,
    aux_dim: int = 4,
    node_feat_dim: int = 2,
    gate_hidden: int = 128,
    w_init_std: float = 1.0,
) -> Dict[str, Union[np.ndarray, Dict[str, np.ndarray]]]:
    """A fresh parameter tree, as the JAX package's net.init_params makes
    it with its default (BitwiseMultipyLogis) fusion: dense weights
    fmod(normal·std, 2) (the reference's initializer), fusion trans = I and
    bias = 0, the logistic head uniform in ±1/√d.  Draws come from
    `generator` (the JAX package's from jax.random: the same distributions,
    other numbers)."""
    d = embedding_size

    def normal(*shape):
        x = torch.randn(shape, generator=generator) * w_init_std
        return torch.fmod(x, 2.0).numpy()

    def uniform(*shape):
        bound = 1.0 / np.sqrt(d)
        return ((torch.rand(shape, generator=generator) * 2 - 1) * bound).numpy()

    return {
        "w_n2l": normal(node_feat_dim, d),
        "p_node_conv": normal(d, d),
        "p_node_conv2": normal(d, d),
        "p_node_conv3": normal(2 * d, d),
        "h1_weight": normal(d, reg_hidden),
        "h2_weight": normal(reg_hidden + aux_dim, 1),
        "cross_product": normal(d, 1),
        "w_layer1": normal(d, gate_hidden),
        "w_layer2": normal(gate_hidden, 1),
        "fusion": {
            "trans": np.eye(d, dtype=np.float32),
            "bias": np.zeros(d, np.float32),
            "logis_w": uniform(d, 1),
            "logis_b": uniform(1),
        },
    }


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
    (node_input [2, pad_n, 2], aux [2, 4], active [pad_n], live [pad_n],
    deg [2, pad_n] live degrees).

    One unit-scale band pass per layer, with D = 2 ([live, mask] as the
    right-hand side), gives both the live degree and the unsevered degree;
    the severed-edge record lives in the base itself, so the covered-edge
    aux counter is unsevered minus live edges.  The inputs are graph
    constants: the loss computes them without grad."""
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
    return node_input, aux, active, livef, deg


def _embed(net: DuplexQNet, node_input, active, aggregate, max_bp_iter=3,
           sage=None):
    """Per-layer message passing and cross-layer fusion (the JAX package's
    net._embed), for one graph or a batch: node_input [2, ..., N, F],
    active bool [..., N].  Returns (h_f0, h_f1) [..., N, D], l2-normalised
    and zero on inactive rows, and y_f [2, ..., D].

    Each round aggregates with `aggregate(layer, h)` (A_l @ h), or, when
    `sage` is given, runs as `sage(layer, h)`, the fused SAGE step (kernel
    K2, no gradient).  The virtual-node pool is a graph-wide f64 sum
    (`_graph_sum`)."""
    d = net.embedding_size
    c1, c2, c3 = net.p_node_conv, net.p_node_conv2, net.p_node_conv3
    dt, dev = net.w_n2l.dtype, node_input.device
    # virtual-node input: ones on the two degree channels, zero on any extra
    # prior channel (the JAX package's ones_feat)
    f_dim = node_input.shape[-1]
    ones_feat = torch.cat([torch.ones(2, dtype=dt, device=dev),
                           torch.zeros(f_dim - 2, dtype=dt, device=dev)])

    node_embs, virt_embs = [], []
    for layer in range(2):
        h = l2_normalize(torch.relu(node_input[layer] @ net.w_n2l))
        y = l2_normalize(torch.relu(ones_feat @ net.w_n2l)).expand(h.shape[:-2] + (d,))
        for _ in range(max_bp_iter):
            ypool = _graph_sum(h, dim=-2)  # inactive rows are exactly 0
            y_new = torch.cat([ypool @ c1, y @ c2], -1)
            if sage is not None:
                h = sage(layer, h)
            else:
                pool = aggregate(layer, h)
                h = l2_normalize(torch.relu(torch.cat([pool @ c1, h @ c2], -1) @ c3))
            y = l2_normalize(torch.relu(y_new @ c3))
        node_embs.append(h)
        virt_embs.append(y)

    fp = net.fusion_params()
    h0, h1 = fuse(fp, node_embs[0], node_embs[1])
    # the virtual rows fuse as a matrix [rows, D], one row per graph
    y_shape = virt_embs[0].shape
    y0, y1 = fuse(fp, virt_embs[0].reshape(-1, d), virt_embs[1].reshape(-1, d))
    actf = active.to(h0.dtype)[..., None]
    y_f = torch.stack([l2_normalize(y0).reshape(y_shape),
                       l2_normalize(y1).reshape(y_shape)])
    return l2_normalize(h0) * actf, l2_normalize(h1) * actf, y_f


def _q_values(net: DuplexQNet, rows, y_f, aux) -> torch.Tensor:
    """The gated Q head over per-layer embedding rows [..., M, D], with y_f
    [2, ..., D] and aux [2, ..., 4]: q [..., M]."""
    q_layers = []
    for layer in range(2):
        scal = y_f[layer] @ net.cross_product                      # [..., 1]
        hidden = torch.relu((rows[layer] * scal[..., None, :]) @ net.h1_weight)
        aux_l = aux[layer][..., None, :].expand(hidden.shape[:-1] + (aux.shape[-1],))
        last = torch.cat([hidden, aux_l], dim=-1)
        q_layers.append((last @ net.h2_weight)[..., 0])
    s = torch.relu(y_f @ net.w_layer1) @ net.w_layer2               # [2, ..., 1]
    w = torch.softmax(s[..., 0], dim=0)
    return w[0][..., None] * q_layers[0] + w[1][..., None] * q_layers[1]


def _banded_aggregate(bdx, live, spmm=spmm_dense_band):
    return lambda layer, h: spmm(bdx.dbg(layer), live, live, h)


def _banded_sage(net: DuplexQNet, bdx, live):
    """The fused SAGE step over a BandedDuplex (kernel K2), with the
    concat-matmul algebra's two D×D weights."""
    d = net.embedding_size
    c1, c2, c3 = net.p_node_conv, net.p_node_conv2, net.p_node_conv3
    sage_a, sage_b = c1 @ c3[:d], c2 @ c3[d:]

    def step(layer, h):
        dbg = bdx.dbg(layer)
        return sage_step(dbg, live, live, h, mirror_sub(dbg, live, h), sage_a, sage_b)

    return step


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
    node_input, aux, active, live, _ = _banded_inputs(net, bdx, covered)
    sage = _banded_sage(net, bdx, live) if fuse_sage else None
    h0, h1, y_f = _embed(net, node_input, active, _banded_aggregate(bdx, live),
                         max_bp_iter, sage)
    q = _q_values(net, (h0, h1), y_f, aux)
    return torch.where(active, q, torch.full_like(q, -float("inf")))


def laplacian_regularizer(h_f, deg: torch.Tensor, aggregate) -> torch.Tensor:
    """Σ_l 2·tr(HᵀLH)/|E_l| with L = D - A of the live subgraph (the JAX
    package's net.laplacian_regularizer; reference calc_loss,
    MultiDismantler_torch.py:410-431).

    tr(HᵀLH) = Σ_v deg_v·||H_v||² - Σ_{(u,v) directed} H_u·H_v.
    h_f: per-layer [pad_n, D]; deg [2, pad_n] live degrees;
    aggregate(layer, h) = A_l @ h over the live subgraph."""
    total = 0.0
    for layer in range(2):
        h = h_f[layer]
        quad = torch.sum(deg[layer] * torch.sum(h * h, dim=-1))
        cross = torch.sum(h * aggregate(layer, h))
        denom = torch.clamp(torch.sum(deg[layer]), min=1.0)
        total = total + 2.0 * (quad - cross) / denom
    return total


def banded_train_loss(
    net: DuplexQNet,
    bdx,
    covered: torch.Tensor,
    actions: torch.Tensor,
    targets: torch.Tensor,
    alpha: float = 1e-3,
    remat: bool = True,
) -> torch.Tensor:
    """DQN loss on one large BandedDuplex: MSE(Q[actions], targets) +
    alpha·Laplacian embedding regularizer (the JAX package's
    net.banded_train_loss, unit cost, precise).

    actions: int [K] node ids, targets: f32 [K].  Every aggregation of the
    embedding and of the regularizer runs through BandSpmm, so its gradient
    is kernel K1 with swapped scales; the degree passes of the inputs run
    without grad.  The fit runs in f32 (the caller keeps TF32 off,
    utils/device.set_precise_matmul).

    remat=True recomputes the embedding in the backward instead of storing
    its activations (torch.utils.checkpoint, as the JAX package's
    jax.checkpoint).  The recomputed forward reads the band operands again,
    so a guard makes the backward raise if they were edited after this
    call; BandSpmm's own check covers remat=False."""
    with torch.no_grad():
        node_input, aux, active, live, deg = _banded_inputs(net, bdx, covered)

    def embed():
        return _embed(net, node_input, active,
                      _banded_aggregate(bdx, live, spmm_dense_band_grad))

    if remat:
        h0, h1, y_f = checkpoint(embed, use_reentrant=False)
        h0, h1, y_f = guard_band_operands((bdx.dbg0, bdx.dbg1), h0, h1, y_f)
    else:
        h0, h1, y_f = embed()
    actions = torch.as_tensor(actions, device=bdx.device).long()
    targets = torch.as_tensor(targets, device=bdx.device, dtype=h0.dtype)
    q = _q_values(net, (h0[actions], h1[actions]), y_f, aux)
    mse = torch.mean(torch.square(q - targets))
    reg = laplacian_regularizer(
        (h0, h1), deg,
        lambda layer, h: spmm_dense_band_grad(bdx.dbg(layer), live, live, h),
    )
    return mse + alpha * reg


# ---------------------------------------------------------------------------
# padded small-graph forward: dense, segment and blocked aggregation
# ---------------------------------------------------------------------------


def _aggregate(g, inputs, layer: int, h: torch.Tensor) -> torch.Tensor:
    """Live-adjacency A_l @ h for one duplex layer, [B, N, D] -> [B, N, D]:
    a batched matmul with the dense adjacency when the inputs carry one,
    else the destination-sorted segment sum over the live-edge weights."""
    if inputs.adj is not None:
        return torch.matmul(inputs.adj[:, layer], h)
    return segment_spmm(g.src[:, layer], g.dst[:, layer], inputs.live_w[:, layer],
                        h, h.shape[-2])


def make_blocked_aggregate(bd):
    """Aggregate function over a BlockedDuplex (graphs/blocked.py): its edge
    arrays are in pair-slot order, so each layer's live weights are the
    blocked kernel's w [P, T] operand by a reshape, a view.  The product is
    BlockSpmm (kernel K4; K4 and K5 in its backward)."""

    def agg(g, inputs, layer, h):
        bcoo = bd.bcoo[layer]
        w = inputs.live_w[0, layer, : bcoo.n_slots].reshape(bcoo.n_pairs, bcoo.T)
        return blocked_spmm(bcoo, w, h[0])[None]

    return agg


def _batched_embed(net, g, inputs, max_bp_iter, aggregate_fn):
    agg = aggregate_fn or _aggregate
    return _embed(net, inputs.node_input.transpose(0, 1), inputs.active,
                  lambda layer, h: agg(g, inputs, layer, h), max_bp_iter)


def test_forward(net: DuplexQNet, g, inputs, max_bp_iter: int = 3,
                 aggregate_fn=None) -> torch.Tensor:
    """Q(s, ·) for every node of a batch of padded graphs: [B, N]; dead
    nodes get -inf (the JAX package's net.test_forward).  inputs come from
    env/batch.make_batch_inputs; aggregate_fn(g, inputs, layer, h) replaces
    the dense or segment aggregation (make_blocked_aggregate)."""
    h0, h1, y_f = _batched_embed(net, g, inputs, max_bp_iter, aggregate_fn)
    q = _q_values(net, (h0, h1), y_f, inputs.aux.transpose(0, 1))
    return torch.where(inputs.active, q, torch.full_like(q, -float("inf")))


def train_forward(net: DuplexQNet, g, inputs, actions: torch.Tensor,
                  max_bp_iter: int = 3):
    """Q(s, a) for one chosen action per graph: (q [B], H_fused [2, B, N, D])
    (the JAX package's net.train_forward)."""
    h0, h1, y_f = _batched_embed(net, g, inputs, max_bp_iter, None)
    b = torch.arange(actions.shape[0], device=actions.device)
    rows = (h0[b, actions][:, None, :], h1[b, actions][:, None, :])
    q = _q_values(net, rows, y_f, inputs.aux.transpose(0, 1))[:, 0]
    return q, torch.stack([h0, h1])
