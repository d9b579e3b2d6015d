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
With mesh= both run gp-sharded (parallel/): node tensors live as shard
pieces, the dense layers run per shard, aggregation is the sharded band
operator (kernel K3), and graph-wide sums add per-shard f64 partials.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Mapping, Union

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from mdcommunity_tpu_torch.graphs.banded import ShardedBandedDuplex, shard_banded_duplex
from mdcommunity_tpu_torch.models.fusion import FUSION_INITS, fuse
from mdcommunity_tpu_torch.ops.aggregate import l2_normalize, segment_spmm
from mdcommunity_tpu_torch.ops.band_kernels import sage_step
from mdcommunity_tpu_torch.ops.blocked_kernels import blocked_spmm
from mdcommunity_tpu_torch.ops.dense_band import (
    guard_band_operands,
    mirror_sub,
    spmm_dense_band,
    spmm_dense_band_grad,
)
from mdcommunity_tpu_torch.parallel.band_partition import (
    spmm_band_sharded,
    spmm_band_sharded_grad,
)
from mdcommunity_tpu_torch.parallel.mesh import gather_nodes, gather_rows, split_nodes
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
    # a copy: a parameter that aliased the source array (a JAX array's host
    # buffer, a checkpoint's numpy array) would write an optimizer's steps
    # into it
    t = torch.tensor(np.asarray(a, np.float32))
    return nn.Parameter(t, requires_grad=False)


def from_jax_params(params: Mapping, device=None) -> DuplexQNet:
    """The port's module from the JAX package's parameter tree (numpy
    arrays, as in a checkpoint's `params`), on `device`: CUDA unless the
    caller names one.  A tree with the HCA heads (w_macro) gives a
    models/hca.HcaQNet, any other a DuplexQNet (unit and degree cost take
    w_n2l [2, D], CE [3, D])."""
    if "w_macro" in params:
        from mdcommunity_tpu_torch.models.hca import HcaQNet

        return HcaQNet(params).to(resolve_device(device))
    return DuplexQNet(params).to(resolve_device(device))


def to_jax_params(net: DuplexQNet) -> Dict[str, Union[np.ndarray, Dict[str, np.ndarray]]]:
    """The inverse of from_jax_params: the JAX package's parameter tree, as
    f32 numpy arrays (fusion leaves under "fusion")."""

    def leaf(t: torch.Tensor) -> np.ndarray:
        return t.detach().to("cpu", torch.float32).numpy().copy()

    tree: Dict = {k: leaf(getattr(net, k)) for k in _DENSE}
    tree["fusion"] = {k: leaf(v) for k, v in net.fusion.items()}
    for k in ("w_macro", "w_comm_score", "w_micro_score"):
        if hasattr(net, k):
            tree[k] = leaf(getattr(net, k))
    return tree


def param_count(net: nn.Module) -> int:
    """Number of parameter values (the JAX package's param_count of the
    parameter tree)."""
    return sum(p.numel() for p in net.parameters())


def init_params(
    generator: torch.Generator,
    embedding_size: int = 64,
    reg_hidden: int = 32,
    aux_dim: int = 4,
    node_feat_dim: int = 2,
    gate_hidden: int = 128,
    w_init_std: float = 1.0,
    fusion: str = "bitwise_logis",
) -> Dict[str, Union[np.ndarray, Dict[str, np.ndarray]]]:
    """A fresh parameter tree, as the JAX package's net.init_params makes
    it: dense weights fmod(normal·std, 2) (the reference's initializer),
    the fusion mode's parameters from models/fusion.FUSION_INITS[fusion].
    Draws come from `generator` (the JAX package's from jax.random: the
    same distributions, other numbers)."""
    d = embedding_size
    if fusion not in FUSION_INITS:
        raise ValueError(f"unknown fusion {fusion!r}; one of {sorted(FUSION_INITS)}")

    def normal(*shape):
        x = torch.randn(shape, generator=generator) * w_init_std
        return torch.fmod(x, 2.0).numpy()

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
        "fusion": FUSION_INITS[fusion](generator, d),
    }


def _graph_sum(x, dim: int = 0) -> torch.Tensor:
    """A sum over all nodes, accumulated in f64 and rounded to f32 once; x
    is a tensor or the list of its shards' row pieces, whose f64 partials
    are added in shard order on the first shard's device.

    The result then does not depend on the order of the rows (to within
    the f64 error, 2^-29 of an f32 ulp per 2^20 rows).  That keeps exact
    ties exact: when the live graph is symmetric under swapping its two
    layers, both layers' virtual nodes and aux features come out
    bit-equal, the gate is exactly 0.5/0.5, and layer-swapped nodes get
    bit-equal Q, so the lowest-index rule decides between them.  An f32
    sum rounds differently for the two layers' row orders and breaks such
    ties at random.  A bf16 x (stored activations) sums to f32."""
    parts = _pieces(x)
    out_dt = torch.promote_types(parts[0].dtype, torch.float32)
    dev = parts[0].device
    return _add([torch.sum(p, dim=dim, dtype=torch.float64).to(dev) for p in parts]).to(out_dt)


def _add(xs: List[torch.Tensor]) -> torch.Tensor:
    """xs added in order, on the first one's device."""
    return functools.reduce(lambda a, b: a + b.to(a.device), xs)


def _pieces(x) -> List[torch.Tensor]:
    """x's shard pieces: x itself if it is a list, else [x]."""
    return x if isinstance(x, list) else [x]


def _on_mesh(bdx, mesh):
    """(duplex, mesh) of a run: with a mesh, bdx sharded over it (as it is
    if it already is); a ShardedBandedDuplex brings its own mesh."""
    if isinstance(bdx, ShardedBandedDuplex):
        if mesh is not None and mesh != bdx.mesh:
            raise ValueError("bdx is sharded over another mesh")
        return bdx, bdx.mesh
    if mesh is None:
        return bdx, None
    return shard_banded_duplex(mesh, bdx), mesh


def _banded_inputs(net: DuplexQNet, bdx, covered: torch.Tensor, mesh=None,
                   variant: str = "unit_cost"):
    """Per-layer model inputs of a BandedDuplex + covered mask:
    (node_input [2, pad_n, F], aux [2, 4], active [pad_n], live [pad_n],
    deg [2, pad_n] live degrees).  node_input is the variant's (the JAX
    package's _banded_inputs): unit cost [deg/maxdeg] twice (F = 2), degree
    cost [weight, 1] (F = 2), CE the unit-cost pair and the prior (F = 3),
    each zero on inactive nodes.

    One unit-scale band pass per layer, with D = 2 ([live, mask] as the
    right-hand side), gives both the live degree and the unsevered degree;
    the severed-edge record lives in the base itself, so the covered-edge
    aux counter is unsevered minus live edges.  The inputs are graph
    constants: the loss computes them without grad.

    With a mesh, bdx is a ShardedBandedDuplex over it: the degree passes
    run through the sharded operator, every node tensor comes back as the
    list of its shard pieces (node_input [2, local_n, F] each), and aux on
    the first shard's device."""
    if variant not in ("unit_cost", "degree_cost", "ce"):
        raise ValueError(f"the banded forward runs unit_cost, degree_cost and ce, not "
                         f"{variant!r} (HCA: models/hca_banded.banded_hca_forward)")
    dt = net.w_n2l.dtype
    if mesh is None:
        covered, masks = [covered], [bdx.node_mask]
        weights, prior = [bdx.weights], [bdx.node_feat]

        def spmm(layer, r, c, h):
            return [spmm_dense_band(bdx.dbg(layer), r[0], c[0], h[0])]
    else:
        covered, masks = split_nodes(mesh, covered), bdx.node_mask
        weights, prior = bdx.weights, bdx.node_feat

        def spmm(layer, r, c, h):
            return spmm_band_sharded(mesh, bdx.dbg(layer), r, c, h)
    dev = masks[0].device
    live = [(~c) & m for c, m in zip(covered, masks)]
    livef = [x.to(dt) for x in live]
    maskf = [m.to(dt) for m in masks]
    ones = [torch.ones(m.shape[0], dtype=dt, device=m.device) for m in masks]
    rhs = [torch.stack([x, m], dim=-1) for x, m in zip(livef, maskf)]
    degs, counters = [], []
    for layer in range(2):
        both = spmm(layer, ones, ones, rhs)
        deg = [b[:, 0] * x for b, x in zip(both, livef)]
        deg_u = [b[:, 1] * m for b, m in zip(both, maskf)]
        degs.append(deg)
        counters.append(_graph_sum(deg_u) / 2.0 - _graph_sum(deg) / 2.0)
    deg = [torch.stack(d) for d in zip(*degs)]  # [2, n] a piece
    active = [x & (d[0] > 0) for x, d in zip(live, deg)]

    zero = torch.zeros((), dtype=dt, device=dev)
    node_input = []
    if variant == "degree_cost":
        for a, w in zip(active, weights):
            base = torch.stack([w.to(dt), torch.ones_like(w, dtype=dt)], dim=-1)
            node_input.append(torch.where(a[None, :, None], base, zero.to(w.device)))
    else:
        maxdeg = functools.reduce(torch.maximum, [
            torch.amax(torch.where(a[None, :], d, zero.to(d.device)), dim=1).to(dev)
            for a, d in zip(active, deg)])
        for a, d, p in zip(active, deg, prior):
            z = zero.to(d.device)
            nd = d / torch.clamp(maxdeg.to(d.device), min=1e-12)[:, None]
            feats = [torch.where(a[None, :], nd, z)] * 2
            if variant == "ce":
                feats.append(torch.where(a[None, :], p.to(dt), z))
            node_input.append(torch.stack(feats, dim=-1))

    n_f = float(bdx.n_nodes)
    cov_frac = _add([torch.sum(c & m) for c, m in zip(covered, masks)]).to(dt) / n_f
    e_cnt = torch.clamp(
        torch.tensor(bdx.n_edges, dtype=dt, device=dev), min=1.0
    )
    wedges = _graph_sum([d * (d - 1.0) / 2.0 for d in deg], dim=1)
    aux = torch.stack(
        [
            cov_frac.expand(2),
            torch.stack(counters) / e_cnt,
            wedges / (n_f * n_f),
            torch.ones(2, dtype=dt, device=dev),
        ],
        dim=-1,
    )
    if mesh is None:
        return node_input[0], aux, active[0], livef[0], deg[0]
    return node_input, aux, active, livef, deg


def _embed(net: DuplexQNet, node_input, active, aggregate, max_bp_iter=3,
           sage=None, store=None):
    """Per-layer message passing and cross-layer fusion (the JAX package's
    net._embed), for one graph or a batch: node_input [2, ..., N, F],
    active bool [..., N].  Returns (h_f0, h_f1) [..., N, D], l2-normalised
    and zero on inactive rows, and y_f [2, ..., D].

    Each round aggregates with `aggregate(layer, h)` (A_l @ h), or, when
    `sage` is given, runs as `sage(layer, h)`, the fused SAGE step (kernel
    K2, no gradient), with h kept in the `store` dtype between the steps
    when one is given (bf16 activations; the pool and the fusion widen it).
    The virtual-node pool is a graph-wide f64 sum (`_graph_sum`).

    node_input and active may be lists of row pieces (the shards of a gp
    mesh); then aggregate maps a list of pieces to a list, the dense layers
    and the fusion run per piece (the weights moved to its device), and
    h_f0, h_f1 are lists; y_f lies on the first piece's device."""
    sharded = isinstance(node_input, list)
    if not sharded:
        node_input, active = [node_input], [active]
        aggregate = _one_piece(aggregate)
        sage = None if sage is None else _one_piece(sage)
    d = net.embedding_size
    c1, c2, c3 = net.p_node_conv, net.p_node_conv2, net.p_node_conv3
    dt, dev = net.w_n2l.dtype, node_input[0].device
    # virtual-node input: ones on the two degree channels, zero on any extra
    # prior channel (the JAX package's ones_feat)
    f_dim = node_input[0].shape[-1]
    ones_feat = torch.cat([torch.ones(2, dtype=dt, device=dev),
                           torch.zeros(f_dim - 2, dtype=dt, device=dev)])

    def dense(x, w):
        return x @ w.to(x.device)

    node_embs, virt_embs = [], []
    for layer in range(2):
        h = [l2_normalize(torch.relu(dense(x[layer], net.w_n2l))) for x in node_input]
        y = l2_normalize(torch.relu(ones_feat @ net.w_n2l)).expand(h[0].shape[:-2] + (d,))
        if sage is not None and store is not None:
            h = [x.to(store) for x in h]
        for _ in range(max_bp_iter):
            ypool = _graph_sum(h, dim=-2)  # inactive rows are exactly 0
            y_new = torch.cat([ypool @ c1, y @ c2], -1)
            if sage is not None:
                h = sage(layer, h)
            else:
                pool = aggregate(layer, h)
                h = [l2_normalize(torch.relu(dense(torch.cat([dense(p, c1), dense(x, c2)], -1),
                                                   c3)))
                     for p, x in zip(pool, h)]
            y = l2_normalize(torch.relu(y_new @ c3))
        node_embs.append([x.to(dt) for x in h])
        virt_embs.append(y)

    fp = net.fusion_params()
    h0, h1 = [], []
    for e0, e1, a in zip(*node_embs, active):
        f0, f1 = fuse({k: v.to(e0.device) for k, v in fp.items()}, e0, e1)
        actf = a.to(f0.dtype)[..., None]
        h0.append(l2_normalize(f0) * actf)
        h1.append(l2_normalize(f1) * actf)
    # the virtual rows fuse as a matrix [rows, D], one row per graph
    y_shape = virt_embs[0].shape
    y0, y1 = fuse(fp, virt_embs[0].reshape(-1, d), virt_embs[1].reshape(-1, d))
    y_f = torch.stack([l2_normalize(y0).reshape(y_shape),
                       l2_normalize(y1).reshape(y_shape)])
    if not sharded:
        return h0[0], h1[0], y_f
    return h0, h1, y_f


def _one_piece(fn):
    """fn(layer, h) on tensors as a function on one-piece lists."""
    return lambda layer, hs: [fn(layer, hs[0])]


def _q_values(net: DuplexQNet, rows, y_f, aux):
    """The gated Q head over per-layer embedding rows [..., M, D], with y_f
    [2, ..., D] and aux [2, ..., 4]: q [..., M].  Rows given as lists of
    shard pieces give the list of the pieces' q."""
    if isinstance(rows[0], list):
        return [_q_values(net, r, y_f, aux) for r in zip(*rows)]
    dev = rows[0].device
    y_f, aux = y_f.to(dev), aux.to(dev)
    q_layers = []
    for layer in range(2):
        scal = y_f[layer] @ net.cross_product.to(dev)                   # [..., 1]
        hidden = torch.relu((rows[layer] * scal[..., None, :]) @ net.h1_weight.to(dev))
        aux_l = aux[layer][..., None, :].expand(hidden.shape[:-1] + (aux.shape[-1],))
        last = torch.cat([hidden, aux_l], dim=-1)
        q_layers.append((last @ net.h2_weight.to(dev))[..., 0])
    s = torch.relu(y_f @ net.w_layer1.to(dev)) @ net.w_layer2.to(dev)  # [2, ..., 1]
    w = torch.softmax(s[..., 0], dim=0)
    return w[0][..., None] * q_layers[0] + w[1][..., None] * q_layers[1]


def _banded_aggregate(bdx, live, spmm=spmm_dense_band, precise=True, store=None):
    """A_l @ h over a BandedDuplex's live subgraph.  With a `store` dtype
    (bf16 activations) h is rounded to it before the operator and the pool
    comes back in h's dtype, as the JAX package's unfused packed forward."""
    if precise and store is None:
        return lambda layer, h: spmm(bdx.dbg(layer), live, live, h)
    return lambda layer, h: spmm(
        bdx.dbg(layer), live, live, h.to(store or h.dtype), precise=precise
    ).to(h.dtype)


def _sharded_aggregate(mesh, bdx, live, precise=True, store=None):
    """_banded_aggregate over a ShardedBandedDuplex, on lists of shard
    pieces: the sharded band operator (kernel K3)."""

    def agg(layer, hs):
        pools = spmm_band_sharded(mesh, bdx.dbg(layer), live, live,
                                  [x.to(store or x.dtype) for x in hs], precise=precise)
        return [p.to(x.dtype) for p, x in zip(pools, hs)]

    return agg


def _banded_sage(net: DuplexQNet, bdx, live, precise=True, f32_epi=True):
    """The fused SAGE step over a BandedDuplex (kernel K2, precise=False its
    bf16 mode, f32_epi=False its bf16 epilogue), with the concat-matmul
    algebra's two D×D weights."""
    d = net.embedding_size
    c1, c2, c3 = net.p_node_conv, net.p_node_conv2, net.p_node_conv3
    sage_a, sage_b = c1 @ c3[:d], c2 @ c3[d:]

    def step(layer, h):
        dbg = bdx.dbg(layer)
        return sage_step(dbg, live, live, h, mirror_sub(dbg, live, h, precise),
                         sage_a, sage_b, precise, f32_epi)

    return step


@torch.no_grad()
def banded_test_forward(
    net: DuplexQNet,
    bdx,
    covered: torch.Tensor,
    fuse_sage: bool = False,
    max_bp_iter: int = 3,
    precise: bool = True,
    act_dtype: torch.dtype = torch.float32,
    mesh=None,
    f32_epi: bool = True,
    variant: str = "unit_cost",
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
    the JAX package's net.banded_test_forward in f32.  f32_epi=False (only
    with fuse_sage) rounds the fused step's dense-layer operands to bf16
    (K2's bf16 epilogue, banded_test_forward_packed(f32_epi=False)), with
    either precise and act_dtype.

    precise=False is the fast eval (the JAX package's precise=False, and
    net_packed.banded_test_forward_packed's act_dtype): the aggregations run
    K1's or K2's bf16 mode; act_dtype=bfloat16 also stores h in bf16 (fused:
    between the steps; unfused: h is rounded before K1 and the pool comes
    back in f32).  The degree passes stay on the f32 K1: their operands are
    0/1 and their sums small integers, exact in either mode.  The dense
    layers run at the caller's matmul precision
    (utils/device.matmul_precision).

    mesh (parallel/mesh.GpMesh), or a bdx sharded by
    graphs/banded.shard_banded_duplex, runs it gp-sharded, as
    net_packed.banded_test_forward_packed(mesh=...): every aggregation is
    the sharded operator (kernel K3 in the mode precise and act_dtype
    select; the JAX package runs K3's bf16 mode whatever precise says), the
    dense layers run per shard, and Q is gathered to the first shard's
    device.  An unsharded bdx is sharded on the way in (views where the
    shards share its device).  The fused step needs mesh=None.  The net
    lies on the first shard's device.

    variant "degree_cost" or "ce" takes that variant's inputs
    (_banded_inputs; the JAX package's banded_test_forward(variant=)):
    the same embedding and Q head, other input columns."""
    bdx, mesh = _on_mesh(bdx, mesh)
    if fuse_sage and mesh is not None:
        raise ValueError("fuse_sage needs mesh=None (the fused step is single-device)")
    if fuse_sage and not bdx.spill_free:
        raise ValueError("fuse_sage needs empty spill sets in both layers")
    if not (f32_epi or fuse_sage):
        raise ValueError("f32_epi=False is the fused step's epilogue: it needs fuse_sage=True")
    if act_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"act_dtype must be float32 or bfloat16, got {act_dtype}")
    if precise and act_dtype != torch.float32:
        raise ValueError("precise=True requires act_dtype=float32")
    store = None if act_dtype == torch.float32 else act_dtype
    node_input, aux, active, live, _ = _banded_inputs(net, bdx, covered, mesh, variant)
    if mesh is None:
        agg = _banded_aggregate(bdx, live, precise=precise, store=store)
    else:
        agg = _sharded_aggregate(mesh, bdx, live, precise, store)
    sage = _banded_sage(net, bdx, live, precise, f32_epi) if fuse_sage else None
    h0, h1, y_f = _embed(net, node_input, active, agg, max_bp_iter, sage, store)
    q = [torch.where(a, x, torch.full_like(x, -float("inf")))
         for a, x in zip(_pieces(active), _pieces(_q_values(net, (h0, h1), y_f, aux)))]
    return q[0] if mesh is None else gather_nodes(mesh, q)


def laplacian_regularizer(h_f, deg: torch.Tensor, aggregate) -> torch.Tensor:
    """Σ_l 2·tr(HᵀLH)/|E_l| with L = D - A of the live subgraph (the JAX
    package's net.laplacian_regularizer; reference calc_loss,
    MultiDismantler_torch.py:410-431).

    tr(HᵀLH) = Σ_v deg_v·||H_v||² - Σ_{(u,v) directed} H_u·H_v, and |E_l|,
    the directed live-edge count, is Σ_v deg_v (integer-valued, exact in
    f32).  h_f: per-layer [pad_n, D]; deg [2, pad_n] live degrees;
    aggregate(layer, h) = A_l @ h over the live subgraph.  A batch of padded
    graphs is one block-diagonal graph: h_f per-layer [B, N, D] and deg
    [2, B, N] (env/batch's deg with its layer axis first), as the JAX
    package's batched form takes (h_f, g, inputs); train_step passes that.
    Sharded: h_f's entries and deg are lists of shard pieces, whose f32
    partial sums are added in shard order."""
    total = 0.0
    for layer in range(2):
        hs, pools = _pieces(h_f[layer]), _pieces(aggregate(layer, h_f[layer]))
        degs = [d[layer] for d in _pieces(deg)]
        quad = _add([torch.sum(d * torch.sum(h * h, dim=-1)) for d, h in zip(degs, hs)])
        cross = _add([torch.sum(h * p) for h, p in zip(hs, pools)])
        denom = torch.clamp(_add([torch.sum(d) for d in degs]), min=1.0)
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
    mesh=None,
    precise: bool = True,
    variant: str = "unit_cost",
) -> torch.Tensor:
    """DQN loss on one large BandedDuplex: MSE(Q[actions], targets) +
    alpha·Laplacian embedding regularizer (the JAX package's
    net.banded_train_loss).  variant "unit_cost", "degree_cost" or "ce"
    takes that variant's input columns (_banded_inputs: degree cost
    [weight, 1] on active nodes, CE the unit-cost pair and the prior); the
    JAX package has no banded HCA loss, so "hca" raises ValueError.

    actions: int [K] node ids, targets: f32 [K].  Every aggregation of the
    embedding and of the regularizer runs through BandSpmm, so its gradient
    is kernel K1 with swapped scales; the degree passes of the inputs run
    without grad, precise in either mode (their operands are 0/1 and their
    sums integers, so the JAX package's bf16 passes give the same values).
    precise=True runs the fit in f32 (the caller keeps TF32 off,
    utils/device.matmul_precision(True)); precise=False is the bf16 fit:
    every aggregation is K1's bf16 mode (bf16(col ⊙ h), f32 sums) both
    ways, as the JAX package's banded_train_loss(precise=False), and the
    caller runs the dense layers under matmul_precision(False).

    remat=True recomputes the embedding in the backward instead of storing
    its activations (torch.utils.checkpoint, as the JAX package's
    jax.checkpoint).  The recomputed forward reads the band operands again,
    so a guard makes the backward raise if they were edited after this
    call; BandSpmm's own check covers remat=False.

    mesh, or a sharded bdx, runs it gp-sharded as banded_test_forward does
    (the JAX package's banded_train_loss(mesh=...)): every aggregation is
    parallel/band_partition.ShardedBandSpmm (kernel K3, and K3 with swapped
    scales for its gradient; their bf16 modes at precise=False), the
    actions' rows are gathered from the shards that own them, and the loss
    lies on the first shard's device."""
    if variant == "hca":
        raise ValueError("the JAX package has no banded HCA loss (its banded HCA forward, "
                         "models/hca_banded.py, is eval only): train HCA with the "
                         "small-graph DQNAgent")
    bdx, mesh = _on_mesh(bdx, mesh)
    with torch.no_grad():
        node_input, aux, active, live, deg = _banded_inputs(net, bdx, covered, mesh,
                                                            variant)
    if mesh is None:
        agg = _banded_aggregate(bdx, live, spmm_dense_band_grad, precise)
    else:
        def agg(layer, hs):
            return spmm_band_sharded_grad(mesh, bdx.dbg(layer), live, live, hs, precise)

    def embed():
        return _embed(net, node_input, active, agg)

    if remat:
        h0, h1, y_f = checkpoint(embed, use_reentrant=False)
        n = len(_pieces(h0))
        flat = guard_band_operands((bdx.dbg0, bdx.dbg1), *_pieces(h0), *_pieces(h1), y_f)
        h0, h1, y_f = list(flat[:n]), list(flat[n:2 * n]), flat[-1]
        if mesh is None:
            h0, h1 = h0[0], h1[0]
    else:
        h0, h1, y_f = embed()
    actions = torch.as_tensor(actions, device=bdx.device).long()
    targets = torch.as_tensor(targets, device=bdx.device, dtype=y_f.dtype)
    if mesh is None:
        rows = (h0[actions], h1[actions])
    else:
        rows = (gather_rows(mesh, h0, actions), gather_rows(mesh, h1, actions))
    q = _q_values(net, rows, y_f, aux)
    mse = torch.mean(torch.square(q - targets))
    reg = laplacian_regularizer((h0, h1), deg, agg)
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
