"""The plain reference: the MultiDismantler model, its loss, Adam and the
interdependency cascade, in float64 PyTorch and numpy/scipy.

It imports nothing of the program and takes nothing the program made.  It
reads the checkpoint file itself, works in the generator's original node
ids, and builds its own adjacency from the edges the benchmark generated.
What the model computes (MultiDismantler_net_graphsage.py, reference
file:line in the program's models/net.py):

  inputs   live = not covered; deg_l = live degree over unsevered edges;
           active = live and deg_0 > 0; node features from the
           configuration's own reference file (configs/<name>.py)
  aux_l    [covered share, unsevered edges with a covered end / |E_l|,
            Σ deg_l (deg_l − 1) / 2 / n², 1]
  embed    H0 = l2n(relu(x_l W_n2l)), Y0 = l2n(relu([1, 1] W_n2l));
           3 rounds: H' = l2n(relu([A_l H C1 ; H C2] C3)),
                     Y' = l2n(relu([Σ H C1 ; Y C2] C3))
  fusion   f_k = tanh(e_k T + b); a = σ((f_k f_l) w + c) over k in (l, o);
           out_l = f_l + softmax(a)_o f_o; H_f = l2n(out) on active rows
  Q        q_l = [relu((H_f,l · (Y_f,l · cross)) h1) ; aux_l] h2,
           Q = Σ_l softmax_l(relu(Y_f,l W1) W2) q_l, −inf off active
  loss     mean((Q[a] − t)²) + α Σ_l 2 (Σ deg |H_f|² − Σ H_f · A H_f) / Σ deg

The cascade (mvc_env.py, Mcc.py): removing nodes kills their edges; then,
until nothing changes, an edge of one layer whose ends lie in different
components of the other layer's live graph is severed.  Only live edges
(unsevered, both ends present) are severed.  The rank is the largest
component of layer 0's live graph over the nodes still present.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import connected_components

HERE = os.path.dirname(os.path.abspath(__file__))

# ----------------------------------------------------------------- weights


class _Stub(tuple):
    def __new__(cls, *args, **kwargs):
        return tuple.__new__(cls, args)

    def __setstate__(self, state):
        pass


class _Unpickler(pickle.Unpickler):
    """Lets numpy and builtins through; any other class (the optimizer's
    state in a checkpoint) becomes a stub."""

    def find_class(self, module, name):
        if module.split(".")[0] in ("numpy", "builtins", "collections", "copyreg", "_codecs"):
            return super().find_class(module, name)
        return type(name, (_Stub,), {"__module__": module})


def read_params(path: str) -> Dict[str, np.ndarray]:
    """The checkpoint's parameters, flat: fusion leaves as 'fusion.<key>'."""
    with open(path, "rb") as f:
        params = _Unpickler(f).load()["params"]
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": np.asarray(vv, np.float64) for kk, vv in v.items()})
        else:
            out[k] = np.asarray(v, np.float64)
    return out


def config_reference(name: str):
    """configs/<name>.py: the configuration's node features and action costs."""
    path = os.path.join(HERE, "configs", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"mdbench_config_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------------- graph


@dataclasses.dataclass
class Layer:
    """One layer's undirected edges as unique pairs u < v with their
    multiplicity, and which are severed."""

    u: np.ndarray
    v: np.ndarray
    mult: np.ndarray
    sev: np.ndarray

    @property
    def keys(self) -> np.ndarray:
        return self.u * (1 << 32) + self.v


@dataclasses.dataclass
class State:
    n: int
    layers: List[Layer]
    covered: np.ndarray
    rank: int = 0

    def copy(self) -> "State":
        return State(self.n, [dataclasses.replace(L, sev=L.sev.copy()) for L in self.layers],
                     self.covered.copy(), self.rank)


def pair_keys(e: np.ndarray) -> np.ndarray:
    e = np.asarray(e, np.int64).reshape(-1, 2)
    return np.minimum(e[:, 0], e[:, 1]) * (1 << 32) + np.maximum(e[:, 0], e[:, 1])


def intact_state(n: int, edges: Sequence[np.ndarray]) -> State:
    layers = []
    for e in edges:
        keys, mult = np.unique(pair_keys(e), return_counts=True)
        layers.append(Layer(keys >> 32, keys & ((1 << 32) - 1), mult.astype(np.float64),
                            np.zeros(len(keys), bool)))
    return State(n, layers, np.zeros(n, bool))


def _labels(n: int, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    m = sp.coo_matrix((np.ones(len(u), np.int8), (u, v)), shape=(n, n))
    return connected_components(m, directed=False)[1]


def cascade(state: State, remove: Optional[np.ndarray] = None) -> State:
    """Remove the nodes `remove` (none: the cascade of the state as it is),
    then sever until the mutual fixed point; sets state.rank.  In place."""
    n, L0, L1 = state.n, state.layers[0], state.layers[1]
    if remove is not None and len(remove):
        state.covered[np.asarray(remove, np.int64)] = True
    cov = state.covered
    alive = [~L.sev & ~cov[L.u] & ~cov[L.v] for L in (L0, L1)]
    changed = True
    while changed:
        changed = False
        for this, other in ((1, 0), (0, 1)):
            o, t = state.layers[other], state.layers[this]
            lab = _labels(n, o.u[alive[other]], o.v[alive[other]])
            cross = alive[this] & (lab[t.u] != lab[t.v])
            if cross.any():
                t.sev |= cross
                alive[this] &= ~cross
                changed = True
    lab = _labels(n, L0.u[alive[0]], L0.v[alive[0]])
    present = ~cov
    state.rank = int(np.bincount(lab[present]).max()) if present.any() else 0
    return state


def state_gap(ref: State, other: State) -> int:
    """Entries in which two states differ: covered nodes, severed pairs
    and the rank (an exact comparison)."""
    gap = int(np.sum(ref.covered != other.covered)) + int(ref.rank != other.rank)
    for a, b in zip(ref.layers, other.layers):
        gap += int(np.sum(a.sev != b.sev)) if len(a.sev) == len(b.sev) else len(a.sev)
    return gap


# ------------------------------------------------------------------- model


def tensors(params: Dict[str, np.ndarray], device, dtype=torch.float64,
            grad: bool = False) -> Dict[str, torch.Tensor]:
    return {k: torch.tensor(v, dtype=dtype, device=device, requires_grad=grad)
            for k, v in params.items()}


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(torch.clamp(torch.sum(x * x, -1, keepdim=True), min=1e-24))


def adjacency(state: State, layer: int, live: Optional[torch.Tensor], device,
              dtype=torch.float64) -> torch.Tensor:
    """The layer's unsevered adjacency (pair multiplicities), both
    directions, scaled by live on both ends when live is given: a sparse
    [n, n] tensor."""
    L = state.layers[layer]
    keep = ~L.sev
    u = torch.from_numpy(L.u[keep]).to(device)
    v = torch.from_numpy(L.v[keep]).to(device)
    w = torch.from_numpy(L.mult[keep]).to(device, dtype)
    if live is not None:
        w = w * live[u] * live[v]
    idx = torch.stack([torch.cat([v, u]), torch.cat([u, v])])
    return torch.sparse_coo_tensor(idx, torch.cat([w, w]), (state.n, state.n),
                                   check_invariants=False).coalesce()


@dataclasses.dataclass
class Inputs:
    x: torch.Tensor          # [2, n, F]
    aux: torch.Tensor        # [2, 4]
    active: torch.Tensor     # bool [n]
    deg: torch.Tensor        # [2, n] live degrees
    adj: List[torch.Tensor]  # live adjacency per layer


def inputs(state: State, n_edges: Sequence[int], weights: Optional[np.ndarray], cfg_ref,
           device, dtype=torch.float64) -> Inputs:
    n = state.n
    cov = torch.from_numpy(state.covered).to(device)
    live = (~cov).to(dtype)
    adj, deg, counters = [], [], []
    for layer in range(2):
        a_all = adjacency(state, layer, None, device, dtype)
        a_live = adjacency(state, layer, live, device, dtype)
        d = torch.sparse.mm(a_live, live[:, None])[:, 0] * live
        d_u = torch.sparse.mm(a_all, torch.ones(n, 1, dtype=dtype, device=device))[:, 0]
        adj.append(a_live)
        deg.append(d)
        counters.append(d_u.sum() / 2 - d.sum() / 2)
    deg = torch.stack(deg)
    active = (~cov) & (deg[0] > 0)
    w = None if weights is None else torch.from_numpy(np.asarray(weights)).to(device, dtype)
    x = cfg_ref.node_input(deg, active, w)
    e_cnt = torch.clamp(torch.tensor(list(n_edges), dtype=dtype, device=device), min=1.0)
    cov_frac = cov.sum().to(dtype) / n
    wedges = torch.sum(deg * (deg - 1.0) / 2.0, dim=1)
    aux = torch.stack([cov_frac.expand(2), torch.stack(counters) / e_cnt,
                       wedges / (float(n) * n), torch.ones(2, dtype=dtype, device=device)], -1)
    return Inputs(x, aux, active, deg, adj)


def embed(p: Dict[str, torch.Tensor], inp: Inputs, rounds: int = 3):
    """(H_f per layer [n, D], Y_f [2, D])."""
    c1, c2, c3 = p["p_node_conv"], p["p_node_conv2"], p["p_node_conv3"]
    f_dim = inp.x.shape[-1]
    ones = torch.zeros(f_dim, dtype=c1.dtype, device=c1.device)
    ones[:2] = 1.0
    hs, ys = [], []
    for layer in range(2):
        h = _l2n(torch.relu(inp.x[layer] @ p["w_n2l"]))
        y = _l2n(torch.relu(ones @ p["w_n2l"]))
        for _ in range(rounds):
            y_new = torch.cat([h.sum(0) @ c1, y @ c2])
            pool = torch.sparse.mm(inp.adj[layer], h)
            h = _l2n(torch.relu(torch.cat([pool @ c1, h @ c2], -1) @ c3))
            y = _l2n(torch.relu(y_new @ c3))
        hs.append(h)
        ys.append(y)

    def fuse(e0, e1):
        f0 = torch.tanh(e0 @ p["fusion.trans"] + p["fusion.bias"])
        f1 = torch.tanh(e1 @ p["fusion.trans"] + p["fusion.bias"])

        def one(fl, fo):
            a_self = torch.sigmoid((fl * fl) @ p["fusion.logis_w"] + p["fusion.logis_b"])
            a_other = torch.sigmoid((fo * fl) @ p["fusion.logis_w"] + p["fusion.logis_b"])
            w = torch.softmax(torch.cat([a_self, a_other], -1), -1)
            return fl + w[..., 1:2] * fo

        return one(f0, f1), one(f1, f0)

    act = inp.active.to(c1.dtype)[:, None]
    f0, f1 = fuse(hs[0], hs[1])
    g0, g1 = fuse(ys[0][None], ys[1][None])
    return [_l2n(f0) * act, _l2n(f1) * act], torch.stack([_l2n(g0)[0], _l2n(g1)[0]])


def q_head(p: Dict[str, torch.Tensor], h_f, y_f, aux) -> torch.Tensor:
    qs = []
    for layer in range(2):
        scal = y_f[layer] @ p["cross_product"]
        hidden = torch.relu((h_f[layer] * scal) @ p["h1_weight"])
        last = torch.cat([hidden, aux[layer].expand(hidden.shape[0], -1)], -1)
        qs.append((last @ p["h2_weight"])[:, 0])
    s = (torch.relu(y_f @ p["w_layer1"]) @ p["w_layer2"])[:, 0]
    w = torch.softmax(s, 0)
    return w[0] * qs[0] + w[1] * qs[1]


def q_values(p, inp: Inputs) -> torch.Tensor:
    """Q over all nodes, −inf off the active ones."""
    h_f, y_f = embed(p, inp)
    q = q_head(p, h_f, y_f, inp.aux)
    return torch.where(inp.active, q, torch.full_like(q, -float("inf")))


def loss(p, inp: Inputs, acts: torch.Tensor, targets: torch.Tensor, alpha: float):
    h_f, y_f = embed(p, inp)
    q = q_head(p, [h[acts] for h in h_f], y_f, inp.aux)
    mse = torch.mean(torch.square(q - targets))
    reg = 0.0
    for layer in range(2):
        h, d = h_f[layer], inp.deg[layer]
        quad = torch.sum(d * torch.sum(h * h, -1))
        cross = torch.sum(h * torch.sparse.mm(inp.adj[layer], h))
        reg = reg + 2.0 * (quad - cross) / torch.clamp(d.sum(), min=1.0)
    return mse + alpha * reg


class Adam:
    """torch.optim.Adam's update, written out (β 0.9 / 0.999, ε 1e-8)."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps, self.t = lr, b1, b2, eps, 0
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}

    def step(self, p: Dict[str, torch.Tensor], g: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        self.t += 1
        out = {}
        for k, x in p.items():
            m = self.b1 * self.m.get(k, torch.zeros_like(x)) + (1 - self.b1) * g[k]
            v = self.b2 * self.v.get(k, torch.zeros_like(x)) + (1 - self.b2) * g[k] * g[k]
            self.m[k], self.v[k] = m, v
            denom = torch.sqrt(v) / np.sqrt(1 - self.b2 ** self.t) + self.eps
            out[k] = (x - self.lr / (1 - self.b1 ** self.t) * m / denom).detach()
        return out
