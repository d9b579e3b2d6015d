"""The plain reference of HCA-Dismantler's Q, in float64 PyTorch and numpy.

It imports nothing of the program: the state, the cascade and the weights
reader come from mdbench/reference.py.  It takes the generated edges, the
program's partition (each node's community a layer, checked to be a
partition of the n nodes) and the checkpoint, and recomputes for itself the
node features (configs/hca.py), the live adjacency and community graph,
the community sums, the rounds, the macro GCN, the fusion, the selection,
the decoder and the gate.  Node ids are the generator's.

What it computes (reference HCA-Dismantler/MultiDismantler_net_graphsage.py
train_forward :112-305, PrepareBatchGraph.subg_construct :430-473,
comm_adj_construct :491-541; the program's models/hca.py):

  active   every uncovered node (HCA keeps isolated survivors)
  x        the features on active nodes, 0 elsewhere; w_c(u) = f_roi + 1e-6
           on active nodes (the community pooling weights)
  embed    H0 = l2n(relu(x W_n2l)), H = H0 + 5·f_het·H0 a layer;
           Y0 = l2n(relu([1, 1, 1] W_n2l)) for every community;
           3 rounds: H' = l2n(relu([A_l H C1 ; H C2] C3)),
                     Y'_c = l2n(relu([Σ_{u in c} w_c(u) H_u C1 ; Y_c C2] C3))
  macro    Y = l2n(relu((A_comm Y) W_macro)), A_comm the live community
           graph: 1 where a live edge joins two communities, 1 on the
           diagonal (built here by a scatter over the live edges)
  fusion   BitwiseMultipyLogis over node rows and over community rows, no
           re-normalisation; node rows 0 off active
  decode   per layer: h_g = mean of Y over the communities, score_c =
           [Y_c ; h_g] w_comm_score, the k_top = max(1, ⌊0.3 · C⌋) (in f32)
           best communities (a stable sort: equal scores in index order);
           q_l(u) = [H_u ; w_c(u) Y_c(u)] w_micro_score where u's community
           is selected, −1e9 elsewhere
  gate     g_l = relu(h_g W1) W2, Q = Σ_l softmax(g)_l q_l, −inf off active

Departures from the reference repository, as the program makes them:
Louvain (networkx 3.6.1's, seed 0, resolution 1) in place of Leiden for
the partition; the gate averages the real communities (the reference's
averages its padded rows too); the true membership, not the reference's
collapsed one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mdbench import reference as ref

SENTINEL = -1e9


def check_partition(n: int, labels: np.ndarray) -> List[int]:
    """The community count a layer; raises unless labels [2, n] give each
    node one community in 0..count-1 and every community a node."""
    labels = np.asarray(labels)
    if labels.shape != (2, n) or not np.issubdtype(labels.dtype, np.integer):
        raise AssertionError(f"the partition is not [2, {n}] integers")
    counts = []
    for lab in labels:
        if n and (lab.min() < 0 or np.any(np.bincount(lab) == 0)):
            raise AssertionError("the partition leaves a community empty or an id negative")
        counts.append(int(lab.max()) + 1 if n else 0)
    return counts


@dataclasses.dataclass
class Out:
    """One forward: each layer's raw node Q (before the sentinel), the gate
    weights, the community scores, the selection, active nodes."""

    raw: torch.Tensor            # [2, n]
    gate: torch.Tensor           # [2]
    scores: List[torch.Tensor]   # [C_l] a layer
    k_top: List[int]
    mask: List[torch.Tensor]     # bool [C_l]: the reference's selection
    active: torch.Tensor         # bool [n]

    def q(self, cid: torch.Tensor, mask: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """Q over all nodes for a selection (the reference's by default)."""
        mask = self.mask if mask is None else mask
        q = 0.0
        for layer in range(2):
            sel = mask[layer][cid[layer]] & self.active
            q = q + self.gate[layer] * torch.where(sel, self.raw[layer],
                                                   torch.full_like(self.raw[layer], SENTINEL))
        return torch.where(self.active, q, torch.full_like(q, -math.inf))


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(torch.clamp(torch.sum(x * x, -1, keepdim=True), min=1e-24))


class HcaReference:
    """The reference's side of an HCA run: the intact graph's features from
    the program's partition, the weights, and the forward of a state."""

    def __init__(self, n: int, edges: Sequence[np.ndarray], labels: np.ndarray,
                 params: Dict[str, np.ndarray], cfg_ref, device, top_frac: float = 0.3,
                 rounds: int = 3):
        self.n = n
        self.counts = check_partition(n, labels)
        self.dev = device
        self.top_frac = top_frac
        self.rounds = rounds
        self.cid = torch.from_numpy(np.asarray(labels, np.int64)).to(device)
        self.feat = torch.from_numpy(cfg_ref.hca_features(n, edges, labels)).to(device)
        self.p = ref.tensors(params, device)

    def _sage(self, pool: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        p = self.p
        return _l2n(torch.relu(torch.cat([pool @ p["p_node_conv"], h @ p["p_node_conv2"]], -1)
                               @ p["p_node_conv3"]))

    def comm_graph(self, state: "ref.State", layer: int, live: torch.Tensor) -> torch.Tensor:
        """[C, C]: 1 where a live edge (unsevered, both ends present) joins
        two communities, 1 on the diagonal."""
        L, C = state.layers[layer], self.counts[layer]
        keep = torch.from_numpy(~L.sev).to(self.dev)
        u = torch.from_numpy(L.u).to(self.dev)[keep]
        v = torch.from_numpy(L.v).to(self.dev)[keep]
        ok = (live[u] > 0) & (live[v] > 0)
        cu, cv = self.cid[layer][u[ok]], self.cid[layer][v[ok]]
        a = torch.zeros(C * C, dtype=torch.float64, device=self.dev)
        one = torch.ones(len(cu), dtype=torch.float64, device=self.dev)
        a.index_add_(0, cu * C + cv, one).index_add_(0, cv * C + cu, one)
        a = (a.reshape(C, C) > 0).to(torch.float64)
        eye = torch.eye(C, dtype=torch.float64, device=self.dev)
        return a * (1.0 - eye) + eye

    def _fuse(self, e0: torch.Tensor, e1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        p = self.p
        f0 = torch.tanh(e0 @ p["fusion.trans"] + p["fusion.bias"])
        f1 = torch.tanh(e1 @ p["fusion.trans"] + p["fusion.bias"])

        def one(fl, fo):
            a_self = torch.sigmoid((fl * fl) @ p["fusion.logis_w"] + p["fusion.logis_b"])
            a_other = torch.sigmoid((fo * fl) @ p["fusion.logis_w"] + p["fusion.logis_b"])
            w = torch.softmax(torch.cat([a_self, a_other], -1), -1)
            return fl + w[..., 1:2] * fo

        return one(f0, f1), one(f1, f0)

    @torch.no_grad()
    def forward(self, state: "ref.State") -> Out:
        p, dev = self.p, self.dev
        active = torch.from_numpy(~state.covered).to(dev)
        live = active.to(torch.float64)
        x = torch.where(active[:, None], self.feat, torch.zeros_like(self.feat))
        w_c = torch.where(active, self.feat[:, 2] + 1e-6, torch.zeros_like(live))
        h0 = _l2n(torch.relu(x @ p["w_n2l"]))
        y0 = _l2n(torch.relu(torch.ones(3, dtype=torch.float64, device=dev) @ p["w_n2l"]))
        hs, ys = [], []
        for layer in range(2):
            C = self.counts[layer]
            adj = ref.adjacency(state, layer, live, dev)
            h = h0 + 5.0 * x[:, 0:1] * h0
            y = y0.expand(C, -1)
            for _ in range(self.rounds):
                pool = torch.sparse.mm(adj, h)
                ypool = torch.zeros(C, h.shape[1], dtype=torch.float64, device=dev).index_add_(
                    0, self.cid[layer], w_c[:, None] * h)
                h, y = self._sage(pool, h), self._sage(ypool, y)
            y = _l2n(torch.relu((self.comm_graph(state, layer, live) @ y) @ p["w_macro"]))
            hs.append(h)
            ys.append(y)
        hf = [f * live[:, None] for f in self._fuse(hs[0], hs[1])]
        yf = self._fuse_rows(ys[0], ys[1])
        raw, gate, scores, k_tops, masks = [], [], [], [], []
        for layer in range(2):
            y, C = yf[layer], self.counts[layer]
            h_g = y.mean(0)
            s = (torch.cat([y, h_g.expand(C, -1)], -1) @ p["w_comm_score"])[:, 0]
            k_top = max(1, int(np.float32(C) * np.float32(self.top_frac)))
            order = np.argsort(-s.cpu().numpy(), kind="stable")
            mask = torch.zeros(C, dtype=torch.bool)
            mask[torch.from_numpy(order[:k_top])] = True
            h_comm = w_c[:, None] * y[self.cid[layer]]
            raw.append((torch.cat([hf[layer], h_comm], -1) @ p["w_micro_score"])[:, 0])
            gate.append((torch.relu(h_g @ p["w_layer1"]) @ p["w_layer2"])[0])
            scores.append(s)
            k_tops.append(k_top)
            masks.append(mask.to(dev))
        return Out(torch.stack(raw), torch.softmax(torch.stack(gate), 0), scores, k_tops,
                   masks, active)

    def _fuse_rows(self, y0: torch.Tensor, y1: torch.Tensor):
        """Fusion pairs community row c of one layer with row c of the
        other (the program's community tables share their row index); a row
        beyond the other layer's count meets the padded table's row there,
        which the macro GCN leaves 0 (no community, no self loop)."""
        c = max(len(y0), len(y1))
        pad = [torch.cat([y, torch.zeros(c - len(y), y.shape[1], dtype=y.dtype, device=y.device)])
               for y in (y0, y1)]
        f0, f1 = self._fuse(pad[0], pad[1])
        return f0[: len(y0)], f1[: len(y1)]


# ---------------------------------------------------------------- the check


@dataclasses.dataclass
class Gaps:
    sel_gap: int          # nodes whose selection differs outside the near-ties
    q_err: float          # max |ΔQ| / max |Q| over the nodes both layers select
    pick_gap: float       # the worst pick's Q under the k-th best, over max |Q|
    excused: int          # near-tie communities whose selection the program decided
    both: int             # nodes both layers select


def gaps(out: Out, cid: torch.Tensor, q_prog: torch.Tensor, picks: torch.Tensor, k: int,
         tie: float) -> Gaps:
    """The program's Q (original ids, float64) and picks against the
    reference's forward.  A community whose reference score lies within
    tie · max |score| of the k_top-th best is a near-tie: its selection is
    taken as the program's Q shows it (the candidate Q, selected or not,
    nearest the program's over its nodes), and the reference's Q is formed
    with it.  sel_gap then counts the active nodes whose Q differs from it
    by more than half the sentinel's least weight (a selection differing
    in a layer moves Q by 1e9 times that layer's gate weight)."""
    q_prog = q_prog.to(out.raw.device, torch.float64)
    if not torch.equal(torch.isfinite(q_prog), out.active) or not bool(out.active.any()):
        return Gaps(math.inf, math.inf, math.inf, 0, 0)
    mask = [m.clone() for m in out.mask]
    excused = 0
    for layer in range(2):
        s = out.scores[layer]
        kth = torch.sort(s, descending=True).values[out.k_top[layer] - 1]
        near = torch.nonzero((s - kth).abs() <= tie * s.abs().max()).flatten().tolist()
        for c in near:
            nodes = (cid[layer] == c) & out.active
            if not bool(nodes.any()):
                continue
            err = []
            for on in (False, True):
                trial = [m.clone() for m in mask]
                trial[layer][c] = on
                err.append(float((out.q(cid, trial)[nodes] - q_prog[nodes]).abs().sum()))
            chosen = err[1] < err[0]
            excused += int(chosen != bool(mask[layer][c]))
            mask[layer][c] = chosen
    q_ref = out.q(cid, mask)
    act = out.active
    thr = 0.5 * abs(SENTINEL) * float(out.gate.min())
    diff = (q_prog - q_ref).abs()
    off = act & (diff > thr)
    both = act & mask[0][cid[0]] & mask[1][cid[1]] & ~off
    if not bool(both.any()):
        return Gaps(int(off.sum()), math.inf, math.inf, excused, 0)
    scale = float(q_ref[both].abs().max())
    scale = scale if scale > 0 else 1.0
    q_err = float(diff[both].max()) / scale
    picks = picks.to(q_ref.device)
    if len(picks) < min(k, int(act.sum())) or len(torch.unique(picks)) != len(picks):
        return Gaps(int(off.sum()), q_err, math.inf, excused, int(both.sum()))
    tau = float(torch.topk(q_ref[act], len(picks)).values[-1])
    pick_gap = max(0.0, tau - float(q_ref[picks].min())) / scale
    return Gaps(int(off.sum()), q_err, pick_gap, excused, int(both.sum()))
