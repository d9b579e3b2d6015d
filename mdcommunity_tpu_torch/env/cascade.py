"""The interdependent-network LMCC cascade as a fixed point over masks.

Reference semantics (Mcc.py:30-38 + mvc_env.py:140-162): after node removals,
the two layers' connected-component partitions must agree; edges of one
layer whose endpoints lie in different components of the *other* layer are
severed, and the process alternates until both partitions coincide.
Severed edges are recorded and persist in the MDP state.  The largest set in
the common partition is the LMCC ("rank").

The JAX package's env/cascade.py, batched: every function here takes a
batched DuplexGraph (leading axis B) or a single one.  Two engines, chosen by
pad_n as the JAX package chooses them:

* pad_n <= 128: dense reachability.  The closure of each layer's live
  adjacency by repeated squaring of 0/1 matrices (exact in f32: entries stay
  0/1 and row sums stay below 2^24), and "sever layer-l edges whose
  endpoints lie in different components of the other layer" is the dense
  mask live_l & ~R_other.
* larger pads: min-label propagation with pointer jumping,
  lab <- min(lab, lab[lab], min-neighbour label), to its fixed point (labels
  = the least node index of each component, dead nodes the sentinel _BIG).

Both reach the same greatest fixed point as the JAX package, so labels,
severed sets and rank are equal to it exactly.  Iterating a converged state
changes nothing, so a batch runs until its last member converges, and the
label loop tests for convergence only every _CHECK_EVERY rounds (each test
is a host sync).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Sentinel label for dead nodes: bigger than any node index.
_BIG = 2**30

# At or below this pad_n the cascade runs on dense [N, N] reachability
# matrices; above it on per-edge label propagation (the JAX package's
# threshold, so both packages pick the same engine).
_DENSE_CASCADE_MAX_N = 128

# Label-propagation rounds between convergence tests.
_CHECK_EVERY = 4


class CascadeResult(NamedTuple):
    rank: torch.Tensor        # int64[B] LMCC size
    sever: torch.Tensor       # bool[B, 2, E] updated severed-edge masks
    labels: torch.Tensor      # int64[B, N] common partition labels (sentinel = dead)
    live_edge: torch.Tensor   # bool[B, 2, E] final live (unsevered, endpoints alive)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b, ...]] for x [B, N] and idx [B, ...]."""
    B = x.shape[0]
    return torch.gather(x, 1, idx.reshape(B, -1)).reshape(idx.shape)


def endpoints_alive(src, dst, covered) -> torch.Tensor:
    """bool[B, 2, E]: both endpoints of each directed edge uncovered."""
    return ~_take(covered, src) & ~_take(covered, dst)


def _propagate_once(lab, src, dst, live, flat_dst):
    """One round: lab[v] <- min(lab[v], lab[lab[v]], min_{u~v live} lab[u])."""
    B, N = lab.shape
    edge_lab = torch.where(live, _take(lab, src), torch.full_like(src, _BIG))
    msg = torch.full((B * N,), _BIG, dtype=lab.dtype, device=lab.device)
    msg = msg.scatter_reduce(0, flat_dst, edge_lab.reshape(-1), "amin").reshape(B, N)
    jump = _take(lab, lab.clamp(0, N - 1))
    jump = torch.where(lab < N, jump, lab)
    return torch.minimum(torch.minimum(lab, msg), jump)


def _cc_labels(alive, src, dst, live) -> torch.Tensor:
    """Connected-component labels (the least node index of the component)
    of one layer per graph, dead nodes _BIG: int64[B, N].
    alive bool[B, N]; src, dst int64[B, E]; live bool[B, E]."""
    B, N = alive.shape
    ar = torch.arange(N, device=alive.device)
    lab = torch.where(alive, ar, torch.full_like(ar, _BIG))
    flat_dst = (dst + (torch.arange(B, device=dst.device) * N)[:, None]).reshape(-1)
    lab = _propagate_once(lab, src, dst, live, flat_dst)
    while True:
        prev = lab
        for _ in range(_CHECK_EVERY):
            lab = _propagate_once(lab, src, dst, live, flat_dst)
        # rounds never raise a label, so no change over the rounds means
        # no change in any of them: a fixed point
        if torch.equal(lab, prev):
            return lab


def connected_components(alive, src, dst, live) -> torch.Tensor:
    """Component labels for one layer (least-index labelling), batched
    ([B, N] / [B, E]) or not ([N] / [E])."""
    if alive.dim() == 1:
        return _cc_labels(alive[None], src[None], dst[None], live[None])[0]
    return _cc_labels(alive, src, dst, live)


def _closure(adj: torch.Tensor, n_sq: int) -> torch.Tensor:
    """Transitive closure of symmetric 0/1 adjacencies [B, N, N] (self loops
    included) by repeated squaring: after k squarings R covers paths of
    length 2^k."""
    r = adj
    for _ in range(n_sq):
        r = torch.clamp(torch.matmul(r, r), max=1.0)
    return r


def _dense_cascade(g, covered, sever) -> CascadeResult:
    B, N, E = covered.shape[0], g.pad_n, g.pad_e
    dev = covered.device
    n_sq = max(1, (N - 1).bit_length())
    alive = g.node_mask & ~covered
    ep = endpoints_alive(g.src, g.dst, covered)
    live0 = g.edge_mask & ~sever & ep
    # dense live adjacency per layer: a max-scatter of the live flags, so
    # the padding edges' duplicate (0, 0) entries cannot overwrite a real
    # one (edges are stored in both directions: the result is symmetric)
    bl = torch.arange(2 * B, device=dev).reshape(B, 2, 1)
    cell = ((bl * N + g.src) * N + g.dst).reshape(-1)
    adj = torch.zeros(B * 2 * N * N, dtype=torch.float32, device=dev)
    adj = adj.scatter_reduce(0, cell, live0.to(torch.float32).reshape(-1), "amax")
    adj = adj.reshape(B, 2, N, N)
    eye = torch.eye(N, dtype=torch.float32, device=dev)

    while True:
        r0 = _closure(adj[:, 0] + eye, n_sq)
        # sever live layer-1 edges crossing layer-0 components
        cross1 = adj[:, 1] * (1.0 - r0)
        a1 = adj[:, 1] - cross1
        r1 = _closure(a1 + eye, n_sq)
        cross0 = adj[:, 0] * (1.0 - r1)
        a0 = adj[:, 0] - cross0
        adj = torch.stack([a0, a1], dim=1)
        if not ((cross0 > 0).any() or (cross1 > 0).any()):
            break
    r0 = _closure(adj[:, 0] + eye, n_sq)
    alive_f = alive.to(torch.float32)
    comp_size = torch.matmul(r0, alive_f[..., None])[..., 0]
    rank = torch.amax(torch.where(alive, comp_size, torch.zeros_like(comp_size)), dim=1)
    iota = torch.arange(N, device=dev)
    labels = torch.amin(torch.where(r0 > 0, iota, torch.full_like(iota, _BIG)), dim=2)
    labels = torch.where(alive, labels, torch.full_like(labels, _BIG))
    # an edge is (newly) severed iff it was live on entry and is no longer
    # live in the dense state
    live_dense = adj.reshape(-1)[cell].reshape(B, 2, E) > 0
    new_sever = sever | (live0 & ~live_dense)
    le = g.edge_mask & ~new_sever & ep
    return CascadeResult(rank=rank.to(torch.int64), sever=new_sever, labels=labels,
                         live_edge=le)


def _label_cascade(g, covered, sever) -> CascadeResult:
    B, N = covered.shape
    alive = g.node_mask & ~covered
    ep = endpoints_alive(g.src, g.dst, covered)
    sever = sever.clone()
    src, dst = g.src, g.dst

    def live():
        return g.edge_mask & ~sever & ep

    while True:
        le = live()
        lab0 = _cc_labels(alive, src[:, 0], dst[:, 0], le[:, 0])
        # sever live layer-1 edges crossing layer-0 components
        cross1 = le[:, 1] & (_take(lab0, src[:, 1]) != _take(lab0, dst[:, 1]))
        sever[:, 1] |= cross1
        le = live()
        lab1 = _cc_labels(alive, src[:, 1], dst[:, 1], le[:, 1])
        cross0 = le[:, 0] & (_take(lab1, src[:, 0]) != _take(lab1, dst[:, 0]))
        sever[:, 0] |= cross0
        if not (cross0.any() or cross1.any()):
            break
    le = live()
    labels = _cc_labels(alive, src[:, 0], dst[:, 0], le[:, 0])
    sizes = torch.zeros((B, N), dtype=torch.int64, device=covered.device)
    sizes.scatter_add_(1, labels.clamp(0, N - 1), alive.to(torch.int64))
    return CascadeResult(rank=sizes.amax(dim=1), sever=sever, labels=labels,
                         live_edge=le)


def _batched_call(fn, g, covered, sever) -> CascadeResult:
    if g.batched:
        return fn(g, covered, sever)
    res = fn(g.map(lambda t: t[None]), covered[None], sever[None])
    return CascadeResult(*(x[0] for x in res))


def cascade(g, covered: torch.Tensor, sever: torch.Tensor) -> CascadeResult:
    """Run the mutually-connected-component cascade.

    g: DuplexGraph, batched or single; covered bool[(B,) N] removed nodes;
    sever bool[(B,) 2, E] previously severed directed edges (persistent
    state, reference: mvc_env.py remove_edge threading).  Matches
    Mcc.MCC + find_max_set_length (Mcc.py:30-38,12-13) on the graph induced
    by uncovered nodes."""
    fn = _dense_cascade if g.pad_n <= _DENSE_CASCADE_MAX_N else _label_cascade
    return _batched_call(fn, g, covered, sever)


def cascade_from_scratch(g, covered: torch.Tensor) -> CascadeResult:
    """The cascade from only the covered set (no prior sever state).  Its
    live edge set (and so rank and terminality) matches any incremental
    trajectory reaching this covered set; the severed mask may be a subset
    of the incremental record."""
    return cascade(g, covered, torch.zeros_like(g.edge_mask))


def intact_max_rank(g) -> torch.Tensor:
    """LMCC of the intact graph(s) (reference: graph.py ori_rank :44-47):
    int64[] for one graph, int64[B] for a batch."""
    return cascade_from_scratch(g, torch.zeros_like(g.node_mask)).rank
