"""Host-side dismantling environment for large single graphs.

Large-graph eval runs the interdependency cascade on the host and the model
on the card, as the reference splits its CPU env and CUDA net.  Two engines
share one surface: the native C++ union-find engine (native/), and this
module's numpy/scipy one, where connected_components is a C-speed O(N+E)
pass and the alternating MCC sever loop runs in a handful of such passes.

Semantics (the reference's mvc_env.py:31-162 and Mcc.py:30-38):

* reset runs the cascade on the intact graph (edges are usually severed at
  t=0: the two layers' partitions rarely agree).
* step(a): cover node a, re-run the cascade from the persistent severed
  state, accumulate score += rank/(max_rank·n), append rank/max_rank to the
  curve.
* terminal <=> some layer has no live edge (live = unsevered, both
  endpoints uncovered).
* newly severed undirected edges are reported per step, so the device-side
  band adjacency can be edited incrementally (graphs/banded.apply_severs).
* `cascade_stats` holds the last cascade's counters under the native
  engine's names (native.CASCADE_STATS) where this engine has them.
"""

from __future__ import annotations

import time
import warnings
from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import connected_components


def make_host_env(
    n: int,
    edges0: np.ndarray,
    edges1: np.ndarray,
    weights: Optional[np.ndarray] = None,
    engine: str = "auto",
):
    """A host env over canonicalised edges (u <= v, stably sorted by source,
    which makes the native engine's union-find sweep near-sequential over
    band-local ids).

    engine: "native" (the C++ engine, raises if it cannot build), "scipy",
    or "auto" (native when a toolchain exists, else scipy with a warning).
    The chosen engine's name is the env's `engine` attribute.  Where a card
    is present the native env comes with its device engine's kernels built
    (csrc/cascade.cu), so that moving it to the card (to(), which the
    banded loops call) compiles nothing."""

    def _canon(e):
        e = np.sort(np.asarray(e, np.int64).reshape(-1, 2), axis=1)
        return e[np.argsort(e[:, 0], kind="stable")]

    edges0, edges1 = _canon(edges0), _canon(edges1)
    if engine == "scipy":
        return HostDuplexEnv(n, edges0, edges1, weights)
    from mdcommunity_tpu_torch.native import NativeDuplexEnv, load

    if load() is not None:
        import torch

        if torch.cuda.is_available():
            from mdcommunity_tpu_torch.ops import cascade_kernels

            cascade_kernels.build()
        return NativeDuplexEnv(n, edges0, edges1, weights)
    if engine == "native":
        raise RuntimeError("the native host engine could not be built")
    warnings.warn("native host engine unavailable; using the scipy engine")
    return HostDuplexEnv(n, edges0, edges1, weights)


class HostDuplexEnv:
    """Single-graph duplex dismantling MDP on the host (numpy/scipy)."""

    engine = "scipy"

    def __init__(
        self,
        n: int,
        edges0: np.ndarray,
        edges1: np.ndarray,
        weights: Optional[np.ndarray] = None,
    ):
        self.n = int(n)
        self.edges = [
            np.asarray(edges0, np.int64).reshape(-1, 2),
            np.asarray(edges1, np.int64).reshape(-1, 2),
        ]
        self.weights = (
            np.asarray(weights, np.float64)
            if weights is not None
            else np.ones((2, n), np.float64)
        )
        self.wsum = self.weights[:, :n].sum(axis=1)
        self.reset()
        self.max_rank = self.rank  # intact LMCC (reference graph.py ori_rank)

    # -- cascade ------------------------------------------------------------

    def _labels(self, layer: int) -> np.ndarray:
        """Component labels of the live edges of `layer`; the pass's live
        edges and time go to the cascade's counters."""
        t0 = time.perf_counter_ns()
        e = self.edges[layer]
        live = self.alive_edge[layer]
        k = int(live.sum())
        m = sp.coo_matrix((np.ones(k), (e[live, 0], e[live, 1])), shape=(self.n, self.n))
        _, lab = connected_components(m, directed=False)
        self.cascade_stats["edges_walked"] += k
        self.cascade_stats["relabel_ns"] += time.perf_counter_ns() - t0
        return lab

    def _refresh_alive(self, layer: int):
        e = self.edges[layer]
        self.alive_edge[layer] = (
            ~self.sever[layer] & ~self.covered[e[:, 0]] & ~self.covered[e[:, 1]]
        )

    def _sever_cross(self, layer: int, lab: np.ndarray, new_sev) -> bool:
        """Sever the live edges of `layer` whose ends the other layer's
        labels `lab` put in two components; True when there were any."""
        t0 = time.perf_counter_ns()
        e = self.edges[layer]
        cross = self.alive_edge[layer] & (lab[e[:, 0]] != lab[e[:, 1]])
        k = int(cross.sum())
        if k:
            new_sev[layer].append(e[cross])
            self.sever[layer] |= cross
            self._refresh_alive(layer)
        self.cascade_stats["edges_severed"] += k
        self.cascade_stats["sever_test_ns"] += time.perf_counter_ns() - t0
        return k > 0

    def _cascade(self, t0_ns: int) -> Tuple[int, List[np.ndarray]]:
        """Alternating MCC sever loop; returns (rank, new undirected severed
        edge arrays per layer [K, 2]).  t0_ns: when the seeding (covering)
        began, booked as the cascade's cover_ns.  Counters: rounds, the live
        edges the label passes walked (the rank's too) and their ns, edges
        severed and the sever tests' ns, the rank's bincount ns."""
        self.cascade_stats = dict(rounds=0, edges_walked=0, edges_severed=0,
                                  cover_ns=time.perf_counter_ns() - t0_ns,
                                  relabel_ns=0, sever_test_ns=0, rank_ns=0, on_device=0)
        new_sev = [[], []]
        changed = True
        while changed:
            self.cascade_stats["rounds"] += 1
            changed = self._sever_cross(1, self._labels(0), new_sev)
            changed = self._sever_cross(0, self._labels(1), new_sev) or changed
        # rank: largest common component counted over alive nodes
        lab = self._labels(0)
        t0 = time.perf_counter_ns()
        alive = ~self.covered[: self.n]
        rank = int(np.bincount(lab[alive], minlength=1).max(initial=0))
        self.cascade_stats["rank_ns"] = time.perf_counter_ns() - t0
        outs = [
            np.concatenate(s, axis=0) if s else np.zeros((0, 2), np.int64)
            for s in new_sev
        ]
        return rank, outs

    # -- MDP ----------------------------------------------------------------

    def to(self, device) -> "HostDuplexEnv":
        """This engine stays on the host whatever the device (the native
        engine's to() moves its cascade to a card); returns the env."""
        return self

    def reset(self):
        t0 = time.perf_counter_ns()
        self.covered = np.zeros(self.n, bool)
        self.sever = [np.zeros(len(e), bool) for e in self.edges]
        self.alive_edge = [None, None]
        self._refresh_alive(0)
        self._refresh_alive(1)
        self.rank, _ = self._cascade(t0)
        self.score = 0.0
        self.curve = [1.0]
        self.t = 0

    @property
    def terminal(self) -> bool:
        return not (self.alive_edge[0].any() and self.alive_edge[1].any())

    def alive_nodes(self, layer: int) -> np.ndarray:
        """bool [n]: nodes with at least one live edge in `layer` (the
        native engine's alive_nodes)."""
        out = np.zeros(self.n, bool)
        e = self.edges[layer][self.alive_edge[layer]]
        out[e[:, 0]] = True
        out[e[:, 1]] = True
        return out

    def _record(self, acts, degree_cost: bool):
        norm = self.rank / max(self.max_rank, 1)
        for a in acts:
            if degree_cost:
                cost = 0.5 * (
                    self.weights[0, a] / self.wsum[0]
                    + self.weights[1, a] / self.wsum[1]
                )
                self.score += norm * cost
            else:
                self.score += norm / self.n
            self.curve.append(norm)
        self.t += len(acts)

    def step_many(
        self, actions: np.ndarray, degree_cost: bool = False
    ) -> Tuple[int, List[np.ndarray], int]:
        """Batched removal with ONE cascade; the same contract as
        NativeDuplexEnv.step_many.  Returns (rank, new severs per layer,
        n_removed)."""
        t0 = time.perf_counter_ns()
        acts = np.asarray(actions, np.int64).reshape(-1)
        acts = acts[(acts >= 0) & (acts < self.n)]
        acts = np.unique(acts[~self.covered[acts]])
        if not len(acts):
            return self.rank, [np.zeros((0, 2), np.int64)] * 2, 0
        self.covered[acts] = True
        self._refresh_alive(0)
        self._refresh_alive(1)
        self.rank, new_sev = self._cascade(t0)
        self._record(acts, degree_cost)
        return self.rank, new_sev, len(acts)

    def step(self, a: int, degree_cost: bool = False) -> Tuple[int, List[np.ndarray]]:
        """Cover node a, cascade; returns (rank, new severed undirected edges
        per layer).  Score/curve follow mvc_env.stepWithoutReward :74-87."""
        assert not self.covered[a], a
        t0 = time.perf_counter_ns()
        self.covered[a] = True
        self._refresh_alive(0)
        self._refresh_alive(1)
        self.rank, new_sev = self._cascade(t0)
        self._record([a], degree_cost)
        return self.rank, new_sev
