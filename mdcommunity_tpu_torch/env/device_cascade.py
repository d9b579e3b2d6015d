"""The banded loops' LMCC cascade on the band's device.

`native.NativeDuplexEnv.to(cuda)` hands the C++ engine's state to a
DeviceCascade, which from then on serves the env: step_many, step, reset,
rank, terminal, sever, alive_nodes and cascade_stats.  The state lives on
the device (both layers' edge ends u, v as int32 in the env's edge order,
the sever and live masks, covered, each layer's labels and the mask of its
nodes with a live edge); the host keeps the
covered mirror the loops read, the score, the curve and t.

A cascade is from scratch, with the kernels of ops/cascade_kernels.py
(csrc/cascade.cu): cover the removed nodes, recompute both layers' live
edges, then alternate as native/src/mdc_native.cpp::DuplexEnv::cascade
does: a layer's connected components over its live edges, then the sever
test of the other layer's live edges against them (an edge is kept when
both ends carry one label and have a live edge in the labels' layer: the
C++ rule that a node with no live edge shares a component with nothing, a
self-loop on it included); a layer whose edges were
severed is recomputed, until a round severs nothing.  Severs only refine
the partitions, so the severs a set of removals forces do not depend on the
order in which they are found: the covered set, the sever masks, the rank
and terminal equal the C++ engine's exactly, and each cascade's new severs
are the same set (reported as node pairs in ascending edge id).  The rank
is the most uncovered nodes under one layer-0 label: 1 if every uncovered
node is a singleton, 0 if none is uncovered, as the C++ engine has it.
Score and curve follow the C++ formulas in the same order (the score's
terms summed one after another from the running score).

Each pass reads back one counter (a sever test's, to know whether the round
changed anything); the components passes sync for their time.  After a
cascade one small readback gives the new severs' counts, the rank and the
live counts.  The sever masks and alive_nodes are copied back only when
asked for.

cascade_stats keeps every key of native.CASCADE_STATS, with the device's
meaning: relabel_ns, the components passes (host clock, their sync
included); edges_walked, the live edges each components pass reads;
nodes_walked, n a pass (the labels it writes); edges_tested, the live edges
each sever test reads; rounds, edges_severed, cover_ns (the cover and both
live passes), sever_test_ns, rank_ns as their names say; records_relabelled
and nodes_moved, which have no device meaning, 0; on_device 1.

On CPU tensors the kernels' plain versions run (the CPU tests hold the
engine to the C++ one there).
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from mdcommunity_tpu_torch.native import CASCADE_STATS
from mdcommunity_tpu_torch.ops import cascade_kernels as ck

# slots of the counter tensor: live edges of layers 0, 1; new severs of
# layers 0, 1 (the append positions of the sever test); the rank
_LIVE, _SEV, _RANK = 0, 2, 4


class DeviceCascade:
    """The cascade state of a NativeDuplexEnv on `device`, taken from the
    env's C++ engine as it stands (covered, sever masks, rank, score,
    curve, t, the last cascade's severs and counters)."""

    def __init__(self, env, device):
        dev = torch.device(device)
        self.n = n = env.n
        self.edges = env.edges  # host int64 [m, 2]: the severs' pairs
        self.host_covered = env.covered  # the env's own mirror, kept in step
        self.u = [torch.from_numpy(np.ascontiguousarray(e[:, 0], np.int32)).to(dev)
                  for e in env.edges]
        self.v = [torch.from_numpy(np.ascontiguousarray(e[:, 1], np.int32)).to(dev)
                  for e in env.edges]
        self.sever = [torch.from_numpy(s).to(dev) for s in env.sever]
        self.covered = torch.from_numpy(env.covered.copy()).to(dev)
        self.device = self.covered.device
        self.alive = [torch.empty(len(e), dtype=torch.bool, device=dev) for e in env.edges]
        self.label = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(2)]
        self.touched = [torch.empty(n, dtype=torch.bool, device=dev) for _ in range(2)]
        self.scratch = torch.empty(n, dtype=torch.int32, device=dev)
        self.new_ids = [torch.empty(max(len(e), 1), dtype=torch.int32, device=dev)
                        for e in env.edges]
        self.ctr = torch.zeros(5, dtype=torch.int64, device=dev)
        w = env.weights if env.weights is not None else np.ones((2, n), np.float64)
        self.weights = w
        # the C++ engine's sums: one term after another in node order
        self.wsum = [float(np.cumsum(w[layer])[-1]) for layer in (0, 1)]
        self.max_rank = env.max_rank
        self.rank, self.score, self.curve, self.t = env.rank, env.score, env.curve, env.t
        self.new_sever = env._new_sever()
        self.stats: Dict[str, int] = env.cascade_stats
        self.live = self._refresh()

    # -- passes --------------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _refresh(self) -> List[int]:
        """Both layers' live edges from sever and covered; their counts."""
        for layer in (0, 1):
            ck.live_edges(self.u[layer], self.v[layer], self.sever[layer], self.covered,
                          self.alive[layer], self.ctr[_LIVE + layer:_LIVE + layer + 1])
        return self.ctr[_LIVE:_LIVE + 2].tolist()

    def _cascade(self, t0: int) -> None:
        """The alternating sever loop from the covered and sever state; t0:
        when the seeding (covering) began, booked as cover_ns."""
        st = dict.fromkeys(CASCADE_STATS, 0)
        st["on_device"] = 1
        self.ctr[_SEV:_SEV + 2].zero_()
        live = self._refresh()
        st["cover_ns"] = time.perf_counter_ns() - t0
        severed = [0, 0]
        dirty = [True, True]
        while dirty[0] or dirty[1]:
            st["rounds"] += 1
            for side in (0, 1):
                if not dirty[side]:
                    continue
                other = 1 - side
                t1 = time.perf_counter_ns()
                ck.components(self.u[side], self.v[side], self.alive[side], self.label[side],
                              self.touched[side])
                self._sync()
                t2 = time.perf_counter_ns()
                st["relabel_ns"] += t2 - t1
                st["nodes_walked"] += self.n
                st["edges_walked"] += live[side]
                dirty[side] = False
                ck.sever_test(self.u[other], self.v[other], self.alive[other],
                              self.sever[other], self.label[side], self.touched[side],
                              self.new_ids[other],
                              self.ctr[_SEV + other:_SEV + other + 1])
                k = int(self.ctr[_SEV + other])
                st["edges_tested"] += live[other]
                st["sever_test_ns"] += time.perf_counter_ns() - t2
                if k > severed[other]:
                    live[other] -= k - severed[other]
                    severed[other] = k
                    dirty[other] = True
        t3 = time.perf_counter_ns()
        ck.rank(self.label[0], self.covered, self.scratch, self.ctr[_RANK:_RANK + 1])
        self.rank = int(self.ctr[_RANK])
        st["rank_ns"] = time.perf_counter_ns() - t3
        st["edges_severed"] = severed[0] + severed[1]
        self.live = live
        self.new_sever = [self._pairs(layer, severed[layer]) for layer in (0, 1)]
        self.stats = st

    def _pairs(self, layer: int, k: int) -> np.ndarray:
        """The node pairs of the cascade's k new severs in `layer`, in
        ascending edge id (int64 [k, 2], as the C++ engine reports them)."""
        if not k:
            return np.zeros((0, 2), np.int64)
        ids = torch.sort(self.new_ids[layer][:k]).values.cpu().numpy()
        return self.edges[layer][ids]

    def _record(self, done: np.ndarray, degree_cost: bool) -> None:
        norm = self.rank / max(self.max_rank, 1)
        if degree_cost:
            w = self.weights
            terms = norm * (0.5 * (w[0, done] / self.wsum[0] + w[1, done] / self.wsum[1]))
        else:
            terms = np.full(len(done), norm / self.n)
        self.score = float(np.cumsum(np.concatenate(([self.score], terms)))[-1])
        self.curve.extend([norm] * len(done))
        self.t += len(done)

    # -- the env's surface ---------------------------------------------------

    def reset(self) -> None:
        t0 = time.perf_counter_ns()
        self.covered.zero_()
        self.host_covered[:] = False
        for s in self.sever:
            s.zero_()
        self._cascade(t0)
        self.score, self.curve, self.t = 0.0, [1.0], 0

    def step_many(self, actions, degree_cost: bool = False
                  ) -> Tuple[int, List[np.ndarray], int]:
        """The C++ step_many: cover the actions in [0, n) not yet covered
        (first occurrences, in order), ONE cascade, the post-batch norm once
        per removed node.  A batch that removes nothing runs no cascade and
        reports the last cascade's severs again, as the C++ engine does."""
        t0 = time.perf_counter_ns()
        acts = np.asarray(actions, np.int64).reshape(-1)
        acts = acts[(acts >= 0) & (acts < self.n)]
        acts = acts[~self.host_covered[acts]]
        if not len(acts):
            return self.rank, list(self.new_sever), 0
        _, first = np.unique(acts, return_index=True)
        done = acts[np.sort(first)]
        self.host_covered[done] = True
        ck.cover(self.covered, torch.from_numpy(done).to(self.device))
        self._cascade(t0)
        self._record(done, degree_cost)
        return self.rank, list(self.new_sever), len(done)

    def step(self, a: int, degree_cost: bool = False) -> Tuple[int, List[np.ndarray]]:
        rank, new_sev, _ = self.step_many([a], degree_cost)
        return rank, new_sev

    @property
    def terminal(self) -> bool:
        return not (self.live[0] > 0 and self.live[1] > 0)

    @property
    def sever_masks(self) -> List[np.ndarray]:
        return [s.to("cpu", copy=True).numpy() for s in self.sever]

    def alive_nodes(self, layer: int) -> np.ndarray:
        mask = torch.empty(self.n, dtype=torch.bool, device=self.device)
        ck.alive_nodes(self.u[layer], self.v[layer], self.alive[layer], mask)
        return mask.cpu().numpy()
