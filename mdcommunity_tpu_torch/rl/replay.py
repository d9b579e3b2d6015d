"""n-step experience replay with mask-encoded states (the port's copy of the
JAX package's rl/replay.py, pure numpy: the port imports nothing of that
package).

Reference: NStepReplayMem (nstep_replay_mem.py).  There a transition stores the
graph object, covered-node lists and the per-layer severed-edge *sets* for both
s_t and s_{t+n} (the sever record is trajectory-dependent — see env/cascade.py).
Here a state is (graph_id, covered bool[N], sever bitmask) — graphs live once in
a device-resident pool and the buffer holds only compact numpy arrays (the sever
masks are bit-packed: ~0.5 KB per transition at E=1024 instead of 4 KB).

n-step return semantics match add_from_env (nstep_replay_mem.py:57-80):
  r_i = Σ_{j=i}^{min(i+n,T)-1} r_j ;  s'_i = state_{i+n} (or the terminal state),
  term_i = (i + n >= T).

The prioritized variant (nstep_replay_mem_prioritized.py) is provided in
rl/replay_prioritized.py; like the reference's (IsPrioritizedSampling=False,
fit path stubbed :346-378) it is off by default.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class ReplayBatch:
    graph_ids: np.ndarray     # int32[B]
    covered_st: np.ndarray    # bool[B, N]
    sever_st: np.ndarray      # bool[B, 2, E]
    actions: np.ndarray       # int32[B]
    rewards: np.ndarray       # f32[B]
    covered_sp: np.ndarray    # bool[B, N]
    sever_sp: np.ndarray      # bool[B, 2, E]
    terminal: np.ndarray      # bool[B]


class NStepReplay:
    def __init__(self, capacity: int, pad_nodes: int, pad_edges: int, n_step: int = 5):
        self.capacity = capacity
        self.n_step = n_step
        self.pad_n = pad_nodes
        self.pad_e = pad_edges
        self._packed_e = (2 * pad_edges + 7) // 8
        self._packed_n = (pad_nodes + 7) // 8

        self.graph_ids = np.zeros(capacity, np.int32)
        # pool epoch the graph slot belonged to when the transition was stored
        # (EpochGraphRing staleness tag; stays 0 for fixed pools)
        self.graph_epochs = np.zeros(capacity, np.int64)
        self.covered_st = np.zeros((capacity, self._packed_n), np.uint8)
        self.sever_st = np.zeros((capacity, self._packed_e), np.uint8)
        self.actions = np.zeros(capacity, np.int32)
        self.rewards = np.zeros(capacity, np.float32)
        self.covered_sp = np.zeros((capacity, self._packed_n), np.uint8)
        self.sever_sp = np.zeros((capacity, self._packed_e), np.uint8)
        self.terminal = np.zeros(capacity, bool)
        self.count = 0
        self.current = 0

    # -- packing helpers ------------------------------------------------------
    def _pack_n(self, m: np.ndarray) -> np.ndarray:
        return np.packbits(m.astype(bool), axis=-1)

    def _unpack_n(self, p: np.ndarray) -> np.ndarray:
        return np.unpackbits(p, axis=-1, count=self.pad_n).astype(bool)

    def _pack_e(self, m: np.ndarray) -> np.ndarray:
        return np.packbits(m.reshape(*m.shape[:-2], 2 * self.pad_e), axis=-1)

    def _unpack_e(self, p: np.ndarray) -> np.ndarray:
        flat = np.unpackbits(p, axis=-1, count=2 * self.pad_e).astype(bool)
        return flat.reshape(*flat.shape[:-1], 2, self.pad_e)

    # -- adding ---------------------------------------------------------------
    def add_episode(
        self,
        graph_id: int,
        covered_seq: List[np.ndarray],   # length T+1: covered before each step + final
        sever_seq: List[np.ndarray],     # length T+1: sever masks aligned with covered_seq
        actions: List[int],              # length T
        rewards: List[float],            # length T
        graph_epoch: int = 0,
    ):
        """Flush one finished episode into the ring (reference add_from_env)."""
        T = len(actions)
        assert len(covered_seq) == T + 1 and len(sever_seq) == T + 1 and T > 0
        suffix = np.concatenate([np.cumsum(np.asarray(rewards, np.float64)[::-1])[::-1], [0.0]])
        n = self.n_step
        for i in range(T):
            term = i + n >= T
            j = T if term else i + n
            r = suffix[i] - suffix[j]
            self._add(
                graph_id,
                covered_seq[i], sever_seq[i],
                actions[i], float(r),
                covered_seq[j], sever_seq[j],
                term, graph_epoch,
            )

    def _add(self, gid, cov_st, sev_st, a, r, cov_sp, sev_sp, term, epoch=0):
        c = self.current
        self.graph_ids[c] = gid
        self.graph_epochs[c] = epoch
        self.covered_st[c] = self._pack_n(cov_st)
        self.sever_st[c] = self._pack_e(sev_st)
        self.actions[c] = a
        self.rewards[c] = r
        self.covered_sp[c] = self._pack_n(cov_sp)
        self.sever_sp[c] = self._pack_e(sev_sp)
        self.terminal[c] = term
        self.count = max(self.count, c + 1)
        self.current = (c + 1) % self.capacity

    # -- sampling -------------------------------------------------------------
    def sample(
        self,
        rng: np.random.Generator,
        batch_size: int,
        slots_live=None,
    ) -> ReplayBatch:
        """Uniform sample without replacement (reference sampling :83-97).

        slots_live: optional callable (slots, epochs) -> bool mask from
        EpochGraphRing; transitions whose graph slot was overwritten by a later
        pool epoch are excluded (the reference never faces this — it stores
        graph objects — so exclusion keeps the same effective distribution)."""
        assert self.count >= batch_size, "not enough experience"
        if slots_live is not None:
            live = slots_live(
                self.graph_ids[: self.count], self.graph_epochs[: self.count]
            )
            pool = np.nonzero(live)[0]
            if len(pool) >= batch_size:
                idx = rng.choice(pool, size=batch_size, replace=False)
                return self._gather(idx)
        idx = rng.choice(self.count, size=batch_size, replace=False)
        return self._gather(idx)

    def _gather(self, idx: np.ndarray) -> ReplayBatch:
        return ReplayBatch(
            graph_ids=self.graph_ids[idx],
            covered_st=self._unpack_n(self.covered_st[idx]),
            sever_st=self._unpack_e(self.sever_st[idx]),
            actions=self.actions[idx],
            rewards=self.rewards[idx],
            covered_sp=self._unpack_n(self.covered_sp[idx]),
            sever_sp=self._unpack_e(self.sever_sp[idx]),
            terminal=self.terminal[idx],
        )
