"""Prioritized n-step replay (proportional, sum-tree); the port's copy of
the JAX package's rl/replay_prioritized.py, pure numpy.  Reference:
nstep_replay_mem_prioritized.py (SumTree :47-121, Memory :162-259).

Like the reference (IsPrioritizedSampling=False, and its prioritized fit path
is a stubbed TF relic :346-378), this is OFF by default; unlike the reference,
the sampling path here is actually functional: sample() returns importance
weights and tree indices, and update_priorities() applies clipped-TD-error
priorities, so a trainer can enable it end to end.

Vectorized sum-tree over numpy (no Python node objects): the tree is one array
of size 2*capacity-1; updates and sampling are O(log n) walks done with index
arithmetic on batches.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mdcommunity_tpu_torch.rl.replay import NStepReplay, ReplayBatch


@dataclasses.dataclass
class PrioritizedBatch:
    batch: ReplayBatch
    tree_idx: np.ndarray     # int64[B]
    is_weights: np.ndarray   # f32[B]


class SumTree:
    def __init__(self, capacity: int):
        self.capacity = capacity
        self.tree = np.zeros(2 * capacity - 1, np.float64)

    def update(self, data_idx: np.ndarray, priority: np.ndarray):
        idx = np.asarray(data_idx, np.int64) + self.capacity - 1
        self.tree[idx] = priority
        idx = np.unique(idx)
        # Bottom-up parent recompute.  For a non-power-of-two capacity the
        # complete tree's leaves sit on TWO depths, so a batch's parent sets
        # mix depths: chains that reach the root early must be RETIRED
        # (idx > 0 filter), not waited on — the old `(idx == 0).all()` exit
        # never fired for mixed batches and `(0 - 1) // 2 == -1` then walked
        # off the array (infinite loop + tree[-1] corruption once the buffer
        # held > 2^ceil(log2(cap))/2 - cap/2 ... transitions; regression test
        # in the JAX package's tests/test_replay_prioritized.py).
        #
        # INVARIANT (do not "optimize" away): with mixed leaf depths a parent
        # computed in iteration k may read a SIBLING that is itself an
        # ancestor of a deeper updated leaf and not yet recomputed — a
        # transiently stale sum.  This self-corrects only because every
        # updated node's full ancestor chain stays in the walk set until it
        # reaches the root, so the stale parent is recomputed again after the
        # deep chain passes through the sibling.  Retiring chains before
        # root (other than the idx > 0 filter) or deduplicating "already
        # computed this node" across iterations would silently corrupt
        # prefix sums; the JAX package's tests/test_replay_prioritized.py's whole-tree
        # consistency check is the guard.
        while idx.size:
            idx = np.unique((idx - 1) // 2)
            # every parent of a valid node is an internal node with both
            # children present (array size 2*capacity-1 is odd)
            left = 2 * idx + 1
            self.tree[idx] = self.tree[left] + self.tree[left + 1]
            idx = idx[idx > 0]

    def total(self) -> float:
        return float(self.tree[0])

    def sample(self, values: np.ndarray) -> np.ndarray:
        """Batch descend: for each v in values find the leaf covering it."""
        idx = np.zeros(len(values), np.int64)
        v = values.astype(np.float64).copy()
        for _ in range(int(np.ceil(np.log2(self.capacity))) + 2):
            left = 2 * idx + 1
            is_leaf = left >= len(self.tree)
            lv = np.where(is_leaf, 0.0, self.tree[np.minimum(left, len(self.tree) - 1)])
            # descend right when v exceeds the left mass OR the left subtree
            # is empty — ties/exact-zero v must never enter a zero-mass
            # region (zeroed-out stale leaves live there)
            go_right = (~is_leaf) & ((v > lv) | (lv <= 0.0))
            v = np.where(go_right, v - lv, v)
            idx = np.where(is_leaf, idx, np.where(go_right, left + 1, left))
        return idx - (self.capacity - 1)


class PrioritizedNStepReplay(NStepReplay):
    """NStepReplay + proportional priorities (hyperparameters mirror the
    reference trainer constants, MultiDismantler_torch.py:42-46)."""

    def __init__(self, capacity, pad_nodes, pad_edges, n_step=5,
                 epsilon=1e-7, alpha=0.6, beta=0.4,
                 beta_increment=1e-3, td_upper=1.0):
        super().__init__(capacity, pad_nodes, pad_edges, n_step)
        self.tree = SumTree(capacity)
        self.epsilon = epsilon
        self.alpha = alpha
        self.beta = beta
        self.beta_increment = beta_increment
        self.td_upper = td_upper
        self._max_priority = 1.0
        # per-slot write generation: lets DEFERRED priority updates (the
        # trainer applies step t's TD priorities during step t+1 to keep
        # dispatch pipelined) detect slots the ring overwrote in between
        self.write_gen = np.zeros(capacity, np.int64)
        self._gen = 0

    def _add(self, *args, **kwargs):
        idx = self.current
        super()._add(*args, **kwargs)
        self._gen += 1
        self.write_gen[idx] = self._gen
        self.tree.update(np.asarray([idx]), np.asarray([self._max_priority]))

    def sample_prioritized(
        self, rng: np.random.Generator, batch_size: int, slots_live=None
    ) -> PrioritizedBatch:
        """slots_live: optional (slots, epochs) -> bool mask from
        EpochGraphRing (same contract as NStepReplay.sample): transitions
        whose graph slot was overwritten by a later pool epoch must not be
        trained on — they would silently re-bind to the NEW graph in that
        slot.  The first stale pick triggers ONE batched zeroing of the
        entire stale set (lazy: costs O(count·log) only on draws that
        actually hit staleness, i.e. just after a pool regen) and a
        redraw."""
        assert self.count >= batch_size
        uniform_mask = None
        for _ in range(3):
            total = self.tree.total()
            seg = total / batch_size
            values = (np.arange(batch_size) + rng.random(batch_size)) * seg
            data_idx = np.clip(self.tree.sample(values), 0, self.count - 1)
            if slots_live is None:
                break
            live = slots_live(
                self.graph_ids[data_idx], self.graph_epochs[data_idx]
            )
            if live.all():
                break
            all_live = slots_live(
                self.graph_ids[: self.count], self.graph_epochs[: self.count]
            )
            dead = np.nonzero(~all_live)[0]
            if dead.size == self.count:  # nothing live: keep the draw
                break
            self.tree.update(dead, np.zeros(len(dead)))
            # bump the zeroed slots' write generation: a DEFERRED priority
            # update holding a pre-zeroing snapshot must not write a positive
            # priority back into a pool-stale slot (which would re-trigger
            # this whole zero-and-redraw pass on every subsequent fit)
            self._gen += 1
            self.write_gen[dead] = self._gen
        else:
            # 3 redraws exhausted with stale picks still present (possible:
            # the clipped descend can land on a dead index even after the
            # stale set was zeroed).  Replace the stale positions uniformly
            # from the live set rather than silently training on them.
            if slots_live is not None:
                live = slots_live(
                    self.graph_ids[data_idx], self.graph_epochs[data_idx]
                )
                if not live.all():
                    all_live = slots_live(
                        self.graph_ids[: self.count],
                        self.graph_epochs[: self.count],
                    )
                    pool = np.nonzero(all_live)[0]
                    if pool.size:
                        data_idx = data_idx.copy()
                        data_idx[~live] = rng.choice(
                            pool, size=int((~live).sum()), replace=True
                        )
                        uniform_mask = ~live
                        uniform_prob = 1.0 / pool.size
        self.beta = min(1.0, self.beta + self.beta_increment)
        leaf = self.tree.tree[data_idx + self.capacity - 1]
        prob = np.maximum(leaf / max(total, 1e-12), 1e-12)
        # replaced positions were drawn UNIFORMLY from the live pool, not by
        # priority: their IS weight must reflect the uniform draw
        # probability, not the replacement slot's leaf priority (ADVICE r3)
        if uniform_mask is not None:
            prob[uniform_mask] = uniform_prob
        weights = np.power(self.count * prob, -self.beta)
        weights = (weights / weights.max()).astype(np.float32)
        idx = data_idx
        return PrioritizedBatch(
            batch=self._gather(idx), tree_idx=idx, is_weights=weights
        )

    def update_priorities(
        self, data_idx: np.ndarray, td_errors: np.ndarray, write_gen=None
    ):
        """write_gen: per-index generation snapshot taken at SAMPLE time
        (self.write_gen[data_idx]); indices the ring has since overwritten
        are skipped so a deferred update cannot clobber a fresh transition's
        max-priority with an unrelated old TD error."""
        data_idx = np.asarray(data_idx)
        td_errors = np.asarray(td_errors)
        if write_gen is not None:
            keep = self.write_gen[data_idx] == np.asarray(write_gen)
            data_idx, td_errors = data_idx[keep], td_errors[keep]
            if not len(data_idx):
                return
        p = np.minimum(np.abs(td_errors) + self.epsilon, self.td_upper)
        p = np.power(p, self.alpha)
        self._max_priority = max(self._max_priority, float(p.max(initial=0.0)))
        self.tree.update(data_idx, p)
