"""Typed configuration system (a copy of the JAX package's Config, so the
port imports nothing of that package).

The reference keeps its configuration as module-level constants at the top of each
variant's trainer (reference: MultiDismantler_torch.py:33-64) plus boolean feature
flags on the agent (:79-87) and SMOKE_TEST env vars (:127-143).  Here the whole
surface is a frozen dataclass so a variant is a value, not a directory copy.

Variants (reference: four sibling trees under /root/reference/code):
  unit_cost    — canonical MultiDismantler; removal cost 1 per node
  degree_cost  — cost proportional to normalized degree
  ce           — CEMultiDismantler: static Louvain community prior feature +
                 boundary-first action pruning
  hca          — HCA-Dismantler: Leiden communities, community virtual nodes,
                 hierarchical decoder (config hooks; model in models/hca.py)
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Config:
    # ---- variant ------------------------------------------------------------
    variant: str = "unit_cost"  # unit_cost | degree_cost | ce | hca

    # ---- model (reference: MultiDismantler_torch.py:33-64) ------------------
    embedding_size: int = 64          # EMBEDDING_SIZE
    reg_hidden: int = 32              # REG_HIDDEN
    max_bp_iter: int = 3              # message-passing rounds
    aux_dim: int = 4                  # aux feature dim per layer
    node_feat_dim: int = 2            # input feature dim (3 for ce variant)
    gate_hidden: int = 128            # w_layer1 hidden width (net :86-89)
    w_init_std: float = 1.0           # truncated-normal-ish init std (net :30)
    aggregator_id: int = 0            # 0 sum | 1 mean | 2 GCN-norm (PrepareBatchGraph.py:236-245)
    fusion: str = "bitwise_logis"     # cross-layer fusion: bitwise_logis (the
                                      # reference's live module) |
                                      # layer_node_attention | cosine | semantic
                                      # (MRGNN/mutil_layer_weight.py alternatives)

    # ---- DQN ----------------------------------------------------------------
    gamma: float = 1.0                # GAMMA
    n_step: int = 5                   # N_STEP
    batch_size: int = 64              # BATCH_SIZE
    learning_rate: float = 1e-4       # LEARNING_RATE
    memory_size: int = 100_000        # MEMORY_SIZE
    update_time: int = 1000           # target-net snapshot interval
    max_iteration: int = 31_000       # MAX_ITERATION
    save_frequency: int = 1000        # SAVE_FREQUENCY / validation interval
    alpha_recon: float = 1e-3         # Alpha: Laplacian reconstruction loss weight
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_step: float = 10_000.0
    use_double_dqn: bool = False      # IsDoubleDQN
    use_huber: bool = False           # IsHuberloss
    use_prioritized: bool = False     # IsPrioritizedSampling (functional here,
                                      # unlike the reference's stubbed fit path)
    warmup_games: int = 10
    warmup_traj: int = 100

    # ---- data ---------------------------------------------------------------
    num_min: int = 30                 # NUM_MIN — synthetic graph size range
    num_max: int = 50                 # NUM_MAX
    n_train: int = 1000               # training pool size
    n_valid: int = 200                # validation pool size
    num_env: int = 32                 # parallel envs (reference: 1; we vectorize)
    rollout_chunk: int = 8            # env steps per on-device scan chunk (one
                                      # host transfer per chunk, not per step)
    pool_ring_epochs: int = 8         # pool epochs kept device-resident so
                                      # replayed transitions stay bound to their
                                      # graphs across regens (EpochGraphRing)
    gmm_g: Optional[float] = 0.5      # GMM angular correlation; None = U(0,1)
                                      # per graph (the capsule pins g=0.5,
                                      # GMM.py:12-13, but its committed "g0-1"
                                      # checkpoints/curves were trained with the
                                      # commented-out random.uniform(0,1) line)

    # ---- padding (static shapes for jit) ------------------------------------
    # max nodes / max *directed* edges per layer after padding. 0 = derive.
    pad_nodes: int = 64
    pad_edges: int = 1024

    # ---- ce / hca variant knobs --------------------------------------------
    comm_prior_feature: str = "boundary"   # none | boundary | participation (CE :45-49)
    action_pruning_train: bool = True      # CE ACTION_PRUNING_TRAIN
    action_pruning_test: bool = False      # CE ACTION_PRUNING_TEST
    hca_beta: float = 0.5                  # HCA bridge-reward weight (mvc_env.py:36)
    hca_tau: float = 0.5                   # HCA f_het gate (mvc_env.py:37)
    hca_top_frac: float = 0.3              # HCA decoder top-community fraction
    hca_bridge_effective: bool = True      # intent semantics; False reproduces the
                                           # reference's always-zero bonus (see
                                           # env.hca_bridge_bonus)

    # ---- numerics / hardware ------------------------------------------------
    dtype: str = "float32"            # model compute dtype ("bfloat16" for speed)
    dense_threshold: int = 2048       # use dense MXU aggregation below this N
    seed: int = 0
    debug_nans: bool = False          # nan-checker on every op output — the
                                      # analogue of the reference's
                                      # torch.autograd.set_detect_anomaly(True)
                                      # (train.py:23); big slowdown, debug only

    # ---- parallelism --------------------------------------------------------
    dp_axis: str = "dp"
    gp_axis: str = "gp"               # graph (edge-partition) axis

    def __post_init__(self):
        if self.variant in ("ce", "hca"):
            object.__setattr__(self, "node_feat_dim", 3)

    @property
    def smoke(self) -> "Config":
        """SMOKE_TEST configuration: full pipeline, shrunk sizes
        (reference: MultiDismantler_torch.py:127-143)."""
        return dataclasses.replace(
            self,
            n_train=int(os.getenv("SMOKE_TRAIN", "16")),
            n_valid=int(os.getenv("SMOKE_VALID", "4")),
            max_iteration=int(os.getenv("SMOKE_ITER", "50")),
            batch_size=int(os.getenv("SMOKE_BATCH", "8")),
            warmup_games=int(os.getenv("SMOKE_WARMUP_GAMES", "2")),
            warmup_traj=int(os.getenv("SMOKE_WARMUP_TRAJ", "20")),
        )

    def padded_shapes(self, n_nodes: int, n_edges_dir: int) -> Tuple[int, int]:
        """Round (nodes, directed edges) up to padding-friendly multiples."""
        def up(x, m):
            return ((max(x, 1) + m - 1) // m) * m
        return up(n_nodes, 8), up(n_edges_dir, 128)


def smoke_requested() -> bool:
    return os.getenv("SMOKE_TEST", "0").strip().lower() in ("1", "true", "yes")
