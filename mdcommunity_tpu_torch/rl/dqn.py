"""The small-graph DQN agent: rollouts, the train step, validation,
checkpoints (the JAX package's rl/dqn.py).

Reference: class MultiDismantler (MultiDismantler_torch.py).  Structural map:

  Train                :433-547   -> DQNAgent.train (the same schedule: pool
                                     regeneration / play / validate /
                                     snapshot / fit)
  Run_simulator        :183-208   -> DQNAgent.play_games, over a vector of
                                     num_env environments stepped on the
                                     device (rollout_autoreset)
  Predict/SetuppredAll :247-302   -> predict_q (batch operands + forward)
  Fit/fit/calc_loss    :315-431   -> train_step (target + loss + Adam)
  TakeSnapShot         :312-313   -> target <- net
  Test                 :738-755   -> validate (every validation env rolled
                                     out in one batched greedy sweep)
  SaveModel/LoadModel  :787-797   -> save / load (the full training state:
                                     true resume, where the reference keeps
                                     weights only)

Epsilon schedule: eps_end + max(0, (eps_start-eps_end)·(eps_step-iter)/eps_step)
(reference :501).

The JAX package jits its steps and scans its rollouts (lax.scan,
lax.while_loop); here they are Python loops over batched tensor ops on the
agent's device, with no host sync inside a rollout chunk.  The dense engine
(a batched matmul with the live adjacency) does every aggregation, as in the
JAX package: no hand kernel runs on this path.  The JAX agent draws its
exploration from a jax.random key; the port cannot import JAX, so it draws
from a torch.Generator on the CPU seeded from the agent's seed (the same
distributions, other numbers), while the pools, the environment slots and
the replay batches come from the agent's np.random.Generator in the JAX
package's order, so the same seed gives the same graphs and batches.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mdcommunity_tpu_torch.env.batch import make_batch_inputs
from mdcommunity_tpu_torch.env.env import (
    EnvState,
    batched_reset,
    batched_step,
    hca_bridge_bonus,
    prune_q_to_boundary,
    random_action,
)
from mdcommunity_tpu_torch.graphs.duplex import EpochGraphRing, GraphPool, index_graphs
from mdcommunity_tpu_torch.graphs.gmm import generate_pool
from mdcommunity_tpu_torch.models.checkpoint import load_agent_state, save_agent_state
from mdcommunity_tpu_torch.models.net import (
    _aggregate,
    from_jax_params,
    init_params,
    laplacian_regularizer,
    test_forward,
    to_jax_params,
    train_forward,
)
from mdcommunity_tpu_torch.parallel.mesh import all_gather_rows, all_reduce, reduce_grads
from mdcommunity_tpu_torch.utils.config import Config
from mdcommunity_tpu_torch.utils.device import (
    matmul_precision,
    resolve_device,
    set_precise_matmul,
)
from mdcommunity_tpu_torch.utils.profiling import ThroughputMeter, device_timer

VARIANTS = ("unit_cost", "degree_cost", "ce", "hca")


def prior_feature(cfg: Config) -> str:
    """The graph structure a variant's pools carry (the JAX agent's
    _prior_feature): CE its community prior, HCA its communities."""
    if cfg.variant == "ce":
        return cfg.comm_prior_feature
    return "hca" if cfg.variant == "hca" else "none"


@torch.no_grad()
def predict_q(net, g, covered, sever, variant: str = "unit_cost", dense: bool = True,
              max_bp_iter: int = 3, aggregate_fn=None) -> torch.Tensor:
    """Batched Q(s, ·) [B, N] with dead and covered nodes at -inf;
    aggregate_fn replaces the dense or segment aggregation
    (models/net.make_blocked_aggregate).  HCA runs models/hca.hca_forward
    on its dense inputs with c_pad = pad_n, as the JAX package's
    predict_q."""
    if variant == "hca":
        from mdcommunity_tpu_torch.models.hca import hca_forward, make_hca_inputs

        return hca_forward(net, make_hca_inputs(g, covered, sever, c_pad=g.pad_n),
                           max_bp_iter=max_bp_iter)[0]
    inputs = make_batch_inputs(g, covered, sever, dense=dense, variant=variant)
    return test_forward(net, g, inputs, max_bp_iter=max_bp_iter, aggregate_fn=aggregate_fn)


def train_step(
    net,
    target_net,
    optimizer: Optional[torch.optim.Optimizer],
    g,
    covered_st: torch.Tensor,
    sever_st: torch.Tensor,
    actions: torch.Tensor,
    rewards: torch.Tensor,
    covered_sp: torch.Tensor,
    sever_sp: torch.Tensor,
    terminal: torch.Tensor,
    is_weights: Optional[torch.Tensor] = None,
    variant: str = "unit_cost",
    gamma: float = 1.0,
    alpha_recon: float = 1e-3,
    use_double_dqn: bool = False,
    use_huber: bool = False,
    max_bp_iter: int = 3,
    mesh=None,
):
    """One SGD step (reference Fit -> fit -> calc_loss, :315-431; the JAX
    package's train_step): the n-step target r + gamma·max_a' Q_target(s',
    a') (0 at terminal; with use_double_dqn the argmax is the online net's),
    the loss mean(w·(target - Q(s, a))²), or w·Huber with δ = 1, plus
    alpha_recon × the batched Laplacian regularizer, then one step of
    `optimizer`.  g is the batch's graphs, every tensor on net's device.
    variant "hca" runs models/hca.hca_forward on make_hca_inputs(c_pad =
    pad_n) for s' and s, and its Laplacian term hca_laplacian (JAX
    rl/dqn.py:103-142); the others the base net on env/batch's inputs.

    A parameter the loss does not reach (the attention leaves of the
    additive fusion modes, HCA's unused base head) gets a gradient of
    exactly 0, as jax.grad gives it, so the optimizer keeps a state for it.

    Returns (loss, mse, recon, td = target - Q(s, a)), detached, without a
    host sync.  optimizer=None leaves the gradients in the parameters'
    .grad and takes no step.

    mesh (parallel/mesh.GpMesh with dp replicas, one process each): the
    batch arguments are this replica's rows of the global batch (its
    len/dp rows, in order) and the step is the global batch's, as the JAX
    package's step on a dp-sharded batch: the mean's denominator is the
    global batch size and the Laplacian's |E_l| the whole batch's, so the
    replicas' losses are parts of the global one; their gradients are summed
    before the step.  Every replica returns the global loss, mse and recon,
    and td for the whole batch in batch order."""
    if variant == "hca":
        return _hca_train_step(net, target_net, optimizer, g, covered_st, sever_st, actions,
                               rewards, covered_sp, sever_sp, terminal, is_weights, gamma,
                               alpha_recon, use_double_dqn, use_huber, max_bp_iter, mesh)
    with torch.no_grad():
        inputs_sp = make_batch_inputs(g, covered_sp, sever_sp, dense=True, variant=variant)
        q_sp_t = test_forward(target_net, g, inputs_sp, max_bp_iter=max_bp_iter)
        q_sp_o = (test_forward(net, g, inputs_sp, max_bp_iter=max_bp_iter)
                  if use_double_dqn else None)
        target = rewards + gamma * _max_q(q_sp_t, q_sp_o, terminal)

    inputs_st = make_batch_inputs(g, covered_st, sever_st, dense=True, variant=variant)
    q, h_f = train_forward(net, g, inputs_st, actions, max_bp_iter=max_bp_iter)
    mse = _td_loss(q, target, is_weights, use_huber, mesh)
    recon = laplacian_regularizer(
        h_f, inputs_st.deg.transpose(0, 1),
        lambda layer, h: _aggregate(g, inputs_st, layer, h), mesh, "dp")
    return _finish_step(net, optimizer, mse, recon, alpha_recon, target - q, mesh)


def _max_q(q_sp_t, q_sp_o, terminal):
    """max_a' Q_target(s', a'), at the online net's argmax when q_sp_o is
    given (double DQN), 0 at terminal."""
    if q_sp_o is not None:
        max_q = torch.gather(q_sp_t, 1, torch.argmax(q_sp_o, dim=1)[:, None])[:, 0]
    else:
        max_q = torch.amax(q_sp_t, dim=1)
    return torch.where(terminal, torch.zeros_like(max_q), max_q)


def _td_loss(q, target, is_weights, use_huber, mesh=None):
    """The weighted TD loss's mean over the batch; with a dp mesh this
    replica's part of the global batch's mean."""
    if use_huber:
        per = F.huber_loss(q, target, reduction="none", delta=1.0)
    else:
        per = torch.square(target - q)
    per = per if is_weights is None else is_weights * per
    if mesh is None:
        return torch.mean(per)
    return torch.sum(per) / (per.shape[0] * mesh.dp)


def _finish_step(net, optimizer, mse, recon, alpha_recon, td, mesh=None):
    loss = mse + alpha_recon * recon
    net.zero_grad(set_to_none=True)
    loss.backward()
    for p in net.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if mesh is not None:
        reduce_grads(mesh, net.parameters(), "dp")
    if optimizer is not None:
        optimizer.step()
    out = [loss.detach(), mse.detach(), recon.detach()]
    if mesh is None:
        return (*out, td.detach())
    return (*[all_reduce(mesh, x, "dp") for x in out],
            all_gather_rows(mesh, td.detach(), "dp"))


def _hca_train_step(net, target_net, optimizer, g, covered_st, sever_st, actions, rewards,
                    covered_sp, sever_sp, terminal, is_weights, gamma, alpha_recon,
                    use_double_dqn, use_huber, max_bp_iter, mesh=None):
    """train_step for HCA (JAX rl/dqn.py:103-142).  hca_forward is
    differentiable in the parameters; its community ranking (a stable
    argsort) carries no gradient, as jnp.argsort carries none.  The
    unselected nodes' -1e9·w sentinel stays in the loss as it is, as in
    the JAX package."""
    from mdcommunity_tpu_torch.models.hca import hca_forward, hca_laplacian, make_hca_inputs

    with torch.no_grad():
        inputs_sp = make_hca_inputs(g, covered_sp, sever_sp, c_pad=g.pad_n)
        q_sp_t = hca_forward(target_net, inputs_sp, max_bp_iter=max_bp_iter)[0]
        q_sp_o = (hca_forward(net, inputs_sp, max_bp_iter=max_bp_iter)[0]
                  if use_double_dqn else None)
        target = rewards + gamma * _max_q(q_sp_t, q_sp_o, terminal)
    inputs_st = make_hca_inputs(g, covered_st, sever_st, c_pad=g.pad_n)
    q_all, h_f = hca_forward(net, inputs_st, max_bp_iter=max_bp_iter)
    q = q_all[torch.arange(actions.shape[0], device=actions.device), actions]
    mse = _td_loss(q, target, is_weights, use_huber, mesh)
    recon = hca_laplacian(h_f, inputs_st, mesh)
    return _finish_step(net, optimizer, mse, recon, alpha_recon, target - q, mesh)


def _pack_bits_u8(x: torch.Tensor) -> torch.Tensor:
    """bool[..., M] (M % 8 == 0) -> uint8[..., M // 8], np.packbits' layout
    (most significant bit first), so the host can np.unpackbits it."""
    b = x.reshape(x.shape[:-1] + (x.shape[-1] // 8, 8)).to(torch.int32)
    w = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32, device=x.device)
    return (b * w).sum(-1).to(torch.uint8)


# the history fields of a rollout chunk and their dtypes on the host
_HIST = (("gid", np.int32), ("actions", np.int32), ("rewards", np.float32),
         ("valid", np.bool_), ("done", np.bool_), ("covered", np.bool_),
         ("sever", np.uint8))


def fetch_history(hist: Dict[str, torch.Tensor], gids: torch.Tensor):
    """(history as numpy arrays [n_steps, B, ...], final gids [B]) in ONE
    device-to-host transfer: every field is laid out as bytes side by side
    in one uint8 tensor on the device, copied once, and cut apart on the
    host (the JAX package's single jax.device_get of the chunk)."""
    n_steps, B = hist["actions"].shape
    parts, widths = [], []
    fields = [(k, hist[k], dt) for k, dt in _HIST] + [
        ("final_gid", gids[None].expand(n_steps, B), np.int32)]
    for _, t, dt in fields:
        t = t.to(getattr(torch, np.dtype(dt).name) if dt is not np.bool_ else torch.uint8)
        if t.dim() == 2:
            t = t[..., None]
        t = t.contiguous().view(torch.uint8).reshape(n_steps, B, -1)
        parts.append(t)
        widths.append(t.shape[-1])
    buf = torch.cat(parts, dim=-1).cpu().numpy()
    out, o = {}, 0
    for (name, _, dt), w in zip(fields, widths):
        raw = np.ascontiguousarray(buf[..., o:o + w])
        o += w
        if dt is np.bool_:
            out[name] = raw.astype(bool)
        else:
            out[name] = raw.view(dt)
        if name not in ("covered", "sever"):
            out[name] = out[name].reshape(n_steps, B)
    final = out.pop("final_gid")[-1].astype(np.int64)
    return out, final


@torch.no_grad()
def rollout_autoreset(
    net,
    pool_g,
    pool_s0: EnvState,
    gids: torch.Tensor,
    g,
    state: EnvState,
    generator: torch.Generator,
    eps: float,
    gid_lo: int = 0,
    gid_hi: Optional[int] = None,
    n_steps: int = 8,
    variant: str = "unit_cost",
    degree_cost: bool = False,
    ce_prune: bool = False,
    hca_bridge: bool = False,
    hca_beta: float = 0.5,
    hca_tau: float = 0.5,
):
    """n_steps eps-greedy env steps over the env vector, with auto-reset on
    the device (the JAX package's rollout_autoreset): an env that goes
    terminal draws a fresh pool graph, uniform in [gid_lo, gid_hi), and its
    precomputed t=0 state (pool_s0), so every step of every env is
    experience and the host never drives resets.

    One exploration draw a step decides for the whole vector (reference
    Run_simulator :200-208): greedy if u >= eps, else each env's uniform
    valid action.  Every draw of the chunk (1 + 2B uniforms a step) comes
    from `generator`, a torch.Generator on the CPU, in one block before the
    loop and one copy to the device: the loop body has no host sync.  The
    JAX package's lax.scan is the Python loop.

    ce_prune: CE's action pruning, Q pruned to the boundary
    (env/env.prune_q_to_boundary) before the greedy argmax and random
    draws boundary-first.  hca_bridge: every step's reward gains hca_beta ×
    env/env.hca_bridge_bonus(tau = hca_tau) of the pre-step state.

    Returns ((gids, g, state) carry, history dict of [n_steps, B, ...]
    device tensors: gid, actions, rewards, covered, sever (bit-packed as
    _pack_bits_u8), valid, done); fetch_history brings it to the host."""
    if gid_hi is None:
        gid_hi = pool_g.node_mask.shape[0]
    B = gids.shape[0]
    draws = torch.rand((n_steps, 1 + 2 * B), generator=generator,
                       dtype=torch.float64).to(g.device)
    span = gid_hi - gid_lo
    hist: Dict[str, List[torch.Tensor]] = {k: [] for k, _ in _HIST}
    for s in range(n_steps):
        d = draws[s]
        q = predict_q(net, g, state.covered, state.sever, variant)
        if ce_prune:
            q = prune_q_to_boundary(q, g.boundary)
        greedy = torch.argmax(q, dim=1)
        rand = random_action(g, state, d[1:1 + B], boundary_first=ce_prune)
        actions = torch.where(d[0] >= eps, greedy, rand)
        valid = ~state.terminal  # False only for an s0-terminal fresh graph
        new_state, rewards = batched_step(g, state, actions, degree_cost)
        if hca_bridge:
            rewards = rewards + hca_beta * hca_bridge_bonus(g, state, actions, hca_tau)
        done = new_state.terminal
        for k, v in (("gid", gids), ("actions", actions), ("rewards", rewards),
                     ("covered", new_state.covered),
                     ("sever", _pack_bits_u8(new_state.sever.reshape(B, -1))),
                     ("valid", valid), ("done", done)):
            hist[k].append(v)
        new_gids = gid_lo + torch.clamp((d[1 + B:] * span).to(torch.int64), max=span - 1)
        gids = torch.where(done, new_gids, gids)
        g = pool_g.map(lambda x: x[gids])

        def pick(s0, cur):
            return torch.where(done.reshape((-1,) + (1,) * (cur.dim() - 1)), s0[gids], cur)

        state = EnvState(**{f.name: pick(getattr(pool_s0, f.name), getattr(new_state, f.name))
                            for f in dataclasses.fields(EnvState)})
    return (gids, g, state), {k: torch.stack(v) for k, v in hist.items()}


@torch.no_grad()
def greedy_rollout(net, g, state: EnvState, variant: str = "unit_cost",
                   degree_cost: bool = False, max_steps: int = 0,
                   ce_prune: bool = False) -> EnvState:
    """Roll every env of the batch to terminal with greedy argmax actions
    (the lowest index among equal maxima, as jnp.argmax), Q pruned to the
    boundary first with ce_prune; a Python loop in place of the JAX
    package's lax.while_loop, one host sync a step."""
    max_steps = max_steps or g.pad_n
    for _ in range(max_steps):
        if bool(state.terminal.all()):
            break
        q = predict_q(net, g, state.covered, state.sever, variant)
        if ce_prune:
            q = prune_q_to_boundary(q, g.boundary)
        state, _ = batched_step(g, state, torch.argmax(q, dim=1), degree_cost)
    return state


def make_valid_pool(cfg: Config, device=None) -> GraphPool:
    """The validation pool of cfg: n_valid GMM graphs drawn from
    np.random.default_rng(cfg.seed), as DQNAgent seeds and draws it
    (DQNAgent.__init__ then prepare_valid_data), with the variant's prior
    (prior_feature), on `device`."""
    if cfg.variant not in VARIANTS:
        raise ValueError(f"unknown variant {cfg.variant!r}")
    device = resolve_device(device)
    pool = GraphPool()
    for g in generate_pool(
        np.random.default_rng(cfg.seed), cfg.n_valid, cfg.num_min, cfg.num_max,
        cfg.pad_nodes, cfg.pad_edges, cfg.variant == "degree_cost",
        prior_feature(cfg), g_corr=cfg.gmm_g, device=device,
    ):
        pool.insert(g)
    return pool


def validation_score(net, g, variant: str = "unit_cost", degree_cost: bool = False,
                     ce_prune: bool = False, return_extras: bool = False, mesh=None):
    """Mean normalised dismantling cost over a batch of graphs: a batched
    greedy rollout (CE's pruning with ce_prune), score +
    remaining/(max_rank·N) per graph (reference Test :738-755; the JAX
    package's DQNAgent.validate), at the matmul precision the caller set.
    With return_extras, (mean, lmcc_final, audc): per graph the final rank
    over max_rank and the mean of its normalised-LMCC curve, score·N /
    max(removals, 1) (reference Test(return_lmcc=True) :913-951), as
    numpy f32 arrays.

    mesh (dp replicas): where the graphs split evenly over the replicas
    (the JAX agent's rule), each replica rolls out its own share and the
    per-graph results are gathered in graph order, so every replica gets
    the whole pool's mean; else each rolls out every graph."""
    shard = mesh is not None and g.node_mask.shape[0] % mesh.dp == 0
    if shard:
        b = g.node_mask.shape[0] // mesh.dp
        g = g.map(lambda x: x[mesh.dp_rank * b:(mesh.dp_rank + 1) * b])
    state = greedy_rollout(net, g, batched_reset(g), variant, degree_cost=degree_cost,
                           ce_prune=ce_prune)
    covered_cnt = torch.sum(state.covered & g.node_mask, dim=1)
    remain = (g.n_nodes - covered_cnt).to(torch.float32)
    n_f = g.n_nodes.to(torch.float32)
    max_rank = g.max_rank.to(torch.float32)
    score = state.score + remain / (max_rank * n_f)
    lmcc_final = state.rank.to(torch.float32) / max_rank
    audc = state.score * n_f / torch.clamp(covered_cnt.to(torch.float32), min=1.0)
    if shard:
        score, lmcc_final, audc = (all_gather_rows(mesh, x, "dp")
                                   for x in (score, lmcc_final, audc))
    if not return_extras:
        return float(torch.mean(score))
    return float(torch.mean(score)), lmcc_final.cpu().numpy(), audc.cpu().numpy()


def validate(net, pool: GraphPool, variant: str = "unit_cost", ce_prune: bool = False,
             return_extras: bool = False):
    """validation_score over the pool, in true f32 (TF32 off)."""
    set_precise_matmul()
    return validation_score(net, pool.stacked, variant, variant == "degree_cost",
                            ce_prune, return_extras)


# ---------------------------------------------------------------------------
# the agent
# ---------------------------------------------------------------------------


class DQNAgent:
    """The small-graph DQN trainer on one device (CUDA unless `device` names
    another), for every variant (unit_cost, degree_cost, ce, hca) and, for
    the base net, every fusion mode of models/fusion.FUSION_INITS
    (cfg.fusion; HCA fuses with BitwiseMultipyLogis whatever it says, as
    in the JAX package).  CE prunes its actions to the boundary in play
    (cfg.action_pruning_train) and validation (cfg.action_pruning_test);
    HCA adds the bridge bonus to its rewards (cfg.hca_bridge_effective).
    cfg.dtype == "bfloat16" runs the dense layers (and the dense
    aggregation, a matmul) under utils/device.matmul_precision(False),
    which on the card is TF32 (10-bit mantissas, f32 sums) for f32 tensors;
    "float32" runs them in true f32.  cfg.debug_nans turns on
    torch.autograd.set_detect_anomaly, process-wide.

    mesh (parallel/mesh.make_mesh(dp=...) after init_distributed; gp = 1):
    data-parallel replicas, one process each, as the JAX agent's mesh=.
    Every replica runs the same play and samples the same replay batches
    from the same seed; fit runs train_step on the replica's batch_size/dp
    rows of each batch and sums the gradients, so every replica takes the
    global batch's step and the parameters stay bit-identical; validate
    splits the pool over the replicas where it divides.  Only the first
    replica writes files (save, the VC file).  The device is the mesh's
    unless `device` names one."""

    def __init__(self, cfg: Config, seed: Optional[int] = None, device=None, mesh=None):
        if cfg.variant not in VARIANTS:
            raise ValueError(f"unknown variant {cfg.variant!r}")
        if mesh is not None and (mesh.gp != 1 or cfg.batch_size % mesh.dp):
            raise ValueError(f"the agent's mesh shards the batch over dp: gp must be 1 and "
                             f"batch_size={cfg.batch_size} divisible by dp={mesh.dp}")
        self.cfg = cfg
        self.mesh = mesh
        self.primary = mesh is None or (mesh.dp_rank == 0 and mesh.rank == 0)
        self.device = resolve_device(mesh.home if mesh is not None and device is None
                                     else device)
        if cfg.debug_nans:
            torch.autograd.set_detect_anomaly(True)
        self.precise = cfg.dtype != "bfloat16"
        seed = cfg.seed if seed is None else seed
        self.nprng = np.random.default_rng(seed)
        self.generator = torch.Generator().manual_seed(seed)
        size = dict(embedding_size=cfg.embedding_size, reg_hidden=cfg.reg_hidden,
                    aux_dim=cfg.aux_dim, gate_hidden=cfg.gate_hidden,
                    w_init_std=cfg.w_init_std)
        if cfg.variant == "hca":
            from mdcommunity_tpu_torch.models.hca import init_hca_params

            params = init_hca_params(self.generator, **size)
        else:
            params = init_params(self.generator, node_feat_dim=cfg.node_feat_dim,
                                 fusion=cfg.fusion, **size)
        self.net = from_jax_params(params, self.device).requires_grad_(True)
        self.target_net = copy.deepcopy(self.net).requires_grad_(False)
        self.optimizer = torch.optim.Adam(self.net.parameters(), lr=cfg.learning_rate,
                                          betas=(0.9, 0.999), eps=1e-8)
        if cfg.use_prioritized:
            from mdcommunity_tpu_torch.rl.replay_prioritized import PrioritizedNStepReplay

            self.replay = PrioritizedNStepReplay(
                cfg.memory_size, cfg.pad_nodes, cfg.pad_edges, cfg.n_step)
        else:
            from mdcommunity_tpu_torch.rl.replay import NStepReplay

            self.replay = NStepReplay(cfg.memory_size, cfg.pad_nodes, cfg.pad_edges,
                                      cfg.n_step)
        self.train_pool = EpochGraphRing(cfg.pool_ring_epochs)
        self.valid_pool = GraphPool()
        self.iteration = 0
        self._env_state: Optional[EnvState] = None
        self._env_gids: Optional[np.ndarray] = None
        self._env_graphs = None
        self._traj: List[dict] = []
        self._pending_prio = None  # deferred (tree_idx, td on the device, write_gen)

    # -- data ----------------------------------------------------------------
    @property
    def degree_cost(self) -> bool:
        return self.cfg.variant == "degree_cost"

    def _prec(self):
        return matmul_precision(self.precise)

    def _pool(self, count: int) -> List:
        c = self.cfg
        return generate_pool(self.nprng, count, c.num_min, c.num_max, c.pad_nodes,
                             c.pad_edges, self.degree_cost, prior_feature(c),
                             g_corr=c.gmm_g, device=self.device)

    def gen_new_graphs(self):
        """Refresh the training pool (reference gen_new_graphs :151-160) as a
        new EpochGraphRing epoch: earlier epochs' graphs stay on the device,
        so replayed transitions keep referring to their graphs."""
        self.train_pool.write_epoch(self._pool(self.cfg.n_train))
        # envs hold ids into the old pool; force a re-reset
        self._env_state = None

    def prepare_valid_data(self):
        self.valid_pool.clear()
        for g in self._pool(self.cfg.n_valid):
            self.valid_pool.insert(g)

    # -- rollouts -------------------------------------------------------------
    def _new_traj(self, gid: int) -> dict:
        return {"gid": gid, "covered": [np.zeros(self.cfg.pad_nodes, bool)],
                "sever": [self.train_pool.s0_sever_host[gid]], "actions": [],
                "rewards": []}

    def _reset_envs(self):
        """Full env-vector reset (pool changed, or the first call);
        mid-training resets happen on the device in rollout_autoreset."""
        self._env_gids = self.train_pool.sample_slots(self.nprng, self.cfg.num_env)
        gids = torch.as_tensor(self._env_gids, device=self.device)
        self._env_graphs = index_graphs(self.train_pool.stacked, gids)
        self._env_state = self.train_pool.stacked_s0.map(lambda x: x[gids])
        self._traj = [self._new_traj(int(gid)) for gid in self._env_gids]

    def play_games(self, n_traj: int, eps: float):
        """Collect >= n_traj finished episodes into the replay (reference
        Run_simulator).  Each turn is one rollout chunk over every env and
        one transfer of its history; episodes beyond n_traj that finish in
        the same chunk are kept."""
        if len(self.train_pool) == 0:
            self.gen_new_graphs()
        if self._env_state is None:
            self._reset_envs()
        c = self.cfg
        ce_prune = c.variant == "ce" and c.action_pruning_train
        hca_bridge = c.variant == "hca" and c.hca_bridge_effective
        pool = self.train_pool
        done, guard = 0, 0
        with self._prec():
            while done < n_traj and guard < 10000:
                guard += 1
                (gids, g, state), hist = rollout_autoreset(
                    self.net, pool.stacked, pool.stacked_s0,
                    torch.as_tensor(self._env_gids, device=self.device),
                    self._env_graphs, self._env_state, self.generator, eps,
                    gid_lo=pool.base, gid_hi=pool.base + pool.pool_size,
                    n_steps=c.rollout_chunk, variant=c.variant,
                    degree_cost=self.degree_cost, ce_prune=ce_prune,
                    hca_bridge=hca_bridge, hca_beta=c.hca_beta, hca_tau=c.hca_tau,
                )
                hist, self._env_gids = fetch_history(hist, gids)
                self._env_graphs, self._env_state = g, state
                done += self._record(hist)

    def _record(self, hist) -> int:
        """Slice the chunk's history into the env trajectories; flush each
        finished episode into the replay.  Returns the episodes flushed."""
        pad_e = self.cfg.pad_edges
        sever = np.unpackbits(hist["sever"], axis=-1, count=2 * pad_e)
        sever = sever.reshape(*sever.shape[:-1], 2, pad_e).astype(bool)
        n_steps, n_env = hist["actions"].shape
        done = 0
        for s in range(n_steps):
            for i in range(n_env):
                t = self._traj[i]
                if hist["valid"][s, i]:
                    t["actions"].append(int(hist["actions"][s, i]))
                    t["rewards"].append(float(hist["rewards"][s, i]))
                    t["covered"].append(hist["covered"][s, i])
                    t["sever"].append(sever[s, i])
                if hist["done"][s, i]:
                    if t["actions"]:
                        self.replay.add_episode(
                            t["gid"], t["covered"], t["sever"], t["actions"],
                            t["rewards"], graph_epoch=self.train_pool.epoch)
                        done += 1
                    # the device already reset env i; the next row's gid
                    # (or the final carry) names its graph
                    ngid = int(hist["gid"][s + 1, i] if s + 1 < n_steps
                               else self._env_gids[i])
                    self._traj[i] = self._new_traj(ngid)
        return done

    # -- fitting ---------------------------------------------------------------
    def take_snapshot(self):
        self.target_net.load_state_dict(self.net.state_dict())

    def sample_batch(self):
        """(replay batch, tree indices or None, IS weights or None, write
        generations or None), drawn from the agent's numpy generator."""
        if self.cfg.use_prioritized:
            pb = self.replay.sample_prioritized(
                self.nprng, self.cfg.batch_size, slots_live=self.train_pool.slots_live)
            return (pb.batch, pb.tree_idx, pb.is_weights,
                    self.replay.write_gen[pb.tree_idx].copy())
        batch = self.replay.sample(self.nprng, self.cfg.batch_size,
                                   slots_live=self.train_pool.slots_live)
        return batch, None, None, None

    def step_args(self, batch, is_weights=None) -> dict:
        """train_step's batch arguments on the agent's device."""
        dev = self.device

        def t(x):
            return torch.as_tensor(np.asarray(x), device=dev)

        return dict(
            g=index_graphs(self.train_pool.stacked,
                           t(batch.graph_ids.astype(np.int64))),
            covered_st=t(batch.covered_st), sever_st=t(batch.sever_st),
            actions=t(batch.actions.astype(np.int64)), rewards=t(batch.rewards),
            covered_sp=t(batch.covered_sp), sever_sp=t(batch.sever_sp),
            terminal=t(batch.terminal),
            is_weights=None if is_weights is None else t(is_weights),
        )

    def step_options(self) -> dict:
        c = self.cfg
        return dict(variant=c.variant, gamma=c.gamma, alpha_recon=c.alpha_recon,
                    use_double_dqn=c.use_double_dqn, use_huber=c.use_huber,
                    max_bp_iter=c.max_bp_iter)

    def fit(self) -> torch.Tensor:
        """One train_step on a replay batch; returns the loss as a device
        scalar, not synced (a host read would fence the queue every
        iteration)."""
        batch, tree_idx, iw, tree_gen = self.sample_batch()
        if self.mesh is not None:
            batch, iw = self._replica_rows(batch, iw)
        with self._prec():
            loss, _, _, td = train_step(self.net, self.target_net, self.optimizer,
                                        **self.step_args(batch, iw), **self.step_options(),
                                        mesh=self.mesh)
        if tree_idx is not None:
            # the previous fit's priorities, one step deferred: its td has
            # finished by now, so reading it does not wait; the write
            # generations skip slots the ring overwrote in between
            self._flush_priorities()
            self._pending_prio = (tree_idx, td, tree_gen)
        return loss

    def _replica_rows(self, batch, iw):
        """This replica's rows of a replay batch (and of its IS weights)."""
        b = self.cfg.batch_size // self.mesh.dp
        rows = slice(self.mesh.dp_rank * b, (self.mesh.dp_rank + 1) * b)
        return (dataclasses.replace(batch, **{f.name: getattr(batch, f.name)[rows]
                                              for f in dataclasses.fields(batch)}),
                None if iw is None else iw[rows])

    def _flush_priorities(self):
        if self._pending_prio is not None:
            p_idx, p_td, p_gen = self._pending_prio
            self.replay.update_priorities(p_idx, p_td.cpu().numpy(), write_gen=p_gen)
            self._pending_prio = None

    # -- evaluation ------------------------------------------------------------
    def validate(self, return_extras: bool = False):
        """Mean normalised dismantling cost over the validation pool
        (validation_score, CE pruned with cfg.action_pruning_test) at the
        agent's matmul precision; with return_extras also the per-graph
        lmcc_final and audc arrays (the JAX agent's validate)."""
        ce_prune = self.cfg.variant == "ce" and self.cfg.action_pruning_test
        with self._prec():
            return validation_score(self.net, self.valid_pool.stacked, self.cfg.variant,
                                    self.degree_cost, ce_prune, return_extras, self.mesh)

    def _ce_prior_diagnostics(self) -> str:
        """The CE-PRIOR line (reference :671-677; the JAX agent's): the mean
        boundary-node share and each layer's mean prior feature over the
        validation pool."""
        g = self.valid_pool.stacked
        nm = g.node_mask.cpu().numpy()
        n = np.maximum(nm.sum(1), 1)
        bratio = float(np.mean(g.boundary.cpu().numpy().sum(1) / n))
        feat = g.node_feat.cpu().numpy()  # [B, 2, N]
        f0 = float(np.mean(feat[:, 0].sum(1) / n))
        f1 = float(np.mean(feat[:, 1].sum(1) / n))
        return (f"CE-PRIOR feature={self.cfg.comm_prior_feature} "
                f"boundary_ratio_mean={bratio:.6f} feat_mean=[{f0:.6f},{f1:.6f}]")

    # -- persistence -----------------------------------------------------------
    def _state_dict(self) -> dict:
        """The full training state as numpy and Python values: params and
        target_params in the JAX package's layout (so its loaders and
        DQNAgent.load(weights_only=True) read them), and under the port's
        own keys the Adam moments by parameter name, the step count and the
        torch generator's state."""
        names = [k for k, _ in self.net.named_parameters()]
        st = self.optimizer.state_dict()["state"]
        step = int(st[0]["step"]) if st else 0
        return {
            "params": to_jax_params(self.net),
            "target_params": to_jax_params(self.target_net),
            "iteration": self.iteration,
            "nprng": self.nprng.bit_generator.state,
            "config": dataclasses.asdict(self.cfg),
            "adam_step": step,
            "adam_m": {n: st[i]["exp_avg"].cpu().numpy() for i, n in enumerate(names)}
            if st else {},
            "adam_v": {n: st[i]["exp_avg_sq"].cpu().numpy() for i, n in enumerate(names)}
            if st else {},
            "torch_rng": self.generator.get_state().numpy(),
        }

    def save(self, path: str):
        """Write the agent file (the first replica only, under a mesh)."""
        if self.primary:
            save_agent_state(path, self._state_dict())

    def load(self, path: str, weights_only: bool = False):
        """Restore an agent file: the port's (full state) or, with
        weights_only=True, also the JAX package's (params and target only)."""
        self._restore(load_agent_state(path), weights_only)

    def _restore(self, state: dict, weights_only: bool = False):
        for net, key in ((self.net, "params"), (self.target_net, "target_params")):
            net.load_state_dict(from_jax_params(state[key], "cpu").state_dict())
        if weights_only:
            return
        if "adam_step" not in state:
            raise ValueError("not a full agent state of the port (its Adam state "
                             "is missing); load it with weights_only=True")
        names = [k for k, _ in self.net.named_parameters()]
        opt = self.optimizer.state_dict()
        opt["state"] = {} if not state["adam_step"] else {
            i: {"step": torch.tensor(float(state["adam_step"])),
                "exp_avg": torch.from_numpy(state["adam_m"][n]),
                "exp_avg_sq": torch.from_numpy(state["adam_v"][n])}
            for i, n in enumerate(names)}
        self.optimizer.load_state_dict(opt)
        self.iteration = state["iteration"]
        self.nprng.bit_generator.state = state["nprng"]
        self.generator.set_state(torch.from_numpy(np.asarray(state["torch_rng"], np.uint8)))

    def load_torch(self, path: str):
        """Load a reference-format torch checkpoint (weights only)."""
        from mdcommunity_tpu_torch.models.torch_convert import load_torch_checkpoint

        src = load_torch_checkpoint(path, device="cpu")
        self.net.load_state_dict(src.state_dict())
        self.take_snapshot()

    # -- the training loop -------------------------------------------------------
    def train(self, save_dir: str = "./models_tpu", resume: bool = False,
              log=print, stats: Optional[dict] = None) -> str:
        """The reference's Train() schedule: pools, warm-up games at eps = 1,
        then each iteration a pool regeneration every save_frequency, ten
        episodes of play every 10, validation and checkpoints every
        save_frequency, a target snapshot every update_time, and one fit.
        stats, when given, receives the seconds of the pools (pools_s), the
        warm-up (warmup_s), all play and all fits (play_s, fit_s, each
        synchronised with the card), the fits' count (fit_iters), and each
        validation's seconds and VC (valid_s, vcs)."""
        cfg = self.cfg
        st = {} if stats is None else stats
        st.update(warmup_s=0.0, play_s=0.0, fit_s=0.0, fit_iters=0, valid_s=[], vcs=[])
        os.makedirs(save_dir, exist_ok=True)
        vc_file = os.path.join(save_dir, f"ModelVC_{cfg.num_min}_{cfg.num_max}.csv")

        start_iter = 0
        if resume and os.path.isfile(os.path.join(save_dir, "latest.ckpt")):
            self.load(os.path.join(save_dir, "latest.ckpt"))
            start_iter = self.iteration
            log(f"resumed from iter {start_iter}")
            vc_out = open(vc_file if self.primary else os.devnull, "a")
        else:
            vc_out = open(vc_file if self.primary else os.devnull, "w")

        t0 = time.perf_counter()
        self.prepare_valid_data()
        self.gen_new_graphs()
        st["pools_s"] = time.perf_counter() - t0
        with device_timer("warmup_s", sink=st):
            for _ in range(cfg.warmup_games):
                self.play_games(cfg.warmup_traj, 1.0)
        self.take_snapshot()

        best = float("inf")
        t_window = time.perf_counter()
        # per-window device-fenced timing and throughput counters
        # (reference observability: wall-clock prints :497,510-523)
        prof: dict = {}
        fit_meter = ThroughputMeter()
        try:
            for it in range(start_iter, cfg.max_iteration):
                self.iteration = it
                if it and it % cfg.save_frequency == 0:
                    self.gen_new_graphs()
                eps = cfg.eps_end + max(
                    0.0, (cfg.eps_start - cfg.eps_end) * (cfg.eps_step - it) / cfg.eps_step)
                if it % 10 == 0:
                    with device_timer("play", sink=prof), device_timer("play_s", sink=st):
                        self.play_games(10, eps)
                if it % cfg.save_frequency == 0:
                    t0 = time.time()
                    if cfg.variant == "ce":
                        frac, lmcc_final, audc = self.validate(return_extras=True)
                    else:
                        frac = self.validate()
                    st["valid_s"].append(time.time() - t0)
                    st["vcs"].append(frac)
                    if frac < best:
                        best = frac
                        self.save(os.path.join(save_dir, "best_model.ckpt"))
                    vc_out.write(f"{frac:.16f}\n")
                    vc_out.flush()
                    fit_meter.add(cfg.save_frequency if it else 0, prof.pop("fit", 0.0))
                    log(
                        f"iter {it}, eps {eps:.4f}, mean vc {frac:.6f} "
                        f"(valid {time.time()-t0:.1f}s, window "
                        f"{time.perf_counter()-t_window:.1f}s, "
                        f"play {prof.pop('play', 0.0):.1f}s, "
                        f"fit {fit_meter.rate:.1f} it/s)"
                    )
                    if cfg.variant == "ce":
                        # the reference's LMCC-DEBUG and CE-PRIOR lines (:636-677)
                        log("LMCC-DEBUG "
                            f"mean_final={float(np.mean(lmcc_final)):.6f} "
                            f"var_final={float(np.var(lmcc_final)):.6f} "
                            f"mean_audc={float(np.mean(audc)):.6f} "
                            f"var_audc={float(np.var(audc)):.6f}")
                        log(self._ce_prior_diagnostics())
                    t_window = time.perf_counter()
                    self.save(os.path.join(save_dir, "latest.ckpt"))
                    self.save(os.path.join(
                        save_dir, f"nrange_{cfg.num_min}_{cfg.num_max}_iter_{it}.ckpt"))
                if it % cfg.update_time == 0:
                    self.take_snapshot()
                with device_timer("fit", sink=prof), device_timer("fit_s", sink=st):
                    self.fit()
                st["fit_iters"] += 1
        finally:
            # the last fit's deferred priority update
            self._flush_priorities()
            self.iteration = cfg.max_iteration
            self.save(os.path.join(save_dir, "latest.ckpt"))
            vc_out.close()
        return save_dir


def find_model(save_dir: str, num_min: int = 30, num_max: int = 50,
               save_frequency: int = 1000, burn_in: int = 33) -> str:
    """The checkpoint at the argmin of the validation-cost curve after a
    burn-in (reference findModel :551-560; its 500-iteration spacing is
    save_frequency here).  Falls back to burn_in=0 for short runs."""
    vc_file = os.path.join(save_dir, f"ModelVC_{num_min}_{num_max}.csv")
    vc = [float(line) for line in open(vc_file)]
    if len(vc) <= burn_in:
        burn_in = 0
    best_row = burn_in + int(np.argmin(np.asarray(vc[burn_in:])))
    it = best_row * save_frequency
    return os.path.join(save_dir, f"nrange_{num_min}_{num_max}_iter_{it}.ckpt")
