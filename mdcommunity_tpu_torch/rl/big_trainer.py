"""DQN training on one large banded duplex (10^6 nodes): unit cost, degree
cost and CE.

The reference's Train() loop (MultiDismantler_torch.py:433-547: rollout,
transitions, fit, target snapshot) at the scale of the large-graph eval, as
the JAX package's rl/big_trainer.py runs it: the unit of interaction is a
StepRatio macro-step.  The policy ranks all nodes, the top k (eps-mixed) are
removed together, and one cascade advances the environment: on the band's
card when the env is the native one (the loop calls env.to(device);
env/device_cascade.py), else on the host.

* A transition is (s_t, A_t, r_t, s_{t+1}): A_t the k actions of the
  macro-step, r_t(a) = -norm_post·cost(a) per action (step_many's score
  contract): cost(a) = 1/n, or for degree cost 0.5·(w0[a]/Σw0 + w1[a]/Σw1)
  from the build's band-order weights.
* The TD target of every a in A_t is r_t(a) + gamma·max_a' Q_target(s_{t+1},
  a'), or r_t(a) at terminal.
* The replay buffer is the episode stream: each macro-step is one fit batch
  of k state-action pairs on the pre-step state s_t.
* Target-network snapshots every `target_update` iterations; eps-greedy
  exploration per slot over the valid actions.

Selection and targets run the eval forward (kernels K1 and K2); the fit
runs models/net.banded_train_loss, whose gradient is K1 with swapped scales.
precise=False is the bf16 fit: the fast forward (K1's and K2's bf16 modes)
selects and bootstraps, the loss aggregates through K1's bf16 mode both
ways, and the dense layers run under utils/device.matmul_precision(False).

The JAX package's operands are values, so its pre-step state is still at
hand when it fits after applying the next state's severs.  Here severs edit
the band in place, so the loop keeps two operand sets, `cur` and `prev`,
equal at every episode reset: it selects on cur, severs cur, runs the
target forward on cur, fits on prev, then severs prev the same way.  The
covered mask of s_{t+1} is a new tensor.

With a gp mesh (parallel/mesh.py) the loop runs gp-sharded, as the JAX
package's train_banded_loop(mesh=...): the operand sets are
ShardedBandedDuplexes, selection and targets run the unfused forward through
the sharded band operator (kernel K3) with a global top-k of the gathered
Q, and the fit differentiates through ShardedBandSpmm.  The mesh may span
processes (parallel/mesh.init_distributed): every process then runs the
same cascade from the same seed (on its own card, or the host), as every
JAX process runs the same host code, selects from the same gathered Q, fits its own shards' part of
the loss, and sums the gradients with the others before the Adam step, so
the parameters stay bit-identical on every process.
"""

from __future__ import annotations

import copy
import time
from typing import List

import numpy as np
import torch

from mdcommunity_tpu_torch.eval.metrics import top_k_stable
from mdcommunity_tpu_torch.graphs.banded import (
    BandedDuplex,
    apply_severs,
    fork_banded,
    restore_banded,
    shard_banded_duplex,
)
from mdcommunity_tpu_torch.models.net import (
    DuplexQNet,
    banded_test_forward,
    banded_train_loss,
)
from mdcommunity_tpu_torch.parallel.mesh import all_reduce, reduce_grads
from mdcommunity_tpu_torch.utils.device import matmul_precision
from mdcommunity_tpu_torch.utils.profiling import span


def _apply_severs(banded, layer: int, ns: np.ndarray) -> None:
    """Sever the undirected edges `ns` [K, 2] of one layer, in place.  The
    counterpart of the JAX package's _apply_severs_chunked: the port matches
    mirror and spill edges by sorted keys, not by a [E_ov, K] comparison, so
    a cascade report of any size is one call.  banded may be sharded."""
    if len(ns):
        e = torch.from_numpy(np.asarray(ns, np.int64)).to(banded.device)
        ok = torch.ones(len(e), dtype=torch.bool, device=banded.device)
        apply_severs(banded, layer, e[:, 0], e[:, 1], ok)


def sync_env_severs(banded, env):
    """Replay the env's current persistent sever masks into the band (at
    episode start: the t=0 cascade usually severs some edges)."""
    for layer in range(2):
        _apply_severs(banded, layer, env.edges[layer][env.sever[layer]])
    return banded


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_banded_loop(
    net: DuplexQNet,
    banded0: BandedDuplex,
    env,
    *,
    iters: int = 600,
    k: int = 1024,
    variant: str = "unit_cost",
    lr: float = 1e-4,
    gamma: float = 1.0,
    alpha_recon: float = 1e-3,
    eps_start: float = 0.1,
    eps_end: float = 0.02,
    target_update: int = 100,
    fits_per_step: int = 1,
    stop_rank_sqrt: bool = True,
    packed: bool = True,
    precise: bool = True,
    mesh=None,
    seed: int = 0,
    log=print,
    log_every: int = 25,
    on_iter=None,
):
    """Train a copy of `net` by dismantling the single large duplex `env`
    holds; returns (trained net, history).

    banded0: the pristine BandedDuplex in the env's (band) node order, on
    the device the loop runs on; it is never edited (episode resets copy
    it).  history: one row per iteration (the JAX package's keys, plus the
    iteration's time split, host seconds of utils/profiling.span: t_iter_s
    holding t_select_s (t_mix_s inside it: the eps draw to the
    de-duplication), t_env_s, t_sever_s, t_target_s, t_fit_s; and the
    iteration's cascade counters, env.cascade_stats), one row per finished
    episode (AUDC) and a closing row.

    packed=True runs the eval forward with fused SAGE steps (kernel K2)
    when the build is spill-free.  Adam is torch.optim.Adam with optax.adam's
    defaults (betas 0.9/0.999, eps 1e-8; the same bias-corrected update).
    Eps mixing draws from np.random.default_rng(seed) in the JAX package's
    order.  Unlike the JAX package, the batch is de-duplicated after the
    mix (first occurrences kept): a mixed slot the pool could not refill
    may repeat a replacement, and the env removes it once.

    stop_rank_sqrt: end the episode once rank <= sqrt(N), the reference's
    synthetic stopping rule (the JAX package's naive 2^20 run spent most of
    its iterations past the rank collapse, where targets are pure bootstrap).
    on_iter, when given, is called with each iteration's history row as the
    iteration ends (profile_forward --fit steps its profiler with it).

    mesh (parallel/mesh.GpMesh): run gp-sharded.  The caller passes the
    unsharded pristine build, on the first shard's device, and the loop
    shards it (views on a device the shards share); a build with spill
    edges, or whose block count the shards do not divide, raises
    ValueError.  Selection and targets then run the unfused forward (the
    fused step is single-device), precise as asked; actions and targets
    stay on the first shard's device; the env's cascade runs on that
    device too, and its severs are routed to the shards that own them.  On a mesh that spans
    processes every process calls the loop with the same arguments (its
    own env, made alike) and returns the same net; the history's loss is
    the whole loss.

    precise=False: the bf16 fit (module doc; the JAX package's
    train_banded_loop(precise=False)); with a mesh its gradient is K3's
    bf16 mode with swapped scales.  The dense layers' TF32 flags are set
    for each forward and fit and restored after it.  The JAX package's
    pack_G (a TPU layout) is not ported.

    variant "degree_cost" or "ce" selects, bootstraps and fits with that
    variant's input columns (banded_test_forward and banded_train_loss
    with variant=; the JAX package's train_banded_loop(variant=)): banded0
    carries them (BandedDuplex.weights, node_feat, in band order).  For
    degree cost the reward factor is 0.5·(w0/Σw0 + w1/Σw1) of
    banded0.weights[:, :n], and the env, which must hold the same
    band-order weights, scores with step_many(degree_cost=True).  The JAX
    package has no banded HCA trainer: "hca" raises ValueError."""
    if variant == "hca":
        raise ValueError("the JAX package has no banded HCA trainer (train_banded_loop "
                         "runs unit_cost, degree_cost and ce): train HCA with the "
                         "small-graph DQNAgent")
    if variant not in ("unit_cost", "degree_cost", "ce"):
        raise ValueError(f"unknown variant {variant!r}")
    n = env.n
    # per-action reward factors (step_many's score contract), as the JAX
    # package forms them: f32 weights in band order, numpy sums
    if variant == "degree_cost":
        w = banded0.weights.cpu().numpy()[:, :n]
        cost = 0.5 * (w[0] / max(w[0].sum(), 1e-9) + w[1] / max(w[1].sum(), 1e-9))
    else:
        cost = np.full(n, 1.0 / n)
    if mesh is not None:
        banded0 = shard_banded_duplex(mesh, banded0)
    device = banded0.device
    env.to(device)
    rng = np.random.default_rng(seed)
    pad_n = banded0.pad_n
    fuse = packed and banded0.spill_free and mesh is None

    net = copy.deepcopy(net).to(device).requires_grad_(True)
    target = copy.deepcopy(net).requires_grad_(False)
    opt = torch.optim.Adam(net.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    cur, prev = fork_banded(banded0), fork_banded(banded0)

    def reset_episode() -> torch.Tensor:
        env.reset()
        for b in (cur, prev):
            sync_env_severs(restore_banded(b, banded0), env)
        return torch.from_numpy(
            np.pad(env.covered, (0, pad_n - n), constant_values=True)
        ).to(device)

    covered = reset_episode()
    history: List[dict] = []
    episode = 0
    t_loop = time.perf_counter()

    for it in range(iters):
        eps = eps_start + (eps_end - eps_start) * it / max(iters - 1, 1)
        row = {"iter": it, "episode": episode, "eps": round(float(eps), 4)}
        with span(row, "t_iter_s"):
            # --- action selection: device top-k, host eps mixing --------
            with span(row, "t_select_s"):
                with matmul_precision(precise):
                    q = banded_test_forward(net, cur, covered, fuse_sage=fuse,
                                            precise=precise, variant=variant)
                vals, order = top_k_stable(q, k)
                ok = np.isfinite(vals) & ~env.covered[order]
                cut = int(np.argmin(ok)) if not ok.all() else len(ok)
                acts = order[:cut].astype(np.int64)
                if len(acts) == 0:
                    # no live action (the forward masks dead nodes to -inf)
                    covered = reset_episode()
                    episode += 1
                    continue
                with span(row, "t_mix_s"):
                    mix = rng.random(len(acts)) < eps
                    if mix.any():
                        valid = env.alive_nodes(0) & env.alive_nodes(1) & ~env.covered
                        valid[acts[~mix]] = False
                        pool = np.flatnonzero(valid)
                        n_mix = min(int(mix.sum()), len(pool))
                        if n_mix:
                            repl = rng.choice(pool, size=n_mix, replace=False)
                            acts[np.flatnonzero(mix)[:n_mix]] = repl
                        _, first = np.unique(acts, return_index=True)
                        acts = acts[np.sort(first)]

            # --- env macro-step (one cascade), rewards -------------------
            with span(row, "t_env_s"):
                _, new_sev, removed = env.step_many(
                    acts, degree_cost=variant == "degree_cost")
                norm = env.rank / max(env.max_rank, 1)
                rewards = -norm * cost[acts]
            if removed:
                row.update(env.cascade_stats)

            # --- next state on the device: a new covered mask, cur severed
            with span(row, "t_sever_s"):
                acts_dev = torch.from_numpy(acts).to(device)
                prev_covered = covered
                covered = covered.clone()
                covered[acts_dev] = True
                for layer in range(2):
                    _apply_severs(cur, layer, new_sev[layer])
                _sync(device)

            # --- TD targets ----------------------------------------------
            with span(row, "t_target_s"):
                if env.terminal:
                    targets = rewards
                    maxq = 0.0
                else:
                    with matmul_precision(precise):
                        q_next = banded_test_forward(target, cur, covered, fuse_sage=fuse,
                                                     precise=precise, variant=variant)
                    maxq = float(q_next.max())
                    targets = rewards + gamma * maxq

            # --- fit on the pre-step state s_t (prev), then sever prev ---
            with span(row, "t_fit_s"):
                loss_v = float("nan")
                if len(acts) == k:  # the JAX package skips the short terminal batch
                    tgts_dev = torch.from_numpy(targets.astype(np.float32)).to(device)
                    for _ in range(fits_per_step):
                        opt.zero_grad(set_to_none=True)
                        with matmul_precision(precise):
                            loss = banded_train_loss(net, prev, prev_covered, acts_dev,
                                                     tgts_dev, alpha=alpha_recon,
                                                     precise=precise, variant=variant)
                            loss.backward()
                        if mesh is not None:
                            reduce_grads(mesh, net.parameters())
                        opt.step()
                    loss_v = (all_reduce(mesh, loss.detach()) if mesh is not None
                              else loss).item()
            with span(row, "t_sever_s"):
                for layer in range(2):
                    _apply_severs(prev, layer, new_sev[layer])
                _sync(device)

            if (it + 1) % target_update == 0:
                target.load_state_dict(net.state_dict())

        row.update(removed=int(removed), norm=round(float(norm), 6),
                   maxq=round(float(maxq), 6), loss=loss_v)
        history.append(row)
        if on_iter is not None:
            on_iter(row)
        if it % log_every == 0 or env.terminal:
            log(f"[big] it {it} ep {episode} eps {eps:.3f} "
                f"norm {norm:.4f} loss {loss_v:.3e} maxq {maxq:.4f} "
                f"t {row['t_iter_s']:.2f}s")

        ep_done = env.terminal or (stop_rank_sqrt and env.rank * env.rank <= n)
        if ep_done:
            history.append({
                "episode_end": episode, "audc": float(env.score),
                "removals": int(env.t), "iters_used": it + 1,
                "terminal": bool(env.terminal), "rank": int(env.rank),
            })
            log(f"[big] episode {episode} done (terminal={env.terminal}, "
                f"rank={env.rank}): AUDC {env.score:.6f} "
                f"({env.t} removals)")
            covered = reset_episode()
            episode += 1

    history.append({
        "total_wall_s": round(time.perf_counter() - t_loop, 1),
        "iters": iters, "episodes": episode + 1,
    })
    return net, history
