"""Multi-process smoke of the port: the gp engine and the dp agent across
OS processes through torch.distributed (the counterpart of the JAX
package's scripts/multihost_smoke.py).

The parent spawns N_PROC child processes (config["processes"] where set),
each with a timeout, on a free port; every child calls
parallel/mesh.init_distributed and runs the configured phases, each
against the same work done inside the one process (a mesh with
processes=1), and raises where they differ:

  mesh      the transport on a dp × gp layout (cfg["dp"] replicas, the gp
            shards split over the processes of each) against one process;
  dp_step   one data-parallel train step (dp = 2, each process its half of
            an 8-graph batch) against the single-process step: the same
            loss, the same parameters after it;
  gp        gp = 4 shards, 2 a process, so every halo and mirror gather
            crosses the process boundary: spmm_band_sharded's forward and
            VJP, banded_test_forward's Q and banded_train_loss's value and
            gradients against the one-process gp = 4 calls (and the
            operator against K1 on the whole graph), the gradients of the
            cross-process and the one-process loss against a float64
            referee on the CPU;
  trainer   rl/big_trainer.train_banded_loop(mesh=) against the
            one-process sharded loop: the same removals, parameters
            bit-equal across the processes;
  dp_agent  DQNAgent(mesh=dp 2) fits against the single-process agent's
            with the same seed (or, given a saved agent state, from it);
  validate  DQNAgent.validate under dp against the single-process score;
  partition parallel/partition.spmm_edge_partitioned at gp = 4 across the
            processes against the one process, value and gradients;
  timing    the cross-process sharded model call and its halo exchange
            beside the one-process call (on a card: transport through the
            host under gloo).

Each child writes rank<k>.json (numbers) and rank<k>.npz (arrays) into the
output directory, and the parent checks that the processes agree.  With
--backend nccl every process needs a card of its own; two processes that
share one card use gloo, which the helpers feed through the host.

Usage (from the root of a checkout):
  python -m mdcommunity_tpu_torch.multihost_smoke [--device cpu|cuda] [--backend gloo|nccl]
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import functools
import hashlib
import importlib.util
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_PROC = 2
GP = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "models_tpu", "unit_cost_full_r1", "best_model.ckpt")
RULES = os.path.join(REPO, "tests", "gradient_rules.py")
# the CLI's run: the JAX smoke's two phases at its sizes
# (tolerances are of max|ref|: shard_tol the cross-process calls against the
# one-process ones, k1_tol the operator against K1 on the whole graph, where
# the CPU's einsums may sum a block in another order, unsharded_tol Q against
# the unsharded forward: 0 precise, since every node-row product runs over
# utils/device.row_matmul's fixed row chunks; TF32's rounding fast)
SMALL = dict(phases=["dp_step", "gp"], graph=dict(kind="ring", n=4096), precise=[True],
             actions=8, shard_tol=0.0, k1_tol=2.0 ** -7,
             unsharded_tol=dict(precise=0.0, fast=1e-2))


def free_port() -> int:
    """A TCP port that was free a moment ago (bind to port 0)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(device: str = "cpu", backend: str = "gloo", config=None, out_dir=None,
        timeout: float = 600.0):
    """Spawn the children on `config` (SMALL by default), wait for them
    (killing every child once one fails or the timeout passes) and return
    (the ranks' results, their output).  Raises RuntimeError naming a
    child's exit code or the timeout.  The kernels are built here, before
    the children start, so the children only load them."""
    config = dict(SMALL if config is None else config, device=device, backend=backend)
    config.setdefault("rules", RULES)
    if device != "cpu":
        from mdcommunity_tpu_torch.ops import band_kernels, cascade_kernels

        band_kernels.build()
        cascade_kernels.build()
    if "trainer" in config["phases"]:
        from mdcommunity_tpu_torch.native import build as native_build

        native_build.build()
    out_dir = out_dir or tempfile.mkdtemp(prefix="multihost_")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config, f)
    port = free_port()
    env = dict(os.environ)
    if device == "cpu":
        env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    n_proc = config.get("processes", N_PROC)
    logs = [open(os.path.join(out_dir, f"rank{k}.log"), "w+") for k in range(n_proc)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mdcommunity_tpu_torch.multihost_smoke", "--child", str(k),
         "--port", str(port), "--out", out_dir],
        stdout=logs[k], stderr=subprocess.STDOUT, cwd=REPO, env=env) for k in range(n_proc)]
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while failed is None and any(p.poll() is None for p in procs):
            bad = [k for k, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad:
                failed = f"child {bad[0]} exited with code {procs[bad[0]].returncode}"
            elif time.monotonic() > deadline:
                failed = f"the children did not finish within {timeout:.0f} s"
            else:
                time.sleep(0.1)
        if failed is None and any(p.returncode for p in procs):
            k = next(k for k, p in enumerate(procs) if p.returncode)
            failed = f"child {k} exited with code {procs[k].returncode}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    output = []
    for f in logs:
        f.seek(0)
        output.append(f.read())
        f.close()
    if failed:
        raise RuntimeError(failed + "\n" + "\n".join(
            f"--- rank {k} ---\n{o[-6000:]}" for k, o in enumerate(output)))
    results = []
    for k in range(n_proc):
        with open(os.path.join(out_dir, f"rank{k}.json")) as f:
            results.append(json.load(f))
    return results, output


AGREE = ("loss", "losses", "digest", "vc", "removed")


def check_agreement(results, path="") -> None:
    """Raise unless every process reports alike the numbers that must agree
    (keys ending in AGREE: losses, digests of Q, outputs and parameters).
    Rank 0's comparisons with the one-process references are its own."""
    first = results[0]
    for key, v in first.items():
        if key == "foreign_modules" and any(r[key] for r in results):
            raise AssertionError(f"a child imported {[r[key] for r in results]}")
        if isinstance(v, dict):
            check_agreement([r[key] for r in results if key in r], f"{path}{key}.")
        elif key.endswith(AGREE):
            for k, r in enumerate(results[1:], 1):
                if r.get(key) != v:
                    raise AssertionError(f"{path}{key}: rank {k} reports {r.get(key)}, "
                                         f"rank 0 {v}")


# ---------------------------------------------------------------- children


def digest(*tensors) -> str:
    """A hash of the tensors' bytes (equal iff bit-equal, in practice)."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def graph_edges(graph):
    """(n, edges0, edges1, reorder) of a smoke graph.  kind "ring": the JAX
    smoke's ring (offsets 1..63 in both layers, seed 11; its best band
    order leaves no mirror lane); kind "mirror": two band-local rings of
    other density and reach plus 20 long edges from block 0, in their own
    order, so both layers have live mirror lanes."""
    n = graph["n"]
    layers = []
    if graph["kind"] == "ring":
        rng = np.random.default_rng(11)
        for _ in range(2):
            us = rng.integers(0, n, n * 3)
            ud = (us + rng.integers(1, 64, n * 3)) % n
            keep = us != ud
            layers.append(np.stack([us[keep], ud[keep]], 1))
        return n, layers[0], layers[1], True
    rng = np.random.default_rng(5)
    for m, reach in ((6, 100), (1, 4)):
        src = rng.integers(0, n, m * n)
        dst = (src + rng.integers(1, reach, m * n)) % n
        layers.append(np.concatenate([np.stack([src, dst], 1),
                                      np.stack([np.arange(20), np.arange(20) + 1100], 1)]))
    return n, layers[0], layers[1], False


def band_setup(graph, device):
    """(banded, ordered edges): every process builds the same spill-free
    duplex: graph_edges' kinds, or kind "synth", large_graph_demo's
    generator unshuffled in its own order (chip_smoke.py's training
    build)."""
    from mdcommunity_tpu_torch.graphs.banded import build_banded_duplex
    from mdcommunity_tpu_torch.large_graph_demo import synth_duplex_edges

    if graph["kind"] != "synth":
        n, e0, e1, reorder = graph_edges(graph)
        banded, _, edges = build_banded_duplex(n, e0, e1, reorder=reorder, device=device)
    else:
        e0, e1 = synth_duplex_edges(graph["n"], 6, np.random.default_rng(0), shuffle=False)
        banded, _, edges = build_banded_duplex(graph["n"], e0, e1, reorder=False, max_rank=0,
                                               device=device)
    if not banded.spill_free:
        raise AssertionError("the smoke's build has spill edges")
    return banded, edges


def _held(what, diff, scale, tol):
    """Raise unless diff <= tol · scale; return the diff over scale."""
    rel = diff / max(scale, 1e-30)
    if not diff <= tol * scale:
        raise AssertionError(f"{what}: max abs difference {diff:.3e} ({rel:.3e} of max) "
                             f"above {tol:.1e} of max")
    return rel


def _report(rank, label, row, checks):
    """row with each check's (diff, scale, tol) as diff/scale under its key,
    printed, then held (_held): every number is logged before one fails."""
    row = dict({k: d / max(sc, 1e-30) for k, (d, sc, _) in checks.items()}, **row)
    print(f"rank {rank} {label}: " + json.dumps(row), flush=True)
    for k, (d, sc, tol) in checks.items():
        _held(f"{label} {k}", d, sc, tol)
    return row


def _maxdiff(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def _rules(cfg):
    spec = importlib.util.spec_from_file_location("gradient_rules", cfg["rules"])
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _grads(net):
    return {k: p.grad.detach().double().cpu().numpy() for k, p in net.named_parameters()}


def _walk(g, steps, rng):
    """The batch's env state after `steps` random valid actions from reset,
    and the actions taken."""
    from mdcommunity_tpu_torch.env.env import batched_reset, batched_step

    s, acts = batched_reset(g), []
    for _ in range(steps):
        q = np.where(s.covered.cpu().numpy() | ~g.node_mask.cpu().numpy(), -1.0,
                     rng.random(tuple(g.node_mask.shape)))
        a = torch.from_numpy(np.argmax(q, axis=1)).to(g.node_mask.device)
        s, _ = batched_step(g, s, a)
        acts.append(a)
    return s, acts


def phase_dp_step(cfg, device, rank, arrays, graph):
    """One dp = 2 train step on an 8-graph batch against the whole batch's
    step in this process (tests/test_torch_dqn.py's batch)."""
    from mdcommunity_tpu_torch.graphs.duplex import stack_graphs
    from mdcommunity_tpu_torch.graphs.gmm import generate_pool
    from mdcommunity_tpu_torch.models.net import from_jax_params, init_params
    from mdcommunity_tpu_torch.parallel.mesh import make_mesh
    from mdcommunity_tpu_torch.rl.dqn import train_step

    B = 8
    dp = torch.distributed.get_world_size()
    mesh = make_mesh(1, device, dp=dp)
    g = stack_graphs(generate_pool(np.random.default_rng(3), B, 16, 24, 32, 256, False,
                                   device=device))
    s0, _ = _walk(g, 3, np.random.default_rng(5))
    a_t = _walk(g, 4, np.random.default_rng(5))[1][3]
    s1, _ = _walk(g, 5, np.random.default_rng(5))
    rng = np.random.default_rng(6)
    rewards = torch.from_numpy(-rng.random(B).astype(np.float32)).to(device)
    terminal = torch.from_numpy(rng.random(B) < 0.3).to(device)
    params = init_params(torch.Generator().manual_seed(1), w_init_std=0.3)
    target = from_jax_params(init_params(torch.Generator().manual_seed(2), w_init_std=0.3),
                             device)
    rows = slice(mesh.dp_rank * B // dp, (mesh.dp_rank + 1) * B // dp)
    out = {}
    for which, m, sl in (("single", None, slice(None)), ("dp", mesh, rows)):
        net = from_jax_params(params, device).requires_grad_(True)
        opt = torch.optim.Adam(net.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8)
        loss, _, _, td = train_step(
            net, target, opt, g.map(lambda x: x[sl]), s0.covered[sl], s0.sever[sl],
            a_t[sl], rewards[sl], s1.covered[sl], s1.sever[sl], terminal[sl], mesh=m)
        out[which] = (loss.item(), td, [p.detach().clone() for p in net.parameters()])
    (l1, td1, p1), (l2, td2, p2) = out["single"], out["dp"]
    _held("dp step loss", abs(l2 - l1), abs(l1), 1e-5)
    _held("dp step td", _maxdiff(td2, td1), td1.abs().max().item(), 1e-5)
    worst = max(_maxdiff(a, b) for a, b in zip(p1, p2))
    if not worst <= 2e-4:  # Adam's first step moves each weight by at most lr
        raise AssertionError(f"dp step parameters differ by {worst:.3e}")
    return dict(loss=l2, single_loss=l1, param_diff=worst, digest=digest(*p2))


def _net(cfg, device):
    from mdcommunity_tpu_torch.models.checkpoint import load_model

    return load_model(cfg.get("ckpt", CKPT), device=device)


def phase_gp(cfg, device, rank, arrays, graph):
    """gp = 4 shards, N_PROC processes: the operator's forward and VJP, Q
    and the loss against the one-process gp = 4 calls on the same device;
    the gradients of both losses against the float64 one-process loss on
    the CPU (_f64_referee) by tests/gradient_rules.py's leaf_tolerances.
    The references run on rank 0 only (the processes share a card); the
    others' results have the same bits (check_agreement compares their
    digests)."""
    from mdcommunity_tpu_torch.graphs.banded import shard_banded_duplex
    from mdcommunity_tpu_torch.models.net import banded_test_forward, banded_train_loss
    from mdcommunity_tpu_torch.ops import band_kernels as bk
    from mdcommunity_tpu_torch.ops.dense_band import spmm_dense_band
    from mdcommunity_tpu_torch.parallel.band_partition import (
        spmm_band_sharded,
        spmm_band_sharded_grad,
    )
    from mdcommunity_tpu_torch.parallel.mesh import (
        all_reduce,
        gather_nodes,
        make_mesh,
        reduce_grads,
        split_nodes,
    )
    from mdcommunity_tpu_torch.utils.device import matmul_precision

    banded, _ = graph()
    pad_n, n = banded.pad_n, banded.n_nodes
    rng = np.random.default_rng(3)
    h, row, col, g0 = (torch.from_numpy(x).to(device) for x in (
        rng.standard_normal((pad_n, 64)).astype(np.float32),
        (rng.random(pad_n) < 0.9).astype(np.float32),
        (rng.random(pad_n) < 0.9).astype(np.float32),
        rng.standard_normal((pad_n, 64)).astype(np.float32)))
    covered = rng.random(pad_n) < 0.05
    covered[n:] = True
    acts = np.flatnonzero(~covered[:n])
    acts = rng.choice(acts, cfg["actions"], replace=False) if cfg["actions"] < len(acts) \
        else acts
    tgts = (0.1 * rng.standard_normal(len(acts)) - 0.05).astype(np.float32)
    if rank == 0:
        arrays.update(h=h.cpu().numpy(), row=row.cpu().numpy(), col=col.cpu().numpy(),
                      g0=g0.cpu().numpy(), covered=covered, acts=acts, tgts=tgts)
    covered = torch.from_numpy(covered).to(device)
    mesh, one = make_mesh(GP, device), make_mesh(GP, device, processes=1)
    sh, sh1 = shard_banded_duplex(mesh, banded), shard_banded_duplex(one, banded)
    res = dict(pad_n=pad_n, C=banded.dbg0.C, local=list(mesh.local))
    tol, k1_tol = cfg["shard_tol"], cfg["k1_tol"]
    for precise in cfg["precise"]:
        mode = "precise" if precise else "fast"

        def op(m, s):
            return gather_nodes(m, spmm_band_sharded(m, s.dbg0, *(split_nodes(m, x) for x in
                                                                   (row, col, h)), precise))

        def vjp(m, s):
            hs = [x.clone().requires_grad_() for x in split_nodes(m, h)]
            return gather_nodes(m, list(torch.autograd.grad(spmm_band_sharded_grad(
                m, s.dbg0, split_nodes(m, row), split_nodes(m, col), hs, precise), hs,
                split_nodes(m, g0))))

        bk.reset_launches()
        out, dh = op(mesh, sh), vjp(mesh, sh)
        row_ = dict(launches={k: v for k, v in bk.launches.items() if v},
                    digest=digest(out, dh))
        if rank == 0:
            out1, dh1 = op(one, sh1), vjp(one, sh1)
            k1 = spmm_dense_band(banded.dbg0, row, col, h, precise=precise)
            scale = k1.abs().max().item()
            row_ = _report(rank, f"gp op_{mode}", row_, dict(
                vs_one_process=(_maxdiff(out, out1), scale, tol),
                vjp_vs_one_process=(_maxdiff(dh, dh1), dh1.abs().max().item(), tol),
                vs_k1=(_maxdiff(out, k1), scale, k1_tol)))
            arrays.update({f"out_{mode}": out.cpu().numpy(), f"dh_{mode}": dh.cpu().numpy()})
        res[f"op_{mode}"] = row_

    net = _net(cfg, device)
    for precise in cfg["precise"]:
        mode = "precise" if precise else "fast"
        with matmul_precision(precise):
            bk.reset_launches()
            q = banded_test_forward(net, sh, covered, precise=precise)
            row_ = dict(launches={k: v for k, v in bk.launches.items() if v}, digest=digest(q))
            if rank == 0:
                q1 = banded_test_forward(net, sh1, covered, precise=precise)
                qu = banded_test_forward(net, banded, covered, precise=precise)
        if rank == 0:
            fin = torch.isfinite(q1)
            if not torch.equal(torch.isfinite(q), fin):
                raise AssertionError(f"{mode} Q: -inf masks differ")
            scale = q1[fin].abs().max().item()
            row_ = _report(rank, f"gp q_{mode}", row_, dict(
                vs_one_process=(_maxdiff(q[fin], q1[fin]), scale, tol),
                vs_unsharded=(_maxdiff(q[fin], qu[fin]), scale, cfg["unsharded_tol"][mode])))
            arrays[f"q_{mode}"] = q.cpu().numpy()
        res[f"q_{mode}"] = row_

    a, t = torch.from_numpy(acts).to(device), torch.from_numpy(tgts).to(device)
    net.requires_grad_(True)
    net1 = copy.deepcopy(net)
    with matmul_precision(True):
        part = banded_train_loss(net, sh, covered, a, t)
        part.backward()
        reduce_grads(mesh, net.parameters())
        loss = all_reduce(mesh, part.detach()).item()
    got = _grads(net)
    res["loss"] = dict(loss=loss, part=part.item(),
                       digest=digest(*(p.grad for p in net.parameters())))
    if rank != 0:
        return res
    with matmul_precision(True):
        loss1 = banded_train_loss(net1, sh1, covered, a, t)
        loss1.backward()
    one = _grads(net1)
    t0 = time.perf_counter()
    ref, tols = _f64_referee(cfg, device, graph, arrays)
    worst = {which: {k: float(np.abs(g[k] - ref[k]).max() / tols[k]) for k in ref}
             for which, g in (("processes", got), ("one_process", one))}
    res["loss"].update(one_process=loss1.item(), leaf_err_of_tol=worst,
                       f64_s=time.perf_counter() - t0)
    print(f"rank {rank} gp loss: " + json.dumps(res["loss"]), flush=True)
    bad = [f"{which} {k}" for which, w in worst.items() for k, v in w.items() if not v <= 1.0]
    if bad:
        raise AssertionError(f"gradient leaves {bad} differ from the float64 one-process "
                             f"loss's beyond tests/gradient_rules.py's tolerance: {worst}")
    _held("loss vs one process", abs(loss - loss1.item()), abs(loss1.item()), 1e-6)
    arrays["loss"] = np.float64(loss)
    arrays.update({f"grad.{k}": v for k, v in got.items()})
    arrays.update({f"grad1.{k}": v for k, v in one.items()})
    return res


def _f64_referee(cfg, device, graph, arrays):
    """The gp phase's loss in float64 on the CPU, in one process and
    unsharded (net.double(), the same build, cover, actions and targets, as
    tests/test_torch_multihost.py's referee): its gradients by leaf, and
    each leaf's tolerance by tests/gradient_rules.py's leaf_tolerances, the
    gate leaves with their terms (gate_terms)."""
    from mdcommunity_tpu_torch.models.net import banded_train_loss

    rules = _rules(cfg)
    banded = graph()[0] if device == "cpu" else band_setup(cfg["graph"], "cpu")[0]
    net = _net(cfg, "cpu").double().requires_grad_(True)
    with rules.gate_terms(net) as terms:   # remat off: one forward, not two
        banded_train_loss(net, banded, *(torch.from_numpy(arrays[k]) for k in (
            "covered", "acts")), torch.from_numpy(arrays["tgts"]).double(),
            remat=False).backward()
    ref = _grads(net)
    return ref, rules.leaf_tolerances(ref, terms.sums())


class _Recorder:
    """A host env that records each step_many's actions."""

    def __init__(self, env):
        self._env = env
        self.actions = []

    def __getattr__(self, name):
        return getattr(self._env, name)

    def step_many(self, actions, *args, **kw):
        self.actions.append([int(x) for x in actions])
        return self._env.step_many(actions, *args, **kw)


def phase_trainer(cfg, device, rank, arrays, graph):
    """train_banded_loop(mesh=) across the processes beside the one-process
    sharded loop (unfused, eps = 1: actions from the seeded rng): the same
    removals, the first loss within 1e-5, parameters within 2·lr a fit of the
    one-process loop's and bit-equal across the processes; K3's launches
    counted over the cross-process loop."""
    from mdcommunity_tpu_torch.env.host_env import make_host_env
    from mdcommunity_tpu_torch.models.checkpoint import load_model
    from mdcommunity_tpu_torch.ops import band_kernels as bk
    from mdcommunity_tpu_torch.parallel.mesh import make_mesh
    from mdcommunity_tpu_torch.rl.big_trainer import train_banded_loop

    tc = cfg["trainer"]
    banded, edges = graph()
    net = load_model(tc.get("ckpt", CKPT), device=device)
    lr, runs = 1e-4, {}
    meshes = [("processes", make_mesh(GP, device))]
    if rank == 0:
        meshes.append(("one_process", make_mesh(GP, device, processes=1)))
    for which, mesh in meshes:
        env = _Recorder(make_host_env(banded.n_nodes, *edges, engine=tc.get("engine", "auto")))
        if device != "cpu":
            torch.cuda.synchronize()
        bk.reset_launches()
        t0 = time.perf_counter()
        net2, hist = train_banded_loop(net, banded, env, iters=tc["iters"], k=tc["k"],
                                       target_update=3, eps_start=1.0, eps_end=1.0, lr=lr,
                                       packed=False, mesh=mesh, log=lambda *a: None)
        if device != "cpu":
            torch.cuda.synchronize()
        rows = [h for h in hist if "loss" in h]
        runs[which] = dict(actions=env.actions, losses=[h["loss"] for h in rows],
                           counts={k: v for k, v in bk.launches.items() if v},
                           params=[p.detach().clone() for p in net2.parameters()],
                           wall_s=time.perf_counter() - t0)
    p = runs["processes"]
    res = dict(removed=[len(a) for a in p["actions"]], losses=p["losses"],
               launches=p["counts"], wall_s=p["wall_s"], digest=digest(*p["params"]))
    for name in ("band_halo", "band_halo_bwd"):
        if device != "cpu" and p["counts"].get(name, 0) <= 0:
            raise AssertionError(f"{name} was not launched in the cross-process loop")
    if rank != 0:
        return res
    o = runs["one_process"]
    if o["actions"] != p["actions"]:
        raise AssertionError("the cross-process loop removed other nodes than the one-process "
                             "loop")
    lo, lp = np.array(o["losses"]), np.array(p["losses"])
    fits = int(np.isfinite(lo).sum())
    if not fits or not np.array_equal(np.isfinite(lo), np.isfinite(lp)):
        raise AssertionError("the loops fitted different iterations")
    first = int(np.argmax(np.isfinite(lo)))  # the first fit: the same state in both
    rel = float(abs(lp[first] - lo[first]) / abs(lo[first]))
    worst = max(_maxdiff(a, b) for a, b in zip(o["params"], p["params"]))
    if not rel <= 1e-5 or not worst <= 2 * lr * fits:
        raise AssertionError(f"the cross-process fit differs from the one-process one: loss "
                             f"{rel:.3e}, parameters {worst:.3e}")
    return dict(res, one_process=o["losses"], loss_rel=rel, param_diff=worst,
                one_process_wall_s=o["wall_s"])


def _agent_cfg(cfg):
    from mdcommunity_tpu_torch.utils.config import Config

    ac = cfg["agent"]
    base = Config().smoke if ac.get("smoke") else Config()
    return dataclasses.replace(base, **ac.get("config", {}))


def _load_state(agent, path):
    """Params (target = params), replay and numpy generator from a file
    saved_agent_state wrote: the same weights and batches as the agent it
    was taken from."""
    from mdcommunity_tpu_torch.models.net import from_jax_params

    z = np.load(path, allow_pickle=False)
    tree = {}
    for k in z.files:
        if k.startswith("param."):
            parts = k[len("param."):].split(".")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[k]
    src = from_jax_params(tree, "cpu").state_dict()
    agent.net.load_state_dict(src)
    agent.target_net.load_state_dict(src)
    rp = agent.replay
    for k in z.files:
        if k.startswith("replay."):
            name = k[len("replay."):]
            if name == "tree":
                rp.tree.tree[...] = z[k]
            elif np.ndim(z[k]) == 0:
                setattr(rp, name, type(getattr(rp, name))(z[k]))
            else:
                getattr(rp, name)[...] = z[k]
    agent.nprng.bit_generator.state = json.loads(str(z["nprng"]))


def phase_dp_agent(cfg, device, rank, arrays, graph):
    """DQNAgent(mesh=dp N_PROC): `fits` fits from the same state as a
    single-process agent of the same seed (its own play, or a saved agent
    state): losses within 1e-5 of the loss, the replay indices of each fit
    and the parameters the same on every process."""
    from mdcommunity_tpu_torch.parallel.mesh import make_mesh
    from mdcommunity_tpu_torch.rl.dqn import DQNAgent

    ac = cfg["agent"]
    acfg = _agent_cfg(cfg)
    mesh = make_mesh(1, device, dp=torch.distributed.get_world_size())
    runs = {}
    for which, m in [("dp", mesh)] + ([("single", None)] if rank == 0 else []):
        agent = DQNAgent(acfg, device=device, mesh=m)
        agent.gen_new_graphs()
        if ac.get("state"):
            _load_state(agent, ac["state"])
        else:
            for _ in range(ac.get("warmup_games", 1)):
                agent.play_games(ac.get("warmup_traj", 10), 1.0)
            agent.take_snapshot()
        picked = []
        if acfg.use_prioritized:
            draw = agent.replay.sample_prioritized

            def sample_prioritized(*a, **kw):
                pb = draw(*a, **kw)
                picked.append(pb.tree_idx.tolist())
                return pb

            agent.replay.sample_prioritized = sample_prioritized
        else:
            gather = agent.replay._gather

            def _gather(idx):
                picked.append(np.asarray(idx).tolist())
                return gather(idx)

            agent.replay._gather = _gather
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [float(agent.fit()) for _ in range(ac["fits"])]
        agent._flush_priorities()
        runs[which] = dict(losses=losses, picked=picked, wall_s=time.perf_counter() - t0,
                           params=[p.detach().clone() for p in agent.net.parameters()])
    d = runs["dp"]
    res = dict(losses=d["losses"], fit_s=d["wall_s"], digest=digest(*d["params"]),
               picked_digest=hashlib.sha256(json.dumps(d["picked"]).encode()).hexdigest()[:16])
    if rank != 0:
        return res
    s = runs["single"]
    rel = max(abs(a - b) / abs(a) for a, b in zip(s["losses"], d["losses"]))
    if not rel <= 1e-5:
        raise AssertionError(f"the dp agent's losses {d['losses']} differ from the single "
                             f"agent's {s['losses']}")
    arrays["dp_losses"] = np.array(d["losses"])
    return dict(res, single=s["losses"], loss_rel=rel,
                param_diff=max(_maxdiff(a, b) for a, b in zip(s["params"], d["params"])),
                picked_same_as_single=d["picked"] == s["picked"], single_fit_s=s["wall_s"])


def phase_validate(cfg, device, rank, arrays, graph):
    """DQNAgent.validate under dp (each process half the pool) against the
    single-process score of the same net and pool."""
    from mdcommunity_tpu_torch.parallel.mesh import make_mesh
    from mdcommunity_tpu_torch.rl.dqn import DQNAgent, validation_score

    agent = DQNAgent(_agent_cfg(cfg), device=device,
                     mesh=make_mesh(1, device, dp=torch.distributed.get_world_size()))
    agent.prepare_valid_data()
    vc = agent.validate()
    if rank != 0:
        return dict(vc=vc)
    with agent._prec():
        single = validation_score(agent.net, agent.valid_pool.stacked, agent.cfg.variant,
                                  agent.degree_cost)
    if abs(vc - single) > 1e-6:
        raise AssertionError(f"dp validation {vc} differs from the single-process {single}")
    return dict(vc=vc, single=single, graphs=len(agent.valid_pool))


def phase_partition(cfg, device, rank, arrays, graph):
    """spmm_edge_partitioned at gp = GP across the processes against the
    same call in one process: the sum, and the gradients of w and h of
    Σ out·g (rank 0's part; the other's 0), summed with reduce_grads."""
    from mdcommunity_tpu_torch.parallel.mesh import make_mesh, reduce_grads
    from mdcommunity_tpu_torch.parallel.partition import spmm_edge_partitioned

    pc = cfg["partition"]
    n, e, D = pc["n"], pc["edges"], pc["D"]
    rng = np.random.default_rng(4)
    src = torch.from_numpy(rng.integers(0, n, e)).to(device)
    dst = torch.from_numpy(rng.integers(0, n, e)).to(device)
    w0 = torch.from_numpy(rng.random(e).astype(np.float32)).to(device)
    h0 = torch.from_numpy(rng.standard_normal((n, D)).astype(np.float32)).to(device)
    g = torch.from_numpy(rng.standard_normal((n, D)).astype(np.float32)).to(device)
    res = {}
    meshes = [("procs", make_mesh(GP, device))]
    if rank == 0:
        meshes.append(("one", make_mesh(GP, device, processes=1)))
    for which, mesh in meshes:
        w, h = w0.clone().requires_grad_(), h0.clone().requires_grad_()
        out = spmm_edge_partitioned(mesh, src, dst, w, h)[0]
        ((out * g).sum() * float(rank == 0)).backward()
        reduce_grads(mesh, [w, h])
        res[which] = (out.detach(), w.grad, h.grad)
    if rank != 0:
        return dict(digest=digest(*res["procs"]))
    err = {}
    for name, a, b in zip(("out", "dw", "dh"), res["procs"], res["one"]):
        err[name] = _held(f"edge partition {name}", _maxdiff(a, b),
                          b.abs().max().item(), pc["tol"])
    return dict(errors=err, digest=digest(*res["procs"]))


def phase_timing(cfg, device, rank, arrays, graph):
    """The cross-process sharded model call (forward + stable top-k) beside
    the one-process gp = GP call, and one halo exchange (h and col, the ring
    both ways) and one mirror gather at the call's shapes.  The one-process
    call runs on rank 0 while the others wait."""
    import torch.distributed as dist

    from mdcommunity_tpu_torch.eval.metrics import top_k_stable
    from mdcommunity_tpu_torch.graphs.banded import shard_banded_duplex
    from mdcommunity_tpu_torch.models.net import banded_test_forward
    from mdcommunity_tpu_torch.parallel.mesh import all_gather, make_mesh, ring_halos, split_nodes
    from mdcommunity_tpu_torch.utils.device import matmul_precision

    tc = cfg["timing"]
    banded, _ = graph()
    net = _net(cfg, device)
    mesh, one = make_mesh(GP, device), make_mesh(GP, device, processes=1)
    sh, sh1 = shard_banded_duplex(mesh, banded), shard_banded_duplex(one, banded)
    covered = ~banded.node_mask
    k = max(int(0.001 * banded.n_nodes), 1)

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    def timed(fn, calls, barrier=True):
        fn()
        sync()
        if barrier:
            dist.barrier()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        sync()
        return 1e3 * (time.perf_counter() - t0) / calls

    def call(s):
        with matmul_precision(True):
            return top_k_stable(banded_test_forward(net, s, covered), k)

    calls = tc["calls"]
    res = dict(model_call_ms=timed(lambda: call(sh), calls))
    if rank == 0:
        res["one_process_model_call_ms"] = timed(lambda: call(sh1), calls, barrier=False)
    dist.barrier()
    hs = split_nodes(mesh, torch.randn(banded.pad_n, 64, device=device))
    cs = split_nodes(mesh, torch.ones(banded.pad_n, device=device))
    res["halo_exchange_ms"] = timed(lambda: (ring_halos(mesh, hs, banded.dbg0.B),
                                             ring_halos(mesh, cs, banded.dbg0.B)), 4 * calls)
    m_rows = banded.dbg0.n_blocks // GP * banded.dbg0.C
    tabs = [torch.randn(m_rows, 64, device=device) for _ in mesh.local]
    res["mirror_gather_ms"] = timed(lambda: all_gather(mesh, tabs), 4 * calls)
    # a model call runs the sharded operator 8 times (2 degree passes, 3
    # rounds x 2 layers), each with one halo exchange and one mirror gather;
    # timed at D = 64, where the degree passes carry D = 2: upper estimates
    res["halo_share_est"] = 8 * res["halo_exchange_ms"] / res["model_call_ms"]
    res["transport_share_est"] = 8 * (res["halo_exchange_ms"] + res["mirror_gather_ms"]) / \
        res["model_call_ms"]
    return res


def phase_mesh(cfg, device, rank, arrays, graph):
    """The mesh's transport on a dp × gp layout (cfg["dp"] replicas of gp =
    GP shards over the processes, each axis its own process group): the ring
    halos, the node gather and the shard-order sums against a one-process
    mesh, and an all-reduce over dp."""
    from mdcommunity_tpu_torch.parallel.mesh import (
        add_in_order,
        all_reduce,
        gather_nodes,
        gather_parts,
        make_mesh,
        ring_halos,
        split_nodes,
    )

    mesh, one = make_mesh(GP, device, dp=cfg["dp"]), make_mesh(GP, device, processes=1)
    x = torch.arange(64 * 3, dtype=torch.float32, device=device).reshape(64, 3)
    x = x * (1 + mesh.dp_rank)  # each replica its own data
    parts = split_nodes(mesh, x)
    halos, halos1 = ring_halos(mesh, parts, 4), ring_halos(one, split_nodes(one, x), 4)
    for got, ref in zip(halos, halos1):
        if not all(torch.equal(a, ref[i]) for a, i in zip(got, mesh.local)):
            raise AssertionError("the ring halos differ from one process's")
    if not torch.equal(gather_nodes(mesh, parts), x):
        raise AssertionError("gather_nodes differs from the whole tensor")
    total = add_in_order(gather_parts(mesh, [p.sum(0) for p in parts]))
    if not torch.equal(total, add_in_order([p.sum(0) for p in split_nodes(one, x)])):
        raise AssertionError("the shard-order sum differs from one process's")
    replicas = all_reduce(mesh, torch.ones(1, device=device), "dp").item()
    if replicas != cfg["dp"]:
        raise AssertionError(f"an all-reduce over dp counts {replicas} replicas")
    return dict(dp_rank=mesh.dp_rank, gp_rank=mesh.rank, local=list(mesh.local))


PHASES = dict(mesh=phase_mesh, dp_step=phase_dp_step, gp=phase_gp, trainer=phase_trainer,
              dp_agent=phase_dp_agent, validate=phase_validate, partition=phase_partition,
              timing=phase_timing)


def child(rank: int, port: int, out_dir: str) -> None:
    """One process of the run: init_distributed, the configured phases,
    rank<k>.json and rank<k>.npz; the process group is torn down on the
    way out, failed or not."""
    import torch.distributed as dist

    from mdcommunity_tpu_torch.parallel.mesh import init_distributed

    with open(os.path.join(out_dir, "config.json")) as f:
        cfg = json.load(f)
    device, backend = cfg["device"], cfg["backend"]
    if device == "cpu":
        torch.set_num_threads(1)
    n_proc = cfg.get("processes", N_PROC)
    got = init_distributed(f"127.0.0.1:{port}", n_proc, rank, backend)
    if got != rank or dist.get_world_size() != n_proc:
        raise AssertionError(f"init_distributed gave rank {got} of {dist.get_world_size()}")
    if device != "cpu":
        device = f"cuda:{torch.cuda.current_device()}"
    results, arrays = {}, {}
    # the phases' graph, built once (band_setup; the trainer forks it)
    graph = functools.cache(lambda: band_setup(cfg["graph"], device))
    try:
        for phase in cfg["phases"]:
            t0 = time.perf_counter()
            results[phase] = PHASES[phase](cfg, device, rank, arrays, graph)
            results[phase]["seconds"] = time.perf_counter() - t0
            print(f"rank {rank} phase {phase}: " + json.dumps(results[phase]), flush=True)
    finally:
        dist.destroy_process_group()
    # the children run the port alone: no JAX, nothing of the JAX package
    results["foreign_modules"] = sorted({m.split(".")[0] for m in sys.modules} &
                                        {"jax", "jaxlib", "optax", "mdcommunity_tpu"})
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(results, f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds for the children")
    ap.add_argument("--out", default=None, help="directory for the children's files")
    ap.add_argument("--child", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        child(args.child, args.port, args.out)
        return 0
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("CUDA is not available: pass --device cpu")
    results, _ = run(args.device, args.backend, out_dir=args.out, timeout=args.timeout)
    check_agreement(results)
    dp, gp = results[0]["dp_step"], results[0]["gp"]
    print(f"multihost_smoke OK: {N_PROC} processes ({args.device}, {args.backend}), dp step "
          f"loss={dp['loss']:.10f} = single-process {dp['single_loss']:.10f}; gp={GP} "
          f"spanning both processes: band halo-exchange fwd+VJP, Q and banded_train_loss "
          f"grad verified cross-process (loss={gp['loss']['loss']:.10f}, one process "
          f"{gp['loss']['one_process']:.10f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
