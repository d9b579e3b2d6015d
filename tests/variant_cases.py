"""Shared cases of the variant tests (tests/test_torch_variants*.py): the
committed checkpoints, a 400-node demo graph, and the rule that holds two
packages' trajectories to each other.

Trajectories: both packages compute Q in f32 and take the same removals
until a decision hangs on a gap below f32 rounding.  Each run is held to
identical removals up to its first parting, and that parting must be a
near-tie: each package ranks its own pick first, by a gap of at most TIE of
the scale eval/metrics.tie_scale reads (max|Q| over the Q above -1e8; for
two of HCA's unselected nodes at -1e9·w, their own magnitude).  With no
parting the AUDCs are equal and, for degree cost, the Cost_ files too."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mdcommunity_tpu.env.env import batched_reset as jax_reset
from mdcommunity_tpu.env.env import batched_step as jax_step
from mdcommunity_tpu.graphs.banded import apply_severs as jax_apply_severs
from mdcommunity_tpu.graphs.banded import build_banded_duplex as jax_build
from mdcommunity_tpu.graphs.duplex import stack_graphs as jax_stack
from mdcommunity_tpu.graphs.io import load_real_duplex as jax_load
from mdcommunity_tpu.models.hca_banded import banded_hca_forward as jax_hca_fwd
from mdcommunity_tpu.models.hca_banded import make_hca_band_data as jax_hca_data
from mdcommunity_tpu.models.net import banded_test_forward as jax_fwd
from mdcommunity_tpu.rl.dqn import predict_q as jax_predict_q
from mdcommunity_tpu_torch.env.env import batched_reset, batched_step
from mdcommunity_tpu_torch.eval.metrics import tie_scale
from mdcommunity_tpu_torch.graphs.duplex import stack_graphs
from mdcommunity_tpu_torch.graphs.io import load_real_duplex, read_multiplex_edges
from mdcommunity_tpu_torch.large_graph_demo import synth_duplex_edges, write_edges
from mdcommunity_tpu_torch.models.checkpoint import load_model, load_params
from mdcommunity_tpu_torch.rl.dqn import predict_q

TIE = 1e-5
N = 400
STEP_RATIO = 0.01
CKPTS = {"degree_cost": "degree_100k_r5", "ce": "ce_100k_r5", "hca": "hca_100k_r5"}
VARIANTS = ("degree_cost", "ce", "hca")


def ckpt(variant):
    return os.path.join("models_tpu", CKPTS[variant], "best_model.ckpt")


def load_kw(variant):
    return dict(degree_cost=variant == "degree_cost",
                prior_feature="boundary" if variant == "ce" else None, hca=variant == "hca")


def write_graph(d):
    """The 400-node demo graph as <d>/g.edges (layers 1 and 2)."""
    e0, e1 = synth_duplex_edges(N, 6, np.random.default_rng(3))
    write_edges(os.path.join(d, "g.edges"), e0, e1)
    return d


def is_near_tie(qa_own, qb_own, q_own, qa_other, qb_other, q_other, a, b):
    """a is the first package's pick, b the other's: each ranks its own
    first, by at most TIE of tie_scale."""
    s1, s2 = tie_scale(q_own, a, b), tie_scale(q_other, a, b)
    return bool(s1 is not None and s2 is not None and qa_own >= qb_own
                and qb_other >= qa_other and qa_own - qb_own <= TIE * s1
                and qb_other - qa_other <= TIE * s2)


def small_parting(variant, path, jsol, tsol, step):
    """graph_parting on the two packages' graphs of the edge file."""
    return graph_parting(variant, jax_load(path, N, (1, 2), **load_kw(variant)),
                         load_real_duplex(path, N, (1, 2), device="cpu", **load_kw(variant)),
                         jsol, tsol, step)


def graph_parting(variant, jg, tg, jsol, tsol, step):
    """(k, near-tie?) of the first parting of two dismantle_greedy runs on
    one graph (the JAX package's jg, the port's tg): replay the common
    prefix up to the model call of removal k in both packages and read the
    two picks' Q there."""
    k = next((i for i, (a, b) in enumerate(zip(jsol, tsol)) if a != b),
             min(len(jsol), len(tsol)))
    if k == len(jsol) or k == len(tsol):
        return k, False  # one run stopped where the other went on
    c0 = (k // step) * step
    jg, tg = jax_stack([jg]), stack_graphs([tg])
    js, ts = jax_reset(jg), batched_reset(tg)
    dc = variant == "degree_cost"
    for a in jsol[:c0]:
        js, _ = jax_step(jg, js, jnp.asarray([a]), dc)
        ts, _ = batched_step(tg, ts, torch.tensor([a]), dc)
    qj = np.asarray(jax_predict_q(load_params(ckpt(variant)), jg, js.covered, js.sever,
                                  variant))[0]
    qt = predict_q(load_model(ckpt(variant), device="cpu"), tg, ts.covered, ts.sever,
                   variant)[0].numpy()
    a, b = jsol[k], tsol[k]
    return k, is_near_tie(qj[a], qj[b], qj, qt[a], qt[b], qt, a, b)


def hold(variant, path, jsol, tsol, jscore, tscore, tmp_path, parting):
    sub = "StepRatio_%.4f" % STEP_RATIO
    if jsol == tsol:
        np.testing.assert_allclose(tscore, jscore, rtol=1e-6)
        if variant == "degree_cost":
            for side in ("jax", "port"):
                assert os.path.isfile(tmp_path / side / sub / "Cost_g_12.txt")
            with open(tmp_path / "jax" / sub / "Cost_g_12.txt") as f:
                ref = f.read().split()
            with open(tmp_path / "port" / sub / "Cost_g_12.txt") as f:
                got = f.read().split()
            assert len(got) == len(ref) and got[:-1] == ref[:-1]
            np.testing.assert_allclose(float(got[-1]), float(ref[-1]), rtol=1e-6)
        return
    k, tie = parting()
    assert tie, f"{variant}: the packages part at removal {k} on a decision that is not a near-tie"


class JaxShadow:
    """The port's banded rollout (dismantle_greedy_banded's shadow) held
    to the JAX package's banded forward of the same variant on a JAX band
    of its own, severed as the env reports, until the first call whose
    valid top-k prefix differs; `parting` then says whether it is a
    near-tie."""

    def __init__(self, variant, path, step, n=N):
        g = jax_load(path, n, (1, 2), max_rank=0, **load_kw(variant))
        raw = read_multiplex_edges(path, n)
        self.jb, perm, _ = jax_build(
            n, raw[1], raw[2],
            weights=np.asarray(g.weights) if variant == "degree_cost" else None,
            node_feat=np.asarray(g.node_feat)[:, :n] if variant == "ce" else None)
        params = load_params(ckpt(variant))
        if variant == "hca":
            hd = jax_hca_data(np.asarray(g.comm_id)[:, :n], np.asarray(g.n_comms),
                              np.asarray(g.hca_feat)[:n], perm, self.jb.pad_n)
            fwd = jax.jit(lambda b, c: jax_hca_fwd(params, b, hd, c, precise=True))
        else:
            fwd = jax.jit(lambda b, c: jax_fwd(params, b, c, variant=variant, precise=True))
        self.fwd, self.step, self.seen, self.removed = fwd, step, None, 0
        self.parting = self.detail = None

    def __call__(self, env, q, covered, acts):
        import jax.lax as lax

        if self.parting is not None:
            return
        if self.seen is None:
            self.seen = [np.zeros_like(m) for m in env.sever]
        for layer in range(2):
            ns = env.edges[layer][env.sever[layer] & ~self.seen[layer]]
            if len(ns):
                k = 8
                while k < len(ns):
                    k *= 2
                s, d, v = (np.zeros(k, np.int32), np.zeros(k, np.int32), np.zeros(k, bool))
                s[: len(ns)], d[: len(ns)], v[: len(ns)] = ns[:, 0], ns[:, 1], True
                self.jb = jax_apply_severs(self.jb, layer, jnp.asarray(s), jnp.asarray(d),
                                           jnp.asarray(v))
            self.seen[layer] = env.sever[layer].copy()
        with jax.default_matmul_precision("highest"):
            qj = np.asarray(self.fwd(self.jb, jnp.asarray(covered.numpy())))
        vj, oj = (np.asarray(x) for x in lax.top_k(jnp.asarray(qj), self.step))
        ok = np.isfinite(vj) & ~env.covered[oj]
        aj = oj[: int(np.argmin(ok)) if not ok.all() else len(ok)]
        if not np.array_equal(aj, acts):
            i = next((i for i, (x, y) in enumerate(zip(aj, acts)) if x != y),
                     min(len(aj), len(acts)))
            a, b = int(aj[min(i, len(aj) - 1)]), int(acts[min(i, len(acts) - 1)])
            qt = q.numpy()
            self.parting = (self.removed + i,
                            is_near_tie(qj[a], qj[b], qj, qt[a], qt[b], qt, a, b))
            s_j, s_t = tie_scale(qj, a, b), tie_scale(qt, a, b)
            self.detail = dict(
                removal=self.removed + i, jax_takes=a, port_takes=b,
                q_jax=[float(qj[a]), float(qj[b])], q_port=[float(qt[a]), float(qt[b])],
                gap_share_jax=float(qj[a] - qj[b]) / (s_j or float("nan")),
                gap_share_port=float(qt[b] - qt[a]) / (s_t or float("nan")),
                tie=self.parting[1])
        self.removed += len(acts)
