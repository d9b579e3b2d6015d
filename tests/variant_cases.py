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
from gradient_rules import gate_terms, leaf_tolerances

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


# ------------------------------------------------- the variants' training


TRAIN_PAD_N, TRAIN_PAD_E, TRAIN_B = 32, 256, 8
PRIORS = {"unit_cost": "none", "degree_cost": "none", "ce": "boundary", "hca": "hca"}


def train_pools(variant, count=TRAIN_B, seed=3):
    """(JAX, port) stacks of `count` GMM graphs of 16-24 nodes with the
    variant's prior, drawn from one seed: the same graphs in both."""
    from mdcommunity_tpu.graphs.gmm import generate_pool as jax_pool
    from mdcommunity_tpu_torch.graphs.gmm import generate_pool

    args = (count, 16, 24, TRAIN_PAD_N, TRAIN_PAD_E, variant == "degree_cost",
            PRIORS[variant])
    return (jax_stack(jax_pool(np.random.default_rng(seed), *args)),
            stack_graphs(generate_pool(np.random.default_rng(seed), *args, device="cpu")))


def walk(jg, tg, steps, rng):
    """Both packages' states after `steps` random live actions from reset,
    and the actions taken (the same in both)."""
    js, ts = jax_reset(jg), batched_reset(tg)
    acts = []
    for _ in range(steps):
        q = np.where(ts.covered.numpy() | ~tg.node_mask.numpy(), -1.0,
                     rng.random(ts.covered.shape))
        a = np.argmax(q, axis=1)
        js, _ = jax_step(jg, js, jnp.asarray(a))
        ts, _ = batched_step(tg, ts, torch.from_numpy(a))
        acts.append(a)
    return js, ts, acts


def step_case(variant, seed=3):
    """One replay batch of both packages: graphs, s_t after 3 steps of a
    seeded walk, its action the walk's 4th, s_{t+n} after 5 steps, seeded
    rewards in (-1, 0], terminal flags and IS weights."""
    jg, tg = train_pools(variant, seed=seed)
    js0, ts0, _ = walk(jg, tg, 3, np.random.default_rng(seed + 2))
    a_t = walk(jg, tg, 4, np.random.default_rng(seed + 2))[2][3]
    js1, ts1, _ = walk(jg, tg, 5, np.random.default_rng(seed + 2))
    rng = np.random.default_rng(seed + 3)
    rewards = -rng.random(TRAIN_B).astype(np.float32)
    terminal = rng.random(TRAIN_B) < 0.3
    iw = rng.random(TRAIN_B).astype(np.float32)
    return dict(jg=jg, tg=tg, js0=js0, ts0=ts0, a_t=a_t, js1=js1, ts1=ts1,
                rewards=rewards, terminal=terminal, iw=iw)


def jax_step_args(c, weights):
    return (c["jg"], c["js0"].covered, c["js0"].sever, jnp.asarray(c["a_t"]),
            jnp.asarray(c["rewards"]), c["js1"].covered, c["js1"].sever,
            jnp.asarray(c["terminal"])), dict(
        is_weights=jnp.asarray(c["iw"]) if weights else None)


def port_step_args(c, weights, dtype=torch.float32):
    """train_step's batch arguments of the port, its graphs' and rewards'
    floats in `dtype` (float64 for a reference run)."""
    g = c["tg"].map(lambda t: t.to(dtype) if t.is_floating_point() else t)
    return dict(g=g, covered_st=c["ts0"].covered, sever_st=c["ts0"].sever,
                actions=torch.from_numpy(c["a_t"]),
                rewards=torch.from_numpy(c["rewards"]).to(dtype),
                covered_sp=c["ts1"].covered, sever_sp=c["ts1"].sever,
                terminal=torch.from_numpy(c["terminal"]),
                is_weights=torch.from_numpy(c["iw"]).to(dtype) if weights else None)


def grab():
    """An optax transformation whose new state is the gradient: the JAX
    train_step then returns its gradients as opt_state, its params unmoved."""
    import optax

    def zeros(t):
        return jax.tree_util.tree_map(jnp.zeros_like, t)

    return optax.GradientTransformation(zeros, lambda g, s, p=None: (zeros(g), g))


def flat(tree, prefix=""):
    """A parameter tree's leaves by dotted name, as numpy arrays."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


RTOL = 1e-5


def hold_train_step(params, target, c, variant, weights, opts):
    """JAX's train_step and the port's on one batch (step_case), the JAX
    parameters carried across: loss and mse at RTOL, the Laplacian term as
    tests/test_torch_dqn.py holds it, the TD errors at RTOL of their max,
    every gradient leaf under tests/gradient_rules.py's rule (GRAD_TOL of
    its max|grad| with LEAF_FLOOR, a gate leaf TERMS_TOL of its terms, from
    the port's run).  Returns the port's gradients."""
    from mdcommunity_tpu.rl.dqn import train_step as jax_train_step
    from mdcommunity_tpu_torch.models.net import from_jax_params
    from mdcommunity_tpu_torch.rl.dqn import train_step as port_train_step

    args, kw = jax_step_args(c, weights)
    o = grab()
    _, grads, jloss, jmse, jrecon, jtd = jax_train_step(
        params, target, o.init(params), *args, variant=variant, optimizer=o, **kw, **opts)
    net = from_jax_params(params, "cpu").requires_grad_(True)
    with gate_terms(net) as terms:
        loss, mse, recon, td = port_train_step(net, from_jax_params(target, "cpu"), None,
                                              **port_step_args(c, weights), variant=variant,
                                              **opts)
    for name, got, ref in (("loss", loss, jloss), ("mse", mse, jmse)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, err_msg=name)
    np.testing.assert_allclose(recon.numpy(), np.asarray(jrecon), rtol=RTOL, atol=4 * RTOL)
    jtd = np.asarray(jtd)
    np.testing.assert_allclose(td.numpy(), jtd, rtol=RTOL, atol=RTOL * np.abs(jtd).max())
    ref = flat(grads)
    got = {k: p.grad.numpy() for k, p in net.named_parameters()}
    assert set(got) == set(ref)
    for k, tol in leaf_tolerances(ref, terms.sums()).items():
        assert np.abs(got[k] - ref[k]).max() <= tol, k
    return got


# the leaves an HCA loss does not reach (tests/test_torch_hca_train.py)
HCA_ZERO_LEAVES = ("h1_weight", "h2_weight", "cross_product", "w_comm_score")


def hca_step_nets():
    """(params, target) of a fresh HCA net, the JAX package's
    init_hca_params from keys 1 and 2, as numpy trees."""
    from mdcommunity_tpu.models.hca import init_hca_params

    return tuple(jax.tree_util.tree_map(np.asarray, init_hca_params(jax.random.PRNGKey(k)))
                 for k in (1, 2))


def hca_port_step(params, target, c, weights, opts, dtype, optimizer=None):
    """The port's HCA train_step in `dtype` on step_case `c`, under
    gate_terms; returns (outputs, the net, the gate_terms)."""
    from mdcommunity_tpu_torch.models.net import from_jax_params
    from mdcommunity_tpu_torch.rl import dqn

    net = from_jax_params(params, "cpu").to(dtype).requires_grad_(True)
    tnet = from_jax_params(target, "cpu").to(dtype)
    with gate_terms(net) as terms:
        out = dqn.train_step(net, tnet, optimizer, **port_step_args(c, weights, dtype),
                             variant="hca", **opts)
    return out, net, terms
