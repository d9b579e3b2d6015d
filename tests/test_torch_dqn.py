"""The port's DQN train step against the JAX package's, on the CPU at a
small size with the JAX parameters carried across
(models/net.from_jax_params).

* train_step: the same batch and parameters give the same loss, mse,
  Laplacian term and TD errors at f32 tolerance (rtol 1e-5; both packages
  compute in f32, summing in other orders, and the port's virtual-node
  pool is an f64 sum; the Laplacian term is a difference of two terms of
  size 2 a layer, so it is held to 1e-5 of those), and the same gradients
  to GRAD_TOL of each leaf's max|grad| (a gradient sums over the batch's
  nodes in an order of its own; a leaf that cancels to below LEAF_FLOOR of
  the largest leaf is held against that floor), in five cases: plain,
  double DQN, Huber, IS weights, degree cost.
The Adam update is held to optax's in tests/test_torch_dqn_agent.py.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from torch_one_thread import one_torch_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from mdcommunity_tpu.env.env import batched_reset as jax_reset  # noqa: E402
from mdcommunity_tpu.env.env import batched_step as jax_step  # noqa: E402
from mdcommunity_tpu.graphs.duplex import stack_graphs as jax_stack  # noqa: E402
from mdcommunity_tpu.graphs.gmm import generate_pool as jax_pool  # noqa: E402
from mdcommunity_tpu.models.net import init_params  # noqa: E402
from mdcommunity_tpu.rl import dqn as jdqn  # noqa: E402
from mdcommunity_tpu_torch.env.env import batched_reset, batched_step  # noqa: E402
from mdcommunity_tpu_torch.graphs.duplex import stack_graphs  # noqa: E402
from mdcommunity_tpu_torch.graphs.gmm import generate_pool  # noqa: E402
from mdcommunity_tpu_torch.models.net import from_jax_params  # noqa: E402
from mdcommunity_tpu_torch.rl import dqn  # noqa: E402

PAD_N, PAD_E, B = 32, 256, 8
RTOL = 1e-5
GRAD_TOL = 1e-4  # of each leaf's max |grad|, or of LEAF_FLOOR x the largest leaf's
# a leaf whose gradient cancels across the batch (the fusion gate's bias
# logis_b: ~1e-8 against leaves of 1e-2 and more) keeps the rounding of its
# terms, not of its sum: it is held against about the f32 rounding of the
# largest leaf; every other leaf stays at GRAD_TOL of its own max
LEAF_FLOOR = 1e-6


def _pools(degree_cost, count=B, seed=3):
    args = (count, 16, 24, PAD_N, PAD_E, degree_cost)
    return (jax_stack(jax_pool(np.random.default_rng(seed), *args)),
            stack_graphs(generate_pool(np.random.default_rng(seed), *args, device="cpu")))


def _walk(jg, tg, steps, rng):
    """Both packages' states after `steps` random valid actions from reset,
    and the actions taken (the same in both)."""
    js, ts = jax_reset(jg), batched_reset(tg)
    acts = []
    for _ in range(steps):
        q = np.where(ts.covered.numpy() | ~tg.node_mask.numpy(), -1.0, rng.random((B, PAD_N)))
        a = np.argmax(q, axis=1)
        js, _ = jax_step(jg, js, jnp.asarray(a))
        ts, _ = batched_step(tg, ts, torch.from_numpy(a))
        acts.append(a)
    return js, ts, acts


def _grab():
    """An optax transformation whose new state is the gradient: the JAX
    train_step then returns its gradients as opt_state, its params unmoved."""
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)  # noqa: E731
    return optax.GradientTransformation(zeros, lambda g, s, p=None: (zeros(g), g))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


CASES = {
    "plain": {},
    "double_dqn": dict(use_double_dqn=True),
    "huber": dict(use_huber=True),
    "is_weights": dict(weights=True),
    "degree_cost": dict(variant="degree_cost"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(case):
    opts = dict(CASES[case])
    weights = opts.pop("weights", False)
    variant = opts.get("variant", "unit_cost")
    jg, tg = _pools(variant == "degree_cost")
    # s_t after 3 steps of a seeded walk, its action the walk's 4th, and
    # s_{t+n} after 5 steps
    js0, ts0, _ = _walk(jg, tg, 3, np.random.default_rng(5))
    a_t = _walk(jg, tg, 4, np.random.default_rng(5))[2][3]
    js1, ts1, _ = _walk(jg, tg, 5, np.random.default_rng(5))
    params = init_params(jax.random.PRNGKey(1), w_init_std=0.3)
    target = init_params(jax.random.PRNGKey(2), w_init_std=0.3)
    rng = np.random.default_rng(6)
    rewards = -rng.random(B).astype(np.float32)
    terminal = rng.random(B) < 0.3
    iw = rng.random(B).astype(np.float32) if weights else None

    optimizer = _grab()
    _, grads, jloss, jmse, jrecon, jtd = jdqn.train_step(
        params, target, optimizer.init(params), jg, js0.covered, js0.sever,
        jnp.asarray(a_t), jnp.asarray(rewards), js1.covered, js1.sever, jnp.asarray(terminal),
        is_weights=None if iw is None else jnp.asarray(iw), optimizer=optimizer, **opts)

    net = from_jax_params(params, "cpu").requires_grad_(True)
    tnet = from_jax_params(target, "cpu")
    loss, mse, recon, td = dqn.train_step(
        net, tnet, None, tg, ts0.covered, ts0.sever, torch.from_numpy(a_t),
        torch.from_numpy(rewards), ts1.covered, ts1.sever, torch.from_numpy(terminal),
        is_weights=None if iw is None else torch.from_numpy(iw), **opts)
    for name, got, ref in (("loss", loss, jloss), ("mse", mse, jmse)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, err_msg=name)
    # recon = Σ_l 2·(quad_l - cross_l)/|E_l| cancels: with unit rows each
    # layer's 2·quad_l/|E_l| is 2, so its f32 error is relative to 2 a layer
    np.testing.assert_allclose(recon.numpy(), np.asarray(jrecon), rtol=RTOL, atol=4 * RTOL)
    jtd = np.asarray(jtd)
    np.testing.assert_allclose(td.numpy(), jtd, rtol=RTOL, atol=RTOL * np.abs(jtd).max())
    ref = _flat(grads)
    got = {k: p.grad.numpy() for k, p in net.named_parameters()}
    assert set(got) == set(ref)
    top = max(np.abs(v).max() for v in ref.values())
    for k in ref:
        scale = np.abs(ref[k]).max()
        assert np.abs(got[k] - ref[k]).max() <= GRAD_TOL * max(scale, LEAF_FLOOR * top), k
