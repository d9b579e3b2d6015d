"""HCA's training against the JAX package, on the CPU at a small size with
the JAX parameters carried across (from_jax_params): the train step (one
Adam update, the agent, its rollout and `cli train --variant hca`:
tests/test_torch_hca_agent.py; the bridge bonus:
tests/test_torch_variants_env.py).  The rule's constants live in
tests/gradient_rules.py.

Why HCA needs its own tolerances.  The decoder leaves most nodes of a
freshly initialised net unselected, at -1e9·w (w the layer gate's softmax
weight), so the TD errors of a batch are ~1e8-1e9, the loss ~1e17 and the
gradient leaves ~1e7-1e17.  Both packages compute in f32:

* The TD errors.  q = -1e9·w carries the f32 error of the gate's two
  128-term logit sums: measured against the port run in float64 (the
  referee, the same code on f64 operands), JAX's sentinel TDs are off by up
  to 1.5e-6 relative and the port's by 6.3e-7, a few hundred where the f32
  spacing is 32-64; and a reward below that spacing is lost in r + max_q
  (one double-DQN TD is 0 in both f32 packages and -0.67 in f64).  So each
  TD is held to HCA_TD_TOL = 1e-5 of its operands' magnitude, max(|Q(s, a)|,
  |target|, 1): ~10 spacings at 1e9, 1e-5 absolute for a selected node.
  The loss (a mean of the squares) is held to rtol 1e-5.
* The gradients.  Each leaf is held to its OWN max|grad| (the leaves span
  ten decades; a rule against the largest leaf would hide w_micro_score
  and the SAGE weights): both f32 packages within GRAD_TOL = 1e-4 of it
  from the referee's gradient (measured over the four cases: at most
  8.8e-5 in JAX and 4.2e-5 in the port, fusion.bias with IS weights).
  One leaf is a difference of near-equal terms: the fusion
  gate's bias logis_b, Σ over every node and community row of ∂L/∂z (z the
  gate's logits), terms of either sign whose absolute sum is ~8e4 times
  the sum.  Its errors are 5e-4-2.5e-3 of its own max in both packages,
  and at most 3e-8 of Σ|∂L/∂z|: it is held, as every gate leaf is, by
  tests/gradient_rules.py (TERMS_TOL = 2e-6 of its terms' absolute sum,
  which gate_terms collects; the test checks that the hook saw every
  term).  The leaves the loss does not reach (h1_weight, h2_weight,
  cross_product, and w_comm_score, behind the decoder's argsort) are 0 in
  all three.
* Nothing in the loss is clipped, rescaled or masked: the sentinel is
  trained on as it stands, as in the JAX package.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from torch_one_thread import one_torch_thread  # noqa: E402,F401
from gradient_rules import HCA_TD_TOL, hca_leaf_tolerances  # noqa: E402
from variant_cases import (  # noqa: E402
    HCA_ZERO_LEAVES,
    TRAIN_B,
    flat,
    grab,
    hca_port_step,
    hca_step_nets,
    jax_step_args,
    step_case,
)

from mdcommunity_tpu.rl import dqn as jdqn  # noqa: E402

CASES = {
    "plain": {},
    "double_dqn": dict(use_double_dqn=True),
    "huber": dict(use_huber=True),
    "is_weights": dict(weights=True),
}


@pytest.fixture(scope="module")
def nets():
    return hca_step_nets() + (step_case("hca"),)


@pytest.mark.parametrize("case", list(CASES))
def test_hca_train_step_matches_jax_with_f64_referee(nets, case):
    params, target, c = nets
    opts = dict(CASES[case])
    weights = opts.pop("weights", False)
    args, kw = jax_step_args(c, weights)
    o = grab()
    _, jgrads, jloss, jmse, jrecon, jtd = jdqn.train_step(
        params, target, o.init(params), *args, variant="hca", optimizer=o, **kw, **opts)
    (loss, mse, recon, td), net, _ = hca_port_step(params, target, c, weights, opts,
                                                   torch.float32)
    (loss64, _, _, td64), net64, terms = hca_port_step(params, target, c, weights, opts,
                                                       torch.float64)
    assert abs(float(jloss)) > 1e8  # the sentinel is in the loss (Huber: linear in it)
    for name, got, ref in (("loss", loss, jloss), ("mse", mse, jmse)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(recon.numpy(), np.asarray(jrecon), rtol=1e-5, atol=4e-5)
    np.testing.assert_allclose(loss.numpy(), loss64.numpy(), rtol=1e-5)

    # the TDs against their operands' magnitude
    q_sa = np.asarray(jdqn.predict_q(params, c["jg"], c["js0"].covered, c["js0"].sever,
                                     "hca"))[np.arange(TRAIN_B), c["a_t"]].astype(np.float64)
    jtd = np.asarray(jtd, np.float64)
    mag = np.maximum(np.maximum(np.abs(q_sa), np.abs(q_sa + jtd)), 1.0)
    assert mag.max() > 1e8
    for name, t in (("port", td.double().numpy()), ("f64", td64.numpy())):
        assert (np.abs(t - jtd) <= HCA_TD_TOL * mag).all(), (name, t, jtd)

    ref = flat(jgrads)
    got = {k: p.grad.double().numpy() for k, p in net.named_parameters()}
    g64 = {k: p.grad.numpy() for k, p in net64.named_parameters()}
    assert set(got) == set(ref) == set(g64)
    # the hook saw every term of the gate leaves, and logis_b's cancel
    for k, s in terms.sums(signed=True).items():
        np.testing.assert_allclose(s, g64[k], rtol=1e-9, atol=1e-9 * np.abs(g64[k]).max(),
                                   err_msg=k)
    terms = terms.sums()
    assert terms["fusion.logis_b"][0] > 100 * abs(g64["fusion.logis_b"][0])
    tols = hca_leaf_tolerances(g64, terms)
    for k in ref:
        scale = np.abs(g64[k]).max()
        if k in HCA_ZERO_LEAVES:
            assert scale == 0 and not np.abs(ref[k]).any() and not np.abs(got[k]).any(), k
            continue
        tol = tols[k]
        for name, g in (("port", got[k]), ("jax", ref[k].astype(np.float64))):
            assert np.abs(g - g64[k]).max() <= tol, (name, k, np.abs(g - g64[k]).max() / scale)
