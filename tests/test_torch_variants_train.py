"""CE's train step against the JAX package, on the CPU at a small size
with the JAX parameters carried across (from_jax_params), through
variant_cases.hold_train_step: loss, mse and TD errors at rtol 1e-5, the
Laplacian term as tests/test_torch_dqn.py holds it, the gradients under
tests/gradient_rules.py's rule (GRAD_TOL of each leaf's max|grad| with
LEAF_FLOOR, as for unit cost; the fusion gate's bias logis_b, which
cancels to ~1e-4 of its terms' absolute sum, also TERMS_TOL of that sum),
in the plain, double-DQN, Huber and IS-weight cases.  CE's environment terms are held in
tests/test_torch_variants_env.py, its agent in tests/test_torch_ce_agent.py,
the fusion modes in tests/test_torch_fusion_train.py.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
from torch_one_thread import one_torch_thread  # noqa: E402,F401
from variant_cases import hold_train_step, step_case  # noqa: E402

from mdcommunity_tpu.models import net as jnet  # noqa: E402

CASES = {
    "plain": {},
    "double_dqn": dict(use_double_dqn=True),
    "huber": dict(use_huber=True),
    "is_weights": dict(weights=True),
}


@pytest.fixture(scope="module")
def ce_case():
    params = jax.tree_util.tree_map(
        np.asarray, jnet.init_params(jax.random.PRNGKey(1), node_feat_dim=3, w_init_std=0.3))
    target = jax.tree_util.tree_map(
        np.asarray, jnet.init_params(jax.random.PRNGKey(2), node_feat_dim=3, w_init_std=0.3))
    return params, target, step_case("ce")


@pytest.mark.parametrize("case", list(CASES))
def test_ce_train_step_matches_jax(ce_case, case):
    params, target, c = ce_case
    opts = dict(CASES[case])
    weights = opts.pop("weights", False)
    assert c["tg"].node_feat.abs().sum() > 0 and c["tg"].boundary.any()
    hold_train_step(params, target, c, "ce", weights, opts)
