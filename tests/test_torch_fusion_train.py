"""The fusion modes and `cli check-features` against the JAX package, on
the CPU at a small size.

* Every fusion mode of FUSION_INITS: init_params(fusion=) gives the JAX
  package's keys and shapes (the additive modes' trans = I, bias = 0, the
  attention leaves within their xavier bound), and one unit-cost
  train_step with the JAX parameters of that mode matches JAX's under
  variant_cases.hold_train_step's rules (the layer gate's w_layer1 and
  w_layer2, exactly 0 in exact arithmetic, by their terms), with the
  attention leaves' gradients exactly 0 in both (the three additive
  modes' weights cancel at two layers, so the loss does not reach them).
* `cli check-features` prints the JAX CLI's lines.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from torch_one_thread import one_torch_thread  # noqa: E402,F401
from variant_cases import flat, hold_train_step, step_case  # noqa: E402

from mdcommunity_tpu.models import net as jnet  # noqa: E402
from mdcommunity_tpu.models.fusion import FUSION_INITS as JAX_FUSION  # noqa: E402
from mdcommunity_tpu_torch.models.fusion import FUSION_INITS  # noqa: E402
from mdcommunity_tpu_torch.models.net import init_params  # noqa: E402

ATTENTION = ("attention", "cos_attention", "sem_W", "sem_b", "sem_q")


@pytest.fixture(scope="module")
def unit_case():
    return step_case("unit_cost")


@pytest.mark.parametrize("fusion", list(JAX_FUSION))
def test_fusion_mode_init_and_train_step_match_jax(unit_case, fusion):
    """init_params(fusion=) against the JAX package's (keys, shapes; trans =
    I and bias = 0; the xavier bounds), then one unit-cost train_step with
    the JAX parameters of that mode, the attention leaves' gradients
    exactly 0 in both."""
    assert set(FUSION_INITS) == set(JAX_FUSION)
    jp = jnet.init_params(jax.random.PRNGKey(1), w_init_std=0.3, fusion=fusion)
    tp = init_params(torch.Generator().manual_seed(0), w_init_std=0.3, fusion=fusion)
    jf, tf = flat(jp), flat(tp)
    assert {k: v.shape for k, v in jf.items()} == {k: v.shape for k, v in tf.items()}
    np.testing.assert_array_equal(tf["fusion.trans"], np.eye(64, dtype=np.float32))
    assert not tf["fusion.bias"].any()
    for k in jf:
        if k.split(".")[-1] in ATTENTION:
            fan_in, fan_out = (jf[k].shape[-2], jf[k].shape[-1])
            bound = 1.414 * np.sqrt(6.0 / (fan_in + fan_out))
            assert np.abs(tf[k]).max() <= bound and np.abs(tf[k]).max() > bound / 2, k
    params = jax.tree_util.tree_map(np.asarray, jp)
    target = jax.tree_util.tree_map(
        np.asarray, jnet.init_params(jax.random.PRNGKey(2), w_init_std=0.3, fusion=fusion))
    got = hold_train_step(params, target, unit_case, "unit_cost", False, {})
    for k, g in got.items():
        if k.split(".")[-1] in ATTENTION:
            assert not g.any(), k


@pytest.mark.parametrize("argv", [["--variant", "ce"],
                                  ["--variant", "ce", "--feature", "participation"],
                                  ["--variant", "hca", "--size", "40", "--seed", "2"]])
def test_cli_check_features_matches_jax(argv, capsys):
    from mdcommunity_tpu.cli import main as jax_main
    from mdcommunity_tpu_torch.cli import main

    jax_main(["check-features", "--cpu"] + argv)
    ref = capsys.readouterr().out
    main(["check-features", "--cpu"] + argv)
    assert capsys.readouterr().out == ref
    assert "within [0,1]: True" in ref
