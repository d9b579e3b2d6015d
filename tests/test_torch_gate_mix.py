"""The layer gate's mixture (models/net.mix_layers, MixLayers) and the
accuracy of its gradient.

Both packages mix the two layers' Q as w_0·q_0 + w_1·q_1.  Autograd's
gradient of that product form reaches the gate's logits through the
softmax as w_0·w_1·(Σ g·q_0 − Σ g·q_1): two row sums of nearly equal terms
whose f32 difference loses most of its digits.  The port's MixLayers keeps
the product form's bits and gives w the gradient (Σ g·(q_0 − q_1), 0),
which the softmax maps to the same logit gradient in exact arithmetic.
These tests show the product form's fault and its repair against float64:

* MixLayers' forward and its gradients for q_0 and q_1 are the product
  form's bits, its logits' gradient equal in float64;
* on near-equal layers the product form's f32 ∂L/∂s is far from float64,
  MixLayers' within f32 rounding;
* banded_train_loss at chip_smoke.py's rehearsal of the multi-process
  phase (2,048 nodes, 16 actions, the unit-cost checkpoint): every f32
  gradient leaf within tests/gradient_rules.py's rule from the float64
  loss, and with the product form w_layer1 and w_layer2 outside it.
"""

import numpy as np
import pytest
import torch
from gradient_rules import gate_terms, leaf_tolerances
from torch_one_thread import one_torch_thread  # noqa: F401

from mdcommunity_tpu_torch import multihost_smoke as mh
from mdcommunity_tpu_torch.models import net as tnet


def product_form(w, q_layers):
    return w[0][..., None] * q_layers[0] + w[1][..., None] * q_layers[1]


def _near_equal_layers(dtype, seed=0, rows=4096):
    rng = np.random.default_rng(seed)
    q1 = rng.uniform(0.5, 1.5, rows)
    q0 = q1 + 1e-5 * rng.standard_normal(rows)
    g = rng.standard_normal(rows)
    s = np.array([0.3, -0.2])
    # f32 values in both dtypes: the float64 run sees the f32 run's inputs
    return [torch.tensor(x.astype(np.float32), dtype=dtype) for x in (s, q0, q1, g)]


def _gate_grad(mix, dtype):
    s, q0, q1, g = _near_equal_layers(dtype)
    s.requires_grad_(True)
    (torch.sum(g * mix(torch.softmax(s, dim=0), [q0, q1]))).backward()
    return s.grad.double()


def test_mix_layers_keeps_the_product_forms_bits():
    s, q0, q1, g = _near_equal_layers(torch.float32)
    outs = []
    for mix in (tnet.mix_layers, product_form):
        qs = [q0.clone().requires_grad_(), q1.clone().requires_grad_()]
        out = mix(torch.softmax(s, dim=0), qs)
        torch.sum(g * out).backward()
        outs.append((out.detach(), qs[0].grad, qs[1].grad))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_gate_gradient_f32_against_f64():
    """∂L/∂s of L = Σ g·mix(softmax(s), q) on 4,096 rows whose layers'
    Q differ by 1e-5: the product form's f32 gradient is off by more than
    1e-3 of the float64 one, mix_layers' by less than 1e-5."""
    ref = _gate_grad(tnet.mix_layers, torch.float64)
    assert torch.allclose(ref, _gate_grad(product_form, torch.float64), rtol=1e-9, atol=0)
    scale = ref.abs().max().item()
    assert (_gate_grad(product_form, torch.float32) - ref).abs().max().item() > 1e-3 * scale
    assert (_gate_grad(tnet.mix_layers, torch.float32) - ref).abs().max().item() < 1e-5 * scale


def _rehearsal_loss_grads(dtype):
    """banded_train_loss's gradients at multihost_smoke's gp phase draws on
    chip_smoke.py's rehearsal build, in `dtype` (float64: with gate_terms'
    sums)."""
    banded, _ = mh.band_setup(dict(kind="synth", n=2048), "cpu")
    pad_n, n = banded.pad_n, banded.n_nodes
    rng = np.random.default_rng(3)   # phase_gp's draws, in its order
    rng.standard_normal((pad_n, 64))
    rng.random(pad_n)
    rng.random(pad_n)
    rng.standard_normal((pad_n, 64))
    covered = rng.random(pad_n) < 0.05
    covered[n:] = True
    acts = rng.choice(np.flatnonzero(~covered[:n]), 16, replace=False)
    tgts = (0.1 * rng.standard_normal(len(acts)) - 0.05).astype(np.float32)
    net = mh._net({}, "cpu").to(dtype).requires_grad_(True)
    with gate_terms(net) as terms:
        tnet.banded_train_loss(net, banded, torch.from_numpy(covered), torch.from_numpy(acts),
                               torch.from_numpy(tgts).to(dtype)).backward()
    return {k: p.grad.double().numpy() for k, p in net.named_parameters()}, terms.sums()


@pytest.fixture(scope="module")
def referee():
    grads, terms = _rehearsal_loss_grads(torch.float64)
    return grads, leaf_tolerances(grads, terms)


@pytest.mark.parametrize("form", ["mix_layers", "product"])
def test_banded_loss_gate_leaves_against_f64(referee, monkeypatch, form):
    ref, tols = referee
    if form == "product":
        monkeypatch.setattr(tnet, "mix_layers", product_form)
    got, _ = _rehearsal_loss_grads(torch.float32)
    worst = {k: float(np.abs(got[k] - ref[k]).max() / tols[k]) for k in ref}
    if form == "mix_layers":
        assert max(worst.values()) <= 1.0, worst
    else:
        assert worst["w_layer1"] > 1.0 and worst["w_layer2"] > 1.0, worst
        assert max(v for k, v in worst.items() if not k.startswith("w_layer")) <= 1.0, worst
