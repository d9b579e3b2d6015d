"""The train step's gradient rules, one copy for the CPU tests against the
JAX package (tests/variant_cases.py, tests/test_torch_hca_*.py,
tests/test_torch_banded_variants_train.py) and for chip_smoke.py's card
against the CPU.  It imports torch only.

A gradient leaf is a sum over a batch's rows, which each engine adds in an
order of its own, so two f32 engines agree to about the f32 rounding of
the sum's terms, not of the sum:

* every leaf is held to GRAD_TOL of its own max|grad|, or of LEAF_FLOOR of
  the largest leaf's where it is smaller (tests/test_torch_dqn.py's rule;
  HCA, held against a float64 referee, uses no floor: its leaves span ten
  decades);
* a gate leaf may also take TERMS_TOL of the absolute sum of its terms,
  Σ|x|ᵀ|∂L/∂(x W)| for a weight W and Σ|∂L/∂(x W)| for the bias added to
  x W, which gate_terms collects.  These leaves are sums whose terms
  cancel: the fusion gate's bias logis_b (∂L/∂z over every row's gate
  logit, 1e-5 to 3e-4 of Σ|terms|) and the layer gate's w_layer1 and
  w_layer2 (exactly 0 in exact arithmetic under the additive fusion modes,
  whose two layers' virtual rows are equal; 7e-4 to 2e-3 of Σ|terms| in
  the banded fit).  Each term carries the f32 error of the forward pass
  behind it, so the sum is known to a few f32 ulps of Σ|terms|: measured
  against the JAX package and a float64 referee on the CPU, the errors are
  at most 7.4e-7 of it (CE's and unit cost's train step in every fusion
  mode, the banded degree-cost and CE loss, HCA's train step).  TERMS_TOL
  is 2e-6, about 17 ulps.

The layer gate's own mixture once broke this: autograd's gradient of the
product form w_0·q_0 + w_1·q_1 reaches ∂L/∂s through the softmax as a
difference of two row sums of nearly equal terms, which gate_terms does
not see, and on a 2^18-node build with 262 actions the f32 gradients of
w_layer1 and w_layer2 sat 15 and 29 times outside this rule from a float64
referee (the cross-process loss's, adding the rows in two groups, happened
to sit inside).  The port's mixture (models/net.MixLayers) keeps the
product form's bits and gives the softmax one row sum of small terms, and
both gradients meet the rule against the referee.
"""

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

GRAD_TOL = 1e-4    # of a gradient leaf's own max|grad|
LEAF_FLOOR = 1e-6  # of the largest leaf's max|grad|: the least scale of a leaf
TERMS_TOL = 2e-6   # of a gate leaf's Σ|terms|
HCA_TD_TOL = 1e-5  # of an HCA TD's operands' magnitude, max(|Q(s, a)|, |target|, 1)

# the weights whose right-hand matmuls gate_terms follows, and the leaves
# each gives terms for: (the weight's, the bias added to its product's)
GATE_WEIGHTS = {"fusion.logis_w": (None, "fusion.logis_b"), "w_layer1": ("w_layer1", None),
                "w_layer2": ("w_layer2", None)}


class gate_terms(TorchFunctionMode):
    """Inside `with gate_terms(net) as terms:`, each product x @ W of a gate
    weight W of `net` (GATE_WEIGHTS) gets a zero addend that collects
    ∂L/∂(x W) in the backward pass; the model's code runs unchanged.  After
    the backward pass, terms.sums() gives each gate leaf's Σ|terms| by
    parameter name.  Products taken under no_grad (a target net's) collect
    nothing."""

    def __init__(self, net):
        super().__init__()
        params = dict(net.named_parameters())
        self.weights = {id(params[k]): k for k in GATE_WEIGHTS if k in params}
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (getattr(func, "__name__", "") in ("matmul", "__matmul__") and len(args) == 2
                and id(args[1]) in self.weights and torch.is_grad_enabled()):
            e = torch.zeros_like(out, requires_grad=True)
            self.calls.append((self.weights[id(args[1])], args[0].detach(), e))
            out = out + e
        return out

    def sums(self, signed=False):
        """{leaf: Σ|terms| as a float64 numpy array of the leaf's shape};
        signed=True: Σ terms, the leaf's gradient where gate_terms saw every
        use of its weight."""
        out = {}
        mag = (lambda t: t) if signed else torch.abs
        for name, x, e in self.calls:
            if e.grad is None:
                continue
            g = mag(e.grad.detach().double()).reshape(-1, e.shape[-1]).cpu()
            x = mag(x.double()).reshape(-1, x.shape[-1]).cpu()
            w_leaf, b_leaf = GATE_WEIGHTS[name]
            for leaf, s in ((w_leaf, x.T @ g), (b_leaf, g.sum(0))):
                if leaf is not None:
                    out[leaf] = out.get(leaf, 0) + s.numpy()
        return out


def leaf_tolerances(grads, terms=None, floor=LEAF_FLOOR):
    """Each leaf's tolerance, by name, from the reference gradients `grads`
    (numpy arrays) and a gate_terms' sums: GRAD_TOL of max(its own max|grad|,
    floor x the largest leaf's), for a gate leaf the larger of that and
    TERMS_TOL of its largest Σ|terms|."""
    top = max(np.abs(g).max() for g in grads.values())
    tol = {k: GRAD_TOL * max(np.abs(g).max(), floor * top) for k, g in grads.items()}
    for k, s in (terms or {}).items():
        if k in tol:
            tol[k] = max(tol[k], TERMS_TOL * np.max(s))
    return tol


def hca_leaf_tolerances(grads, terms):
    """HCA's rule against a float64 referee's gradients `grads`: each leaf to
    GRAD_TOL of its own max|grad| (no floor), a gate leaf also to TERMS_TOL
    of its Σ|terms| (tests/test_torch_hca_train.py)."""
    return leaf_tolerances(grads, terms, floor=0.0)
