"""K2's bf16 epilogue (f32_epi=False): the port's fused forward against the
JAX package's Pallas engine, net_packed.banded_test_forward_packed(
fuse_sage=True, f32_epi=False) in interpret mode, at N = 1,024 in both
precise modes; and the kernel's plain version against its definition.

Tolerance: tests/test_torch_fast.py's assert_fast_q_close (every live node
within two bf16 ulps of max|Q|, 99% within 1e-5).  Both sides round the
epilogue's dot operands to bf16 at the same points, so the only difference
is the f32 summation order before a rounding: an operand within that noise
of a bf16 rounding boundary moves by one ulp, which the fast eval's
tolerance already covers for the same reason.  In the precise mode the
pooled sums are of f32 operands, inexact in either order, so such flips are
more frequent than in the fast mode, whose sums of a few bf16 products are
mostly exact; one flip reaches its node's neighbourhood through the later
rounds, about 1% of this 919-node graph, so there 98% must be within 1e-5
(PRECISE_SHARE)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdcommunity_tpu.models.net_packed import banded_test_forward_packed  # noqa: E402
from mdcommunity_tpu_torch.models.checkpoint import load_model  # noqa: E402
from mdcommunity_tpu_torch.models.net import banded_test_forward  # noqa: E402
from mdcommunity_tpu_torch.ops import band_kernels as bk  # noqa: E402
from mdcommunity_tpu_torch.ops import dense_band as tdb  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

from test_torch_fast import CKPT, assert_fast_q_close  # noqa: E402
from test_torch_fast_packed import state  # noqa: E402,F401

PRECISE_SHARE = 0.98


@pytest.mark.parametrize("precise", [True, False])
def test_bf16_epilogue_forward_matches_packed_engine(state, precise):  # noqa: F811
    params, jb, pks, tb, covered = state
    fwd = jax.jit(lambda p, b, k, c: banded_test_forward_packed(
        p, b, k, c, interpret=True, fuse_sage=True, f32_epi=False, precise=precise))
    ref = np.asarray(fwd(params, jb, pks, jnp.asarray(covered)))
    net = load_model(CKPT, device="cpu")
    cov = torch.from_numpy(covered)
    q = banded_test_forward(net, tb, cov, fuse_sage=True, precise=precise, f32_epi=False)
    err = assert_fast_q_close(q, ref, PRECISE_SHARE if precise else 0.99)
    print(f"precise={precise} f32_epi=False: max err {err:.3e} of max|Q|")
    # and it is not the f32 epilogue
    f32 = banded_test_forward(net, tb, cov, fuse_sage=True, precise=precise)
    fin = torch.isfinite(f32)
    assert (q[fin] - f32[fin]).abs().max() > 1e-4 * f32[fin].abs().max()


@pytest.mark.parametrize("precise,store", [(True, "float32"), (False, "float32"),
                                           (False, "bfloat16")])
def test_bf16_epilogue_plain_version_rounds_the_dot_operands(precise, store):
    rng = np.random.default_rng(0)
    n, D = 1024, 64
    src = rng.integers(0, n, 4 * n)
    dst = (src + rng.integers(-40, 40, 4 * n)) % n
    keep = src != dst
    ss = np.concatenate([src[keep], dst[keep]])
    dd = np.concatenate([dst[keep], src[keep]])
    g = tdb.build_dense_band(ss, dd, n, device="cpu")
    live = torch.from_numpy((rng.random(n) > 0.1).astype(np.float32))
    h = torch.nn.functional.normalize(torch.from_numpy(
        rng.standard_normal((n, D)).astype(np.float32)), dim=-1).to(getattr(torch, store))
    aw, bw = (torch.from_numpy((rng.standard_normal((D, D)) / 8).astype(np.float32))
              for _ in range(2))
    sub = tdb.mirror_sub(g, live, h, precise)
    got = bk.sage_step(g, live, live, h, sub, aw, bw, precise, f32_epi=False)
    pool = bk._band_plain(g, live, live, h, sub, precise)   # f32, before storage rounding

    def r(x):
        return x.float().to(torch.bfloat16).double()

    z = torch.relu(r(pool) @ r(aw) + r(h) @ r(bw))
    want = z / z.square().sum(-1, keepdim=True).clamp(min=1e-24).sqrt()
    tol = 1e-5 if store == "float32" else 2 ** -8   # f32 sums; bf16 storage
    assert (got.double() - want).abs().max() <= tol
    assert got.dtype == h.dtype


def test_bf16_epilogue_needs_the_fused_step(state):  # noqa: F811
    tb, covered = state[3], state[4]
    with pytest.raises(ValueError, match="fuse_sage"):
        banded_test_forward(load_model(CKPT, device="cpu"), tb, torch.from_numpy(covered),
                            f32_epi=False)
