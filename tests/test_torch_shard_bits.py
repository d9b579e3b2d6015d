"""The sharded forward's Q bit for bit against the unsharded one, by the
row-chunked dense products (utils/device.row_matmul).

cuBLAS picks its f32 GEMM kernel by the row count, so the card gave a
gp = 4 shard's dense layers other last bits than the whole graph's at 2^20
nodes.  Every product of node rows by a weight now runs over fixed chunks
of ROW_CHUNK rows.  With the constant made small (256 and 1,024 rows at
pad_n 4,096, gp = 4: a shard is 4 chunks, or one) a TorchDispatchMode
records each row product's (M, K, N): the sharded and the unsharded
forward must issue the same multiset of them, Q must be bit-equal on the
CPU, and Q must still match the JAX package's f32 forward."""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdcommunity_tpu.cli import _load_params as jax_load_params  # noqa: E402
from mdcommunity_tpu.graphs.banded import build_banded_duplex as jax_build  # noqa: E402
from mdcommunity_tpu.models.net import banded_test_forward as jax_forward  # noqa: E402
from mdcommunity_tpu_torch.graphs.banded import build_banded_duplex  # noqa: E402
from mdcommunity_tpu_torch.large_graph_demo import synth_duplex_edges  # noqa: E402
from mdcommunity_tpu_torch.models.checkpoint import load_model  # noqa: E402
from mdcommunity_tpu_torch.models.net import banded_test_forward  # noqa: E402
from mdcommunity_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from mdcommunity_tpu_torch.utils import device as dev  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

CKPT = "models_tpu/unit_cost_full_r4/best_model.ckpt"
ATOL = 1e-5  # f32 on both sides; Q values are O(0.1) (tests/test_torch_sharded.py)
GP = 4


class RowProducts(TorchDispatchMode):
    """Records (M, K, N) of every matrix product (aten's mm, also inside
    utils/device.RowMatmul) whose left operand has more than two rows: the
    node-row products (a graph's own vectors, one row a layer, are left
    out)."""

    def __init__(self):
        super().__init__()
        self.shapes = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket is torch.ops.aten.mm:
            a, b = args[:2]
            if a.shape[0] > 2:
                self.shapes[(a.shape[0], a.shape[1], b.shape[1])] += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def case():
    """n = 4,096 (pad_n 4,096, 16 blocks), the unit-cost checkpoint, a 10%
    cover, and the JAX package's f32 XLA forward on it."""
    n = 4096
    rng = np.random.default_rng(7)
    e0, e1 = synth_duplex_edges(n, 6, rng)
    jb, _, _ = jax_build(n, e0, e1)
    tb, _, _ = build_banded_duplex(n, e0, e1, device="cpu")
    assert tb.pad_n == 4096 and tb.spill_free
    covered = (rng.random(tb.pad_n) < 0.1) | ~tb.node_mask.numpy()
    ref = jax.jit(lambda p, b, c: jax_forward(p, b, c, precise=True))(
        jax_load_params(CKPT), jb, jnp.asarray(covered))
    return load_model(CKPT, device="cpu"), tb, torch.from_numpy(covered), np.asarray(ref)


def _forward(net, tb, covered, mesh):
    with RowProducts() as rec:
        q = banded_test_forward(net, tb, covered, mesh=mesh)
    return q, rec.shapes


@pytest.mark.parametrize("chunk", [256, 1024])
def test_sharded_and_unsharded_issue_the_same_row_products(case, monkeypatch, chunk):
    net, tb, covered, _ = case
    monkeypatch.setattr(dev, "ROW_CHUNK", chunk)
    _, whole = _forward(net, tb, covered, None)
    _, sharded = _forward(net, tb, covered, make_mesh(GP, "cpu"))
    assert whole == sharded
    assert max(m for m, _, _ in whole) == chunk  # every node-row product chunked
    # embedding, 3 rounds x 3 products, fusion 4, Q head 2: per layer and chunk
    assert sum(whole.values()) == 2 * (1 + 3 * 3 + 3 + 2) * tb.pad_n // chunk


def test_unchunked_products_differ_in_rows(case):
    """Without chunking (the default constant is above pad_n) each shard's
    products have a quarter of the whole graph's rows: the shapes the card's
    GEMM choice follows."""
    net, tb, covered, _ = case
    _, whole = _forward(net, tb, covered, None)
    _, sharded = _forward(net, tb, covered, make_mesh(GP, "cpu"))
    assert {m for m, _, _ in whole} == {tb.pad_n}
    assert {m for m, _, _ in sharded} == {tb.pad_n // GP}


@pytest.mark.parametrize("chunk", [256, 1024])
def test_sharded_q_bit_equal_and_matches_jax(case, monkeypatch, chunk):
    net, tb, covered, ref = case
    monkeypatch.setattr(dev, "ROW_CHUNK", chunk)
    q = banded_test_forward(net, tb, covered)
    assert torch.equal(banded_test_forward(net, tb, covered, mesh=make_mesh(GP, "cpu")), q)
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(q.numpy()), fin)
    np.testing.assert_allclose(q.numpy()[fin], ref[fin], rtol=0, atol=ATOL)


def test_row_matmul_chunks_rows_and_gradients(monkeypatch):
    """Each chunk's rows equal the one product's on the CPU, and the
    gradients through the chunks match the one product's (dw sums the
    chunks' partials: to f32 rounding)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1000, 64), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 48), dtype=np.float32))
    g = torch.from_numpy(rng.standard_normal((1000, 48), dtype=np.float32))
    monkeypatch.setattr(dev, "ROW_CHUNK", 256)
    xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = dev.row_matmul(xs, ws)
    assert y.shape == (1000, 48)
    np.testing.assert_allclose(y.detach().numpy(), (x @ w).numpy(), rtol=0, atol=1e-5)
    assert torch.equal(y[:256], x[:256] @ w)
    y.backward(g)
    np.testing.assert_allclose(xs.grad.numpy(), (g @ w.T).numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ws.grad.numpy(), (x.T @ g).numpy(), rtol=0, atol=1e-3)
