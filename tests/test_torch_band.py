"""Port's dense-band storage and band operator (kernel K1's plain version) vs
the JAX package: builds and severs exact, the operator at f32 tolerance.

The JAX package's Pallas kernel runs in interpret mode on the CPU, as its own
tests run it.  The port runs with device="cpu", so its wrappers take the
plain versions."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdcommunity_tpu.graphs.banded import build_banded_duplex as jax_build_duplex  # noqa: E402
from mdcommunity_tpu.ops import dense_band as jdb  # noqa: E402
from mdcommunity_tpu.ops.band_pallas import (  # noqa: E402
    pack_band,
    pack_rows,
    spmm_band_packed,
    unpack_rows,
)
from mdcommunity_tpu_torch.graphs.banded import build_banded_duplex  # noqa: E402
from mdcommunity_tpu_torch.large_graph_demo import synth_duplex_edges  # noqa: E402
from mdcommunity_tpu_torch.ops import dense_band as tdb  # noqa: E402
from mdcommunity_tpu_torch.ops.band_kernels import spmm_band  # noqa: E402

# both sides compute in f32; only the order of the sums differs
RTOL = ATOL = 1e-5
N, S, B = 1024, 256, 128


def _graph(kind, rng):
    """Symmetric directed edges and the mirror cap for one test graph:
    ring  - circular power-law offsets: live mirror lanes, no spill
    band  - offsets < B: everything in band, no mirror lanes
    spill - long offsets and a 4-lane mirror cap: mirror lanes and spill."""
    e = 2 * N
    src = rng.integers(0, N, e)
    if kind == "band":
        off = rng.integers(1, 64, e)
    else:
        scale = 24.0 if kind == "ring" else 96.0
        off = np.minimum((scale * (rng.pareto(2.0, e) + 1)).astype(np.int64), N // 2 - 1)
    dst = (src + off * rng.choice([-1, 1], e)) % N
    cap = 4 if kind == "spill" else 64
    return np.concatenate([src, dst]), np.concatenate([dst, src]), cap


def _builds(kind, rng):
    ss, dd, cap = _graph(kind, rng)
    jg = jdb.build_dense_band(ss, dd, None, N, S=S, B=B, max_mirror=cap)
    tg = tdb.build_dense_band(ss, dd, N, S=S, B=B, max_mirror=cap, device="cpu")
    return jg, tg, ss, dd


def _assert_same_build(jg, tg):
    np.testing.assert_array_equal(tg.base.numpy(), np.asarray(jg.base))
    assert (tg.C, tg.n_blocks, tg.pad_n) == (jg.C, jg.n_blocks, jg.pad_n)
    np.testing.assert_array_equal(tg.ccoo.d_src.numpy(), np.asarray(jg.ccoo.d_src))
    np.testing.assert_array_equal(tg.ccoo.d_dst.numpy(), np.asarray(jg.ccoo.d_dst))
    np.testing.assert_array_equal(tg.w_cov.numpy(), np.asarray(jg.w_cov))
    key = np.asarray(jg.c_usrc, np.int64) * jg.pad_n + np.asarray(jg.c_udst)
    np.testing.assert_array_equal(tg.c_key.numpy(), key)
    np.testing.assert_array_equal(tg.spill.d_src.numpy(), np.asarray(jg.spill.d_src))
    np.testing.assert_array_equal(tg.spill.d_dst.numpy(), np.asarray(jg.spill.d_dst))
    np.testing.assert_array_equal(tg.w_spill.numpy(), np.asarray(jg.w_spill))
    # the port's mirror index arrays are the JAX one-hot lanes, inverted
    lanes = np.asarray(jg.base)[:, jg.S:, jg.B:jg.B + jg.S]  # [nb, C, S]
    hot = lanes.any(-1)
    node = np.where(hot, np.arange(jg.n_blocks)[:, None] * jg.S + lanes.argmax(-1), -1)
    np.testing.assert_array_equal(tg.mirror_node.numpy(), node)
    slot = np.full((jg.n_blocks, jg.S), -1)
    b, c = np.nonzero(hot)
    slot[b, lanes.argmax(-1)[b, c]] = c
    np.testing.assert_array_equal(tg.slot_of_row.numpy(), slot)


@pytest.mark.parametrize("kind", ["ring", "band", "spill"])
def test_build_dense_band_matches(kind):
    jg, tg, _, _ = _builds(kind, np.random.default_rng(0))
    _assert_same_build(jg, tg)
    assert (tg.C > 0) == (kind != "band")
    assert (tg.spill.nnz > 0) == (kind == "spill")


def _operands(pad_n, D, rng, unit=False):
    live = (rng.random(pad_n) > 0.15).astype(np.float32)
    if unit:  # the degree pass: unit scales, [live, mask] right-hand side
        mask = np.zeros(pad_n, np.float32)
        mask[:N] = 1
        return np.ones(pad_n, np.float32), np.stack([live, mask], -1)
    return live, rng.standard_normal((pad_n, D)).astype(np.float32)


@pytest.mark.parametrize("D", [64, 2])
@pytest.mark.parametrize("kind", ["ring", "band", "spill"])
def test_spmm_band_matches_jax(kind, D):
    """spmm_dense_band (K1's plain version + spill) vs the JAX XLA engine's
    spmm_dense_band(precise=True)."""
    rng = np.random.default_rng(1)
    jg, tg, _, _ = _builds(kind, rng)
    scale, h = _operands(jg.pad_n, D, rng, unit=(D == 2))
    ref = jdb.spmm_dense_band(jg, jnp.asarray(scale), jnp.asarray(scale),
                              jnp.asarray(h), precise=True)
    t_scale = torch.from_numpy(scale)
    out = tdb.spmm_dense_band(tg, t_scale, t_scale, torch.from_numpy(h))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("D", [64, 2])
@pytest.mark.parametrize("kind", ["ring", "band", "spill"])
def test_spmm_band_matches_pallas_packed(kind, D):
    """The same operator vs the JAX package's Pallas kernel K1
    (spmm_band_packed, interpret mode, precise), unpacked."""
    rng = np.random.default_rng(2)
    jg, tg, _, _ = _builds(kind, rng)
    scale, h = _operands(jg.pad_n, D, rng, unit=(D == 2))
    pk = pack_band(jg, G=2)
    ref = unpack_rows(spmm_band_packed(
        pk, jg, jnp.asarray(scale), jnp.asarray(scale), pack_rows(jnp.asarray(h)),
        interpret=True, precise=True,
    ))
    t_scale = torch.from_numpy(scale)
    out = tdb.spmm_dense_band(tg, t_scale, t_scale, torch.from_numpy(h))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_spmm_band_wrapper_takes_the_plain_version_on_cpu():
    """K1's wrapper on CPU tensors equals the row-scaled band + mirror
    product computed densely from the stored arrays."""
    rng = np.random.default_rng(3)
    _, tg, _, _ = _builds("ring", rng)
    live, h = _operands(tg.pad_n, 8, rng)
    row = torch.from_numpy(live)
    col = torch.from_numpy(rng.random(tg.pad_n).astype(np.float32))
    ht = torch.from_numpy(h)
    out = spmm_band(tg, row, col, ht, tdb.mirror_sub(tg, col, ht))
    # dense reference: A = band + mirror overflow (spill is empty here)
    dense = np.zeros((tg.pad_n, tg.pad_n), np.float64)
    base = tg.base.numpy().astype(np.float64)
    for b in range(tg.n_blocks):
        cols = (b * S - B + np.arange(tg.W2)) % tg.pad_n
        np.add.at(dense, (slice(b * S, (b + 1) * S), cols), base[b, :S])
    node = tg.mirror_node.numpy().reshape(-1)
    src = node[tg.ccoo.d_src.numpy()]
    dst = node[tg.ccoo.d_dst.numpy()]
    np.add.at(dense, (dst, src), tg.w_cov.numpy())
    ref = live[:, None] * (dense @ (col.numpy()[:, None] * h))
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["ring", "spill"])
def test_sever_edges_matches(kind):
    """In-band, mirror and spill severs, with duplicated and invalid
    entries: identical base, w_cov and w_spill."""
    rng = np.random.default_rng(4)
    jg, tg, ss, dd = _builds(kind, rng)
    ib = jdb.band_slots(ss, dd, N, S, B)[0]
    pick = list(rng.choice(np.flatnonzero(ib), 12, replace=False))
    pick += list(rng.choice(np.flatnonzero(~ib), 8, replace=False))
    pick += pick[:5]  # duplicates
    # and two mirror edges for sure (the spill graph has few)
    src = np.concatenate([ss[pick], np.asarray(jg.c_usrc)[:2]])
    dst = np.concatenate([dd[pick], np.asarray(jg.c_udst)[:2]])
    valid = np.ones(len(src), bool)
    # invalid entries: real edges that must stay, padding zeros, and one
    # invalid copy of a valid sever
    inv = rng.choice(len(ss), 6, replace=False)
    src = np.concatenate([src, ss[inv], [0, 0, src[0]]])
    dst = np.concatenate([dst, dd[inv], [0, 0, dst[0]]])
    valid = np.concatenate([valid, np.zeros(9, bool)])
    # keep clear of the JAX package's redirect cell (0, 0, 0), see
    # test_sever_keeps_a_sever_of_cell_000
    lc = (src - ((dst // S) * S - B)) % jg.pad_n
    keep = ~((dst // S == 0) & (dst % S == 0) & (lc == 0))
    src, dst, valid = src[keep], dst[keep], valid[keep]

    j2 = jdb.sever_edges(jg, jnp.asarray(src.astype(np.int32)),
                         jnp.asarray(dst.astype(np.int32)), jnp.asarray(valid))
    tdb.sever_edges(tg, torch.from_numpy(src), torch.from_numpy(dst),
                    torch.from_numpy(valid))
    assert not np.array_equal(np.asarray(j2.base), np.asarray(jg.base))
    np.testing.assert_array_equal(tg.base.numpy(), np.asarray(j2.base))
    np.testing.assert_array_equal(tg.w_cov.numpy(), np.asarray(j2.w_cov))
    np.testing.assert_array_equal(tg.w_spill.numpy(), np.asarray(j2.w_spill))
    assert (tg.w_cov.numpy() == 0).any()
    if kind == "spill":
        assert (tg.w_spill.numpy() == 0).any()


def test_sever_keeps_a_sever_of_cell_000():
    """The JAX package redirects invalid (padding) sever entries to cell
    (0, 0, 0) and writes back the value it read there, so a real sever of
    that cell (the edge pad_n - B -> 0) in the same call is lost; the port
    drops invalid entries before writing and keeps it."""
    ss = np.array([0, 896, 1, 2])
    dd = np.array([896, 0, 2, 1])
    jg = jdb.build_dense_band(ss, dd, None, N, S=S, B=B)
    tg = tdb.build_dense_band(ss, dd, N, S=S, B=B, device="cpu")
    assert int(jg.base[0, 0, 0]) == 1 and int(tg.base[0, 0, 0]) == 1
    src = np.array([896, 0, 0, 0])
    dst = np.array([0, 0, 0, 0])
    valid = np.array([True, False, False, False])
    j2 = jdb.sever_edges(jg, jnp.asarray(src.astype(np.int32)),
                         jnp.asarray(dst.astype(np.int32)), jnp.asarray(valid))
    tdb.sever_edges(tg, torch.from_numpy(src), torch.from_numpy(dst),
                    torch.from_numpy(valid))
    assert int(tg.base[0, 0, 0]) == 0
    assert int(j2.base[0, 0, 0]) == 1  # the JAX package's known fault


def test_build_banded_duplex_matches():
    """The whole build on a shuffled synthetic duplex: identical ordering,
    mirror capacity, base, mirror COO and spill in both layers."""
    n = 1024
    e0, e1 = synth_duplex_edges(n, 6, np.random.default_rng(5))
    jb, jperm, (j0, j1) = jax_build_duplex(n, e0, e1)
    tb, tperm, (t0, t1) = build_banded_duplex(n, e0, e1, device="cpu")
    np.testing.assert_array_equal(tperm, jperm)
    np.testing.assert_array_equal(t0, j0)
    np.testing.assert_array_equal(t1, j1)
    assert tb.max_rank == int(jb.max_rank)
    np.testing.assert_array_equal(tb.node_mask.numpy(), np.asarray(jb.node_mask))
    for layer in range(2):
        _assert_same_build(jb.dbg(layer), tb.dbg(layer))
