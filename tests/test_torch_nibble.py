"""Nibble base storage (ops/dense_band.build_dense_band(nibble=True): two
window columns a byte) against the JAX package's nibble pack
(band_pallas.pack_band(nibble=True)) and the port's own int8 storage.

  * the operator and its gradient (BandSpmm) against spmm_band_packed on a
    nibble pack in interpret mode, at tests/test_band_pallas.py's nibble
    shape (n = 4,096, S = 512, B = 128), both precise modes;
  * the gp-sharded operator (kernel K3's plain version) on a nibble build at
    precise=False against spmm_band_packed_sharded on a nibble pack (gp = 2,
    G = 2), which runs its bf16 mode whatever precise says;
  * nibble equals int8 bit for bit in every plain mode (K1, K2 with either
    epilogue, K3, BandSpmm's gradient), fresh and after severs that hold
    duplicates and both cells of one byte;
  * the duplicate and same-byte sever cases of tests/test_band_pallas.py:356,
    against the JAX package's dense sever; a value above 7 refused; the
    gradient guard sees a nibble sever.

Tolerances: 1e-5 of max|ref| against the JAX package (the same rounding
points, f32 sums in another order); 0 (torch.equal) between the port's two
storages, whose plain versions unpack to the same int8 values."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdcommunity_tpu.ops import dense_band as jdb  # noqa: E402
from mdcommunity_tpu.ops.band_pallas import (  # noqa: E402
    pack_band,
    pack_rows,
    spmm_band_packed,
    unpack_rows,
)
from mdcommunity_tpu.parallel import band_partition as jbp  # noqa: E402
from mdcommunity_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402
from mdcommunity_tpu_torch.graphs.banded import (  # noqa: E402
    apply_severs,
    build_banded_duplex,
    fork_banded,
    restore_banded,
    shard_banded_duplex,
)
from mdcommunity_tpu_torch.ops import band_kernels as bk  # noqa: E402
from mdcommunity_tpu_torch.ops import dense_band as tdb  # noqa: E402
from mdcommunity_tpu_torch.parallel.band_partition import (  # noqa: E402
    shard_band_graph,
    spmm_band_sharded,
    spmm_band_sharded_grad,
)
from mdcommunity_tpu_torch.parallel.mesh import gather_nodes, make_mesh, split_nodes  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

TOL = 1e-5  # of max|ref|: the same rounding points, f32 sums in another order
D = 64


def _ring_graph(rng, n, e, scale=24.0):
    """tests/test_band_pallas.py's ring graph (symmetric, a few long edges)."""
    src = rng.integers(0, n, e)
    off = np.minimum((scale * (rng.pareto(2.0, e) + 1)).astype(np.int64), n // 2 - 1)
    dst = (src + off * rng.choice([-1, 1], e)) % n
    return np.concatenate([src, dst]), np.concatenate([dst, src])


def _close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * scale)


@pytest.fixture(scope="module")
def pallas_case():
    """test_band_pallas.py:124-136's nibble case: n = 4,096, 8,192 edges,
    S = 512, B = 128, mirror lanes, 15% covered."""
    rng = np.random.default_rng(0)
    n = 4096
    ss, dd = _ring_graph(rng, n, 8192)
    jg = jdb.build_dense_band(ss, dd, None, n, S=512, B=128, dtype=jnp.int8)
    tg = tdb.build_dense_band(ss, dd, n, S=512, B=128, device="cpu", nibble=True)
    assert tg.C > 0 and tg.base.shape[-1] == tg.W2 // 2
    live = (rng.random(n) >= 0.15).astype(np.float32)
    h = rng.standard_normal((n, D)).astype(np.float32)
    return jg, pack_band(jg, G=8, nibble=True), tg, live, h


@pytest.mark.parametrize("precise", [True, False])
def test_nibble_operator_matches_pallas_nibble(pallas_case, precise):
    jg, pk, tg, live, h = pallas_case
    lj = jnp.asarray(live)
    ref = unpack_rows(spmm_band_packed(pk, jg, lj, lj, pack_rows(jnp.asarray(h)),
                                       interpret=True, precise=precise))
    lt = torch.from_numpy(live)
    out = tdb.spmm_dense_band(tg, lt, lt, torch.from_numpy(h), precise=precise)
    _close(out.numpy(), ref)


def test_nibble_gradient_matches_pallas_vjp(pallas_case):
    jg, pk, tg, live, h = pallas_case
    lj = jnp.asarray(live)
    ref = unpack_rows(jax.grad(lambda x2: jnp.sum(jnp.square(spmm_band_packed(
        pk, jg, lj, lj, x2, interpret=True, precise=True))))(pack_rows(jnp.asarray(h))))
    lt = torch.from_numpy(live)
    x = torch.from_numpy(h).requires_grad_()
    (g,) = torch.autograd.grad(tdb.spmm_dense_band_grad(tg, lt, lt, x).square().sum(), x)
    _close(g.numpy(), ref)


def test_nibble_sharded_operator_matches_pallas_sharded():
    """tests/test_parallel.py:212-245's nibble case, gp = 2, G = 2."""
    rng = np.random.default_rng(9)
    n, e, S, B = 4096, 8192, 256, 128
    src = rng.integers(0, n, e)
    off = rng.integers(-B // 2, B // 2, e)
    off[: e // 16] = rng.integers(0, n, e // 16)
    dst = (src + off) % n
    keep = src != dst
    ss = np.concatenate([src[keep], dst[keep]])
    dd = np.concatenate([dst[keep], src[keep]])
    jg = jdb.build_dense_band(ss, dd, None, n, S=S, B=B, dtype=jnp.int8)
    tg = tdb.build_dense_band(ss, dd, n, S=S, B=B, device="cpu", nibble=True)
    assert tg.spill.nnz == 0 and tg.ccoo.nnz > 0
    live = (rng.random(n) > 0.1).astype(np.float32)
    row = live * rng.uniform(0.5, 1.5, n).astype(np.float32)
    h = rng.standard_normal((n, D)).astype(np.float32)
    jm = jax_mesh(dp=4, gp=2, devices=jax.devices()[:8])
    pk_s = jbp.shard_packed_band(jm, pack_band(jg, G=2, nibble=True))
    row_s, col_s, h2_s = jbp.shard_band_vectors(
        jm, jnp.asarray(row), jnp.asarray(live), pack_rows(jnp.asarray(h)))
    ref = np.asarray(unpack_rows(jbp.spmm_band_packed_sharded(
        jm, pk_s, jg, row_s, col_s, h2_s, interpret=True)))
    mesh = make_mesh(2, "cpu")
    out = gather_nodes(mesh, spmm_band_sharded(
        mesh, shard_band_graph(mesh, tg), *(split_nodes(mesh, torch.from_numpy(v))
                                            for v in (row, live, h)), precise=False))
    _close(out.numpy(), ref)


# ------------------------------------------------------------ nibble = int8


def _pair(seed=3, n=2048, S=256, B=128):
    """One simple graph's int8 and nibble builds (no spill, mirror lanes)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, 4 * n)
    off = rng.integers(-B // 2, B // 2, 4 * n)
    off[: n // 32] = rng.integers(0, n, n // 32)
    dst = (src + off) % n
    key = np.unique(np.minimum(src, dst) * n + np.maximum(src, dst))
    a, b = key // n, key % n
    keep = a != b
    ss, dd = np.concatenate([a[keep], b[keep]]), np.concatenate([b[keep], a[keep]])
    g8 = tdb.build_dense_band(ss, dd, n, S=S, B=B, device="cpu")
    g4 = tdb.build_dense_band(ss, dd, n, S=S, B=B, device="cpu", nibble=True)
    assert g8.spill.nnz == 0 and g8.C > 0
    return rng, g8, g4


def _sever_batch(rng, g):
    """Directed in-band edges with duplicates, both cells of one byte, and
    a padding entry; both directions."""
    band = g.base[:, : g.S].numpy()
    b, r, c = np.nonzero(band)
    pick = list(rng.choice(len(b), 24, replace=False))
    pair = np.flatnonzero((c[:-1] % 2 == 0) & (c[1:] == c[:-1] + 1) & (b[1:] == b[:-1])
                          & (r[1:] == r[:-1]))
    assert len(pair), "want two cells of one byte"
    pick += [pair[0], pair[0] + 1] + pick[:5]   # the byte pair, and duplicates
    pick = np.asarray(pick)
    dst = b[pick] * g.S + r[pick]
    src = (b[pick] * g.S - g.B + c[pick]) % g.pad_n
    src, dst = np.r_[src, 0], np.r_[dst, 0]
    valid = np.r_[np.ones(len(pick), bool), False]
    t = torch.from_numpy
    return t(np.r_[src, dst]), t(np.r_[dst, src]), t(np.r_[valid, valid])


MODES = [(True, "float32"), (False, "float32"), (False, "bfloat16")]


def _operands(rng, g, store):
    live = torch.from_numpy((rng.random(g.pad_n) > 0.1).astype(np.float32))
    h = torch.nn.functional.normalize(
        torch.from_numpy(rng.standard_normal((g.pad_n, D)).astype(np.float32)), dim=-1)
    aw, bw = (torch.from_numpy((rng.standard_normal((D, D)) / 8).astype(np.float32))
              for _ in range(2))
    return live, h.to(getattr(torch, store)), aw, bw


@pytest.mark.parametrize("severed", [False, True])
@pytest.mark.parametrize("precise,store", MODES)
def test_nibble_equals_int8_in_every_plain_mode(precise, store, severed):
    rng, g8, g4 = _pair()
    if severed:
        batch = _sever_batch(rng, g8)
        for g in (g8, g4):
            tdb.sever_edges(g, *batch)
        assert torch.equal(tdb.band_rows(g4), g8.base[:, : g8.S])
    live, h, aw, bw = _operands(rng, g8, store)
    outs = []
    for g in (g8, g4):
        sub = tdb.mirror_sub(g, live, h, precise)
        outs.append([
            bk.spmm_band(g, live, live, h, sub, precise=precise),
            bk.sage_step(g, live, live, h, sub, aw, bw, precise),
            bk.sage_step(g, live, live, h, sub, aw, bw, precise, f32_epi=False),
        ])
        mesh = make_mesh(2, "cpu")
        outs[-1].append(gather_nodes(mesh, spmm_band_sharded(
            mesh, shard_band_graph(mesh, g), split_nodes(mesh, live),
            split_nodes(mesh, live), split_nodes(mesh, h), precise=precise)))
        if precise:
            x = h.clone().requires_grad_()
            outs[-1].append(torch.autograd.grad(
                tdb.spmm_dense_band_grad(g, live, live, x).square().sum(), x)[0])
            xs = split_nodes(mesh, h.clone().requires_grad_())
            outs[-1].append(torch.cat(torch.autograd.grad(
                sum(o.square().sum() for o in spmm_band_sharded_grad(
                    mesh, shard_band_graph(mesh, g), split_nodes(mesh, live),
                    split_nodes(mesh, live), xs)), xs)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_nibble_sever_duplicates_and_same_byte_match_jax():
    """tests/test_band_pallas.py:356's case: one directed edge three times in
    a batch, its same-byte neighbour, and an invalid lane.  The nibble base
    decodes to the JAX package's severed dense base and to the port's int8
    one; no byte goes negative."""
    rng = np.random.default_rng(0)
    n = 2048
    ss, dd = _ring_graph(rng, n, 4096)
    jg = jdb.build_dense_band(ss, dd, None, n, S=512, B=128, dtype=jnp.int8)
    g8 = tdb.build_dense_band(ss, dd, n, S=512, B=128, device="cpu")
    g4 = tdb.build_dense_band(ss, dd, n, S=512, B=128, device="cpu", nibble=True)
    s0, d0 = int(ss[0]), int(dd[0])
    a_even = (s0 // 2) * 2
    src = np.asarray([s0, s0, s0, a_even, a_even + 1, 0])
    dst = np.asarray([d0, d0, d0, d0, d0, 0])
    valid = np.asarray([1, 1, 1, 1, 1, 0], bool)
    ref = np.asarray(jdb.sever_edges(jg, jnp.asarray(src, jnp.int32), jnp.asarray(
        dst, jnp.int32), jnp.asarray(valid)).base)
    for g in (g8, g4):
        tdb.sever_edges(g, torch.from_numpy(src), torch.from_numpy(dst),
                        torch.from_numpy(valid))
    assert int(g4.base.min()) >= 0
    np.testing.assert_array_equal(tdb.band_rows(g4).numpy(), ref[:, :512])
    np.testing.assert_array_equal(g8.base.numpy(), ref)
    assert (ref[:, :512] != np.asarray(jg.base)[:, :512]).sum() >= 1  # it severed


def test_nibble_refuses_values_above_7():
    n = 1024
    src = np.r_[np.full(8, 5), np.arange(100, 110)]
    dst = np.r_[np.full(8, 6), np.arange(101, 111)]
    ss, dd = np.concatenate([src, dst]), np.concatenate([dst, src])
    with pytest.raises(ValueError, match=r"\[0, 7\]"):
        tdb.build_dense_band(ss, dd, n, device="cpu", nibble=True)
    seven = tdb.build_dense_band(np.r_[src[1:], dst[1:]], np.r_[dst[1:], src[1:]], n,
                                 device="cpu", nibble=True)
    assert int(tdb.band_rows(seven).max()) == 7
    jg = jdb.build_dense_band(ss, dd, None, n, S=256, B=128, dtype=jnp.int8)
    with pytest.raises(AssertionError, match=r"\[0, 7\]"):
        pack_band(jg, nibble=True)


def test_nibble_duplex_forks_shards_and_guards():
    """build_banded_duplex(nibble=True): the flag and the halved base reach
    both layers, forks, restores and shard views; a sever through a shard
    view is seen by the whole graph's gradient guard."""
    from mdcommunity_tpu_torch.large_graph_demo import synth_duplex_edges

    rng = np.random.default_rng(1)
    n = 2048
    e0, e1 = synth_duplex_edges(n, 6, rng, shuffle=False)
    bd, _, ordered = build_banded_duplex(n, e0, e1, reorder=False, max_rank=0,
                                         device="cpu", nibble=True)
    assert bd.dbg0.nibble and bd.dbg1.base.shape[-1] == bd.dbg1.W2 // 2
    fork = fork_banded(bd)
    src, dst = (torch.from_numpy(ordered[0][:40, i].copy()) for i in (0, 1))
    apply_severs(fork, 0, src, dst, torch.ones(40, dtype=torch.bool))
    assert not torch.equal(fork.dbg0.base, bd.dbg0.base)
    restore_banded(fork, bd)
    assert torch.equal(fork.dbg0.base, bd.dbg0.base)

    live = torch.ones(bd.pad_n)
    x = torch.randn(bd.pad_n, 8, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    y = tdb.spmm_dense_band_grad(bd.dbg0, live, live, x)
    sharded = shard_banded_duplex(make_mesh(2, "cpu"), bd)
    assert all(s.nibble for s in sharded.dbg0.shards)
    apply_severs(sharded, 0, src, dst, torch.ones(40, dtype=torch.bool))
    with pytest.raises(RuntimeError, match="edited"):
        y.sum().backward()
