"""The port's gp-sharded band operator (parallel/band_partition.py), whose
local engine is kernel K3 (ops/band_kernels.spmm_band_halo; on the CPU its
plain version spmm_band_halo_plain), against the JAX package's sharded
engines on the 8-device CPU mesh (tests/conftest.py): the XLA engine
spmm_band_sharded(precise=True), forward and VJP, at gp = 2 (eight local
blocks: interior call plus two boundary calls) and gp = 8 (two local
blocks: one call), with mirror lanes and severs routed to the shards; the
packed Pallas engine spmm_band_packed_sharded (interpret mode, its bf16
mode) at gp = 2, G = 2; and the port's unsharded operator, which a sharded
call must equal bit for bit, since K3 stages the same values in the same
order as K1."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdcommunity_tpu.ops import dense_band as jdb  # noqa: E402
from mdcommunity_tpu.ops.band_pallas import pack_band, pack_rows, unpack_rows  # noqa: E402
from mdcommunity_tpu.parallel import band_partition as jbp  # noqa: E402
from mdcommunity_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402
from mdcommunity_tpu_torch.ops import band_kernels as bk  # noqa: E402
from mdcommunity_tpu_torch.ops import dense_band as tdb  # noqa: E402
from mdcommunity_tpu_torch.parallel.band_partition import (  # noqa: E402
    sever_sharded,
    shard_band_graph,
    spmm_band_sharded,
    spmm_band_sharded_grad,
)
from mdcommunity_tpu_torch.parallel.mesh import gather_nodes, make_mesh, split_nodes  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

N, E, S, B, D = 4096, 8192, 256, 128, 64
TOL = 1e-5  # of max|ref|: f32 on both sides, sums in another order


def _edges(seed):
    """A banded ring with 1/16 long edges (mirror lanes, no spill), as
    tests/test_parallel.py builds it."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E)
    off = rng.integers(-B // 2, B // 2, E)
    off[: E // 16] = rng.integers(0, N, E // 16)
    dst = (src + off) % N
    keep = src != dst
    src, dst = src[keep], dst[keep]
    return rng, np.concatenate([src, dst]), np.concatenate([dst, src])


def _severs(rng, tg):
    """12 in-band edges and 12 mirror (overflow) edges, both directions."""
    base = tg.base[:, :S].numpy()
    b, r, c = np.nonzero(base)
    pick = rng.choice(len(b), 12, replace=False)
    dst = b[pick] * S + r[pick]
    src = (b[pick] * S - B + c[pick]) % tg.pad_n
    keys = tg.c_key.numpy()
    k = keys[rng.choice(len(keys), 12, replace=False)]
    src = np.concatenate([src, k // tg.pad_n])
    dst = np.concatenate([dst, k % tg.pad_n])
    return np.concatenate([src, dst]), np.concatenate([dst, src])


@pytest.mark.parametrize("gp", [2, 8])
def test_sharded_operator_matches_jax_xla_engine(gp):
    """Forward and input gradient, row != col, after severs: the port's
    severs are routed to the shards of the sharded graph, the JAX
    package's are made on the whole graph before sharding."""
    rng, ss, dd = _edges(1)
    jg = jdb.build_dense_band(ss, dd, None, N, S=S, B=B, dtype=jnp.int8)
    tg = tdb.build_dense_band(ss, dd, N, S=S, B=B, device="cpu")
    assert tg.spill.nnz == 0 and tg.ccoo.nnz > 0, "must exercise the mirror path"
    s_src, s_dst = _severs(rng, tg)
    jg = jdb.sever_edges(jg, jnp.asarray(s_src), jnp.asarray(s_dst),
                         jnp.ones(len(s_src), bool))
    mesh = make_mesh(gp, "cpu")
    sg = shard_band_graph(mesh, tg)
    n_cov = int((tg.w_cov == 0).sum())
    sever_sharded(sg, torch.from_numpy(s_src), torch.from_numpy(s_dst),
                  torch.ones(len(s_src), dtype=torch.bool))
    assert int((sg.shards[0].w_cov == 0).sum()) > n_cov  # mirror edges severed
    np.testing.assert_array_equal(torch.cat([s.base for s in sg.shards]).numpy(),
                                  np.asarray(jg.base))
    live = (rng.random(N) > 0.1).astype(np.float32)
    row = live * rng.uniform(0.5, 1.5, N).astype(np.float32)
    col = live * rng.uniform(0.5, 1.5, N).astype(np.float32)
    h = rng.standard_normal((N, D)).astype(np.float32)
    g = rng.standard_normal((N, D)).astype(np.float32)

    jm = jax_mesh(dp=8 // gp, gp=gp, devices=jax.devices()[:8])
    jg_s = jbp.shard_band_graph(jm, jg)
    row_s, col_s, h_s = jbp.shard_band_vectors(jm, *map(jnp.asarray, (row, col, h)))
    ref, vjp = jax.vjp(lambda x: jbp.spmm_band_sharded(jm, jg_s, row_s, col_s, x,
                                                       precise=True), h_s)
    (dref,) = vjp(jnp.asarray(g))
    ref, dref = np.asarray(ref), np.asarray(dref)

    hs = [x.clone().requires_grad_() for x in split_nodes(mesh, torch.from_numpy(h))]
    rows, cols = (split_nodes(mesh, torch.from_numpy(v)) for v in (row, col))
    out = spmm_band_sharded_grad(mesh, sg, rows, cols, hs)
    dh = torch.autograd.grad(out, hs, split_nodes(mesh, torch.from_numpy(g)))
    out, dh = gather_nodes(mesh, out).detach().numpy(), gather_nodes(mesh, list(dh)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL * np.abs(ref).max())
    np.testing.assert_allclose(dh, dref, rtol=0, atol=TOL * np.abs(dref).max())
    # the swap matters: the gradient with row and col unswapped is far off
    wrong = gather_nodes(mesh, spmm_band_sharded(mesh, sg, rows, cols,
                                                 split_nodes(mesh, torch.from_numpy(g))))
    assert np.abs(wrong.numpy() - dref).max() > 1e-2 * np.abs(dref).max()


@pytest.mark.parametrize("store", ["float32", "bfloat16"])
@pytest.mark.parametrize("gp", [1, 2, 4, 16])
def test_sharded_operator_equals_unsharded(gp, store):
    """The sharded operator (K3's plain version with the ring halos) against
    the unsharded operator (K1's plain version), in the precise mode and in
    the bf16 mode with f32 or bf16 storage; gp = 16 leaves one block a
    shard, whose both windows reach into the halos.  On the card K3 gives
    K1's bits (chip_smoke.py checks it); here both are einsums over the
    same windows, whose BLAS may sum a block in another order when the
    batch of blocks differs, so the bound is 1e-6 of max|ref| (bf16
    storage: one bf16 ulp of it), and most of the time they are equal."""
    rng, ss, dd = _edges(6)
    tg = tdb.build_dense_band(ss, dd, N, S=S, B=B, device="cpu")
    row = torch.from_numpy(rng.uniform(0.5, 1.5, N).astype(np.float32))
    col = torch.from_numpy(rng.uniform(0.5, 1.5, N).astype(np.float32))
    h = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32))
    h = h.to(getattr(torch, store))
    mesh = make_mesh(gp, "cpu")
    sg = shard_band_graph(mesh, tg)
    for precise in ((True, False) if store == "float32" else (False,)):
        ref = tdb.spmm_dense_band(tg, row, col, h, precise=precise)
        out = gather_nodes(mesh, spmm_band_sharded(
            mesh, sg, split_nodes(mesh, row), split_nodes(mesh, col),
            split_nodes(mesh, h), precise=precise))
        assert out.dtype == h.dtype
        scale = ref.float().abs().max()
        tol = 1e-6 * scale if store == "float32" else 2.0 ** -7 * scale
        assert (out.float() - ref.float()).abs().max() <= tol, precise


def test_halo_kernel_plain_and_wrapper_contract():
    """spmm_band_halo_plain over one shard against the unsharded plain K1
    on that shard's rows, block range by block range (to 1e-6 of max, as
    above); the wrapper refuses a missing halo that a boundary block
    reads."""
    rng, ss, dd = _edges(7)
    tg = tdb.build_dense_band(ss, dd, N, S=S, B=B, device="cpu")
    h = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32))
    col = torch.from_numpy(rng.uniform(0.5, 1.5, N).astype(np.float32))
    row = torch.ones(N)
    sub = tdb.mirror_sub(tg, col, h)
    ref = bk.spmm_band_plain(tg, row, col, h, sub)
    mesh = make_mesh(4, "cpu")
    sg = shard_band_graph(mesh, tg)
    i, L = 1, N // 4  # the second shard: rows [L, 2L)
    shard, m = sg.shards[i], sg.shards[i].n_blocks * tg.C
    args = (shard, row[L:2 * L], col[L:2 * L], h[L:2 * L], h[L - B:L], h[2 * L:2 * L + B],
            col[L - B:L], col[2 * L:2 * L + B], sub[i * m:(i + 1) * m])
    nb_l = shard.n_blocks
    for b0, b1 in ((0, 1), (1, nb_l - 1), (nb_l - 1, nb_l), (0, nb_l)):
        got = bk.spmm_band_halo_plain(*args, blocks=(b0, b1))
        assert (got - ref[L + b0 * S: L + b1 * S]).abs().max() <= 1e-6 * ref.abs().max()
    with pytest.raises(ValueError, match="may not be None"):
        bk.spmm_band_halo(shard, *args[1:4], None, *args[5:], blocks=(0, 1))
    out = bk.spmm_band_halo(shard, *args[1:4], None, None, None, None, args[-1],
                            blocks=(1, nb_l - 1))
    assert (out[S:(nb_l - 1) * S] - ref[L + S: L + (nb_l - 1) * S]).abs().max() <= (
        1e-6 * ref.abs().max())


def test_bf16_sharded_matches_packed_pallas_engine():
    """The port's bf16 mode (f32 storage) against the JAX package's packed
    sharded engine, whose halo-mode kernel runs bf16 operands (interpret
    mode), gp = 2, G = 2: four programs a shard, so its interior and
    boundary calls both run.  The same rounding points on both sides
    (tests/test_torch_band_bf16.py), col the 0/1 live mask (mirror_compact
    rounds h before the col scale), so TOL holds."""
    rng, ss, dd = _edges(9)
    jg = jdb.build_dense_band(ss, dd, None, N, S=S, B=B, dtype=jnp.int8)
    tg = tdb.build_dense_band(ss, dd, N, S=S, B=B, device="cpu")
    pk = pack_band(jg, G=2)
    assert pk.G == 2
    live = (rng.random(N) > 0.1).astype(np.float32)
    row = live * rng.uniform(0.5, 1.5, N).astype(np.float32)
    h = rng.standard_normal((N, D)).astype(np.float32)
    jm = jax_mesh(dp=4, gp=2, devices=jax.devices()[:8])
    pk_s = jbp.shard_packed_band(jm, pk)
    row_s, col_s, h2_s = jbp.shard_band_vectors(
        jm, jnp.asarray(row), jnp.asarray(live), pack_rows(jnp.asarray(h)))
    ref = np.asarray(unpack_rows(jbp.spmm_band_packed_sharded(
        jm, pk_s, jg, row_s, col_s, h2_s, interpret=True)))
    mesh = make_mesh(2, "cpu")
    out = gather_nodes(mesh, spmm_band_sharded(
        mesh, shard_band_graph(mesh, tg), *(split_nodes(mesh, torch.from_numpy(v))
                                            for v in (row, live, h)), precise=False))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=TOL * np.abs(ref).max())
    exact = tdb.spmm_dense_band(tg, torch.from_numpy(row), torch.from_numpy(live),
                                torch.from_numpy(h))
    assert np.abs(exact.numpy() - ref).max() > 1e-4 * np.abs(ref).max()  # it is bf16


def test_shard_band_graph_refuses_spill_and_uneven_blocks():
    rng, ss, dd = _edges(5)
    spilled = tdb.build_dense_band(ss, dd, N, S=S, B=B, max_mirror=2, device="cpu")
    assert spilled.spill.nnz
    with pytest.raises(ValueError, match="spill"):
        shard_band_graph(make_mesh(2, "cpu"), spilled)
    with pytest.raises(ValueError, match="divisible"):
        shard_band_graph(make_mesh(3, "cpu"), tdb.build_dense_band(ss, dd, N, S=S, B=B,
                                                                   device="cpu"))
