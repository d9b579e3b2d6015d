"""Port's fused SAGE step (kernel K2's plain version) vs the JAX package's
Pallas kernel sage_step_packed (interpret mode, precise), unpacked."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdcommunity_tpu.ops import dense_band as jdb  # noqa: E402
from mdcommunity_tpu.ops.band_pallas import (  # noqa: E402
    pack_band,
    pack_rows,
    sage_step_packed,
    unpack_rows,
)
from mdcommunity_tpu_torch.ops import dense_band as tdb  # noqa: E402
from mdcommunity_tpu_torch.ops.aggregate import l2_normalize  # noqa: E402
from mdcommunity_tpu_torch.ops.band_kernels import sage_step, spmm_band  # noqa: E402

RTOL = ATOL = 1e-5  # f32 on both sides; only the order of the sums differs
N, S, B, D = 1024, 256, 128, 64


def _case(kind, seed):
    rng = np.random.default_rng(seed)
    e = 2 * N
    src = rng.integers(0, N, e)
    if kind == "band":  # all in band: no mirror lanes
        off = rng.integers(1, 64, e)
    else:  # live mirror lanes, no spill
        off = np.minimum((24.0 * (rng.pareto(2.0, e) + 1)).astype(np.int64), N // 2 - 1)
    dst = (src + off * rng.choice([-1, 1], e)) % N
    ss, dd = np.concatenate([src, dst]), np.concatenate([dst, src])
    jg = jdb.build_dense_band(ss, dd, None, N, S=S, B=B)
    tg = tdb.build_dense_band(ss, dd, N, S=S, B=B, device="cpu")
    assert tg.spill.nnz == 0 and (tg.C > 0) == (kind == "ring")
    live = (rng.random(jg.pad_n) > 0.15).astype(np.float32)
    h = rng.standard_normal((jg.pad_n, D)).astype(np.float32)
    h /= np.linalg.norm(h, axis=1, keepdims=True)
    aw = (rng.standard_normal((D, D)) / 8).astype(np.float32)
    bw = (rng.standard_normal((D, D)) / 8).astype(np.float32)
    return jg, tg, live, h, aw, bw


def _port(tg, live, h, aw, bw):
    lt, ht = torch.from_numpy(live), torch.from_numpy(h)
    sub = tdb.mirror_sub(tg, lt, ht)
    return sage_step(tg, lt, lt, ht, sub, torch.from_numpy(aw), torch.from_numpy(bw))


@pytest.mark.parametrize("kind", ["ring", "band"])
def test_sage_step_matches_pallas_packed(kind):
    jg, tg, live, h, aw, bw = _case(kind, 0)
    pk = pack_band(jg, G=2)
    ref = unpack_rows(sage_step_packed(
        pk, jg, jnp.asarray(live), jnp.asarray(live), pack_rows(jnp.asarray(h)),
        jnp.asarray(aw), jnp.asarray(bw), interpret=True, precise=True,
    ))
    out = _port(tg, live, h, aw, bw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["ring", "band"])
def test_sage_step_is_the_unfused_round(kind):
    """K2 equals K1 followed by the dense layer, relu and the row l2n it
    fuses, computed from the JAX package's XLA engine."""
    jg, tg, live, h, aw, bw = _case(kind, 1)
    pool = np.asarray(jdb.spmm_dense_band(
        jg, jnp.asarray(live), jnp.asarray(live), jnp.asarray(h), precise=True))
    z = np.maximum(pool @ aw + h @ bw, 0.0)
    ref = z / np.sqrt(np.maximum((z * z).sum(-1, keepdims=True), 1e-24))
    out = _port(tg, live, h, aw, bw)
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)
    # and the port's own unfused round agrees
    lt, ht = torch.from_numpy(live), torch.from_numpy(h)
    pool_t = spmm_band(tg, lt, lt, ht, tdb.mirror_sub(tg, lt, ht))
    unfused = l2_normalize(torch.relu(pool_t @ torch.from_numpy(aw)
                                      + ht @ torch.from_numpy(bw)), eps=1e-12)
    np.testing.assert_allclose(out.numpy(), unfused.numpy(), rtol=RTOL, atol=ATOL)


def test_sage_step_rejects_what_it_does_not_take():
    jg, tg, live, h, aw, bw = _case("ring", 2)
    lt, ht = torch.from_numpy(live), torch.from_numpy(h)
    sub = tdb.mirror_sub(tg, lt, ht)
    with pytest.raises(NotImplementedError):  # the bf16 modes are not ported
        sage_step(tg, lt, lt, ht.to(torch.bfloat16), sub,
                  torch.from_numpy(aw), torch.from_numpy(bw))
    with pytest.raises(ValueError):
        sage_step(tg, lt, lt, ht, sub, torch.from_numpy(aw)[:8],
                  torch.from_numpy(bw))
    # spill edges would have to land before the relu: refused
    rng = np.random.default_rng(3)
    src = rng.integers(0, N, 4 * N)
    ss = np.concatenate([src, (src + 300) % N])
    dd = np.concatenate([(src + 300) % N, src])
    spilled = tdb.build_dense_band(ss, dd, N, S=S, B=B, max_mirror=4, device="cpu")
    assert spilled.spill.nnz
    with pytest.raises(ValueError, match="spill"):
        sage_step(spilled, lt, lt, ht, tdb.mirror_sub(spilled, lt, ht),
                  torch.from_numpy(aw), torch.from_numpy(bw))
