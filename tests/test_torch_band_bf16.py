"""The bf16 modes of kernels K1 and K2 (their plain versions, which the
kernels are held to on the card) against the JAX package's precise=False
functions: the XLA engine's spmm_dense_band and the Pallas kernels
spmm_band_packed / sage_step_packed in interpret mode, in f32 and in bf16
storage.

Both sides round the same values at the same points: bf16(col ⊙ h) formed
in f32, the exact int8 band, bf16(mirror sub), round to nearest even; and
the output to bf16 when it is stored so.  Only the order of the f32 sums
differs, so f32 outputs agree to TOL of their max and bf16 outputs to one
bf16 ulp of each element.
"""

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
    spmm_band_packed,
    unpack_rows,
)
from mdcommunity_tpu_torch.ops import band_kernels as bk  # noqa: E402
from mdcommunity_tpu_torch.ops import dense_band as tdb  # noqa: E402

TOL = 1e-5  # of max|ref|: identical rounding points, f32 sums in another order
N, S, B = 1024, 256, 128


def _graph(kind, seed):
    """Symmetric banded graphs: "ring" has live mirror lanes and no spill,
    "spill" also has spill edges (a mirror capacity of 4)."""
    rng = np.random.default_rng(seed)
    e = 2 * N
    src = rng.integers(0, N, e)
    off = np.minimum((24.0 * (rng.pareto(2.0, e) + 1)).astype(np.int64), N // 2 - 1)
    dst = (src + off * rng.choice([-1, 1], e)) % N
    ss, dd = np.concatenate([src, dst]), np.concatenate([dst, src])
    mm = 4 if kind == "spill" else 64
    jg = jdb.build_dense_band(ss, dd, None, N, S=S, B=B, max_mirror=mm)
    tg = tdb.build_dense_band(ss, dd, N, S=S, B=B, max_mirror=mm, device="cpu")
    assert tg.C > 0 and (tg.spill.nnz > 0) == (kind == "spill")
    return rng, jg, tg


def _operands(rng, pad_n, D, binary_col):
    """h with entries that bf16 rounds, independent row and col scales."""
    h = rng.standard_normal((pad_n, D)).astype(np.float32)
    live = (rng.random(pad_n) > 0.15).astype(np.float32)
    row = live * rng.uniform(0.5, 1.5, pad_n).astype(np.float32)
    col = live.copy() if binary_col else live * rng.uniform(0.5, 1.5, pad_n).astype(np.float32)
    return h, row.astype(np.float32), col.astype(np.float32)


def _port_spmm(tg, row, col, h, store=torch.float32):
    r, c = torch.from_numpy(row), torch.from_numpy(col)
    return tdb.spmm_dense_band(tg, r, c, torch.from_numpy(h).to(store), precise=False)


def _close_f32(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * scale)


def _within_bf16_ulp(got, ref):
    got = np.asarray(torch.as_tensor(got).float(), np.float64)
    ref = np.asarray(ref, np.float64)
    mag = np.maximum(np.abs(ref), 1e-30)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    bad = np.abs(got - ref) > ulp + TOL * np.abs(ref).max()
    assert not bad.any(), (np.argwhere(bad)[:5], got[bad][:5], ref[bad][:5])


@pytest.mark.parametrize("D", [2, 64])
@pytest.mark.parametrize("kind", ["ring", "spill"])
def test_k1_bf16_matches_xla_engine(kind, D):
    rng, jg, tg = _graph(kind, 0)
    h, row, col = _operands(rng, jg.pad_n, D, binary_col=False)
    ref = jdb.spmm_dense_band(jg, jnp.asarray(row), jnp.asarray(col), jnp.asarray(h),
                              precise=False)
    _close_f32(_port_spmm(tg, row, col, h).numpy(), ref)


@pytest.mark.parametrize("store", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["ring", "spill"])
def test_k1_bf16_matches_pallas_kernel(kind, store):
    """col in {0, 1} (the live mask of the eval), where the Pallas engine's
    mirror compaction bf16(h)·col equals bf16(col ⊙ h)."""
    rng, jg, tg = _graph(kind, 1)
    h, row, col = _operands(rng, jg.pad_n, 64, binary_col=True)
    jdt = jnp.float32 if store == "float32" else jnp.bfloat16
    ref = unpack_rows(spmm_band_packed(
        pack_band(jg, G=2), jg, jnp.asarray(row), jnp.asarray(col),
        pack_rows(jnp.asarray(h)).astype(jdt), interpret=True, precise=False,
    ))
    ref = np.asarray(ref.astype(jnp.float32))
    out = _port_spmm(tg, row, col, h, getattr(torch, store))
    assert out.dtype == getattr(torch, store)
    if store == "float32":
        _close_f32(out.numpy(), ref)
    else:
        _within_bf16_ulp(out, ref)


@pytest.mark.parametrize("store", ["float32", "bfloat16"])
def test_k2_bf16_matches_pallas_kernel(store):
    rng, jg, tg = _graph("ring", 2)
    D = 64
    h, row, _ = _operands(rng, jg.pad_n, D, binary_col=True)
    live = (row > 0).astype(np.float32)
    h /= np.linalg.norm(h, axis=1, keepdims=True)
    aw = (rng.standard_normal((D, D)) / 8).astype(np.float32)
    bw = (rng.standard_normal((D, D)) / 8).astype(np.float32)
    jdt = jnp.float32 if store == "float32" else jnp.bfloat16
    ref = unpack_rows(sage_step_packed(
        pack_band(jg, G=2), jg, jnp.asarray(live), jnp.asarray(live),
        pack_rows(jnp.asarray(h)).astype(jdt), jnp.asarray(aw), jnp.asarray(bw),
        interpret=True, precise=False,
    ))
    ref = np.asarray(ref.astype(jnp.float32))
    lt = torch.from_numpy(live)
    ht = torch.from_numpy(h).to(getattr(torch, store))
    sub = tdb.mirror_sub(tg, lt, ht, precise=False)
    out = bk.sage_step(tg, lt, lt, ht, sub, torch.from_numpy(aw), torch.from_numpy(bw),
                       precise=False)
    assert out.dtype == ht.dtype
    if store == "float32":
        _close_f32(out.numpy(), ref)
    else:
        _within_bf16_ulp(out, ref)


def test_bf16_mode_rounds():
    """The fast mode is not the precise one: its output differs from the
    precise plain version by bf16 rounding, not more; and with col in
    {0, 1} its operands are bf16(h), so rounding h first changes nothing."""
    rng, jg, tg = _graph("ring", 3)
    h, row, col = _operands(rng, jg.pad_n, 64, binary_col=True)
    r, c, ht = torch.from_numpy(row), torch.from_numpy(col), torch.from_numpy(h)

    def fast(x):
        return bk.spmm_band_plain(tg, r, c, x, tdb.mirror_sub(tg, c, x, False),
                                  precise=False)

    exact = bk.spmm_band_plain(tg, r, c, ht, tdb.mirror_sub(tg, c, ht))
    err = (fast(ht) - exact).abs().max().item() / exact.abs().max().item()
    assert 1e-5 < err < 2 ** -7
    assert torch.equal(fast(ht), fast(ht.to(torch.bfloat16).float()))


def test_wrappers_refuse_bf16_storage_in_precise_mode():
    rng, jg, tg = _graph("ring", 4)
    h, row, col = _operands(rng, jg.pad_n, 64, binary_col=True)
    r, c = torch.from_numpy(row), torch.from_numpy(col)
    hb = torch.from_numpy(h).to(torch.bfloat16)
    sub = tdb.mirror_sub(tg, c, hb, precise=False)
    w = torch.eye(64)
    with pytest.raises(NotImplementedError, match="precise=False"):
        bk.spmm_band(tg, r, c, hb, sub)
    with pytest.raises(NotImplementedError, match="precise=False"):
        bk.sage_step(tg, r, c, hb, sub, w, w)
    with pytest.raises(NotImplementedError):  # no f16 mode
        bk.spmm_band(tg, r, c, hb.half(), sub, precise=False)
    with pytest.raises(ValueError):  # scales and mir_sub stay f32
        bk.spmm_band(tg, r.to(torch.bfloat16), c, hb, sub, precise=False)
    assert {"band_spmm_bf16", "band_sage_bf16", "band_spmm_bf16_act",
            "band_sage_bf16_act"} <= set(bk.launches)
    assert bk._counter("band_sage", hb, False) == "band_sage_bf16_act"
    assert bk._counter("band_spmm", hb.float(), False) == "band_spmm_bf16"
