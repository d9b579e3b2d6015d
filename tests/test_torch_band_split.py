"""The premise of the precise band kernels' tensor-core contraction, and the
launch plan it runs on, on the host (csrc/band.cu, ops/band_kernels.py).

The precise mode stages each window value x = col·h (f32) as three bf16
pieces hi + mid + lo (split_bf16x3) and multiplies each by the int8 or
nibble band on the bf16 tensor cores with f32 sums.  That adds the products
that f32 multiply-adds of x add only if the pieces rebuild x exactly and a
band value times a piece is exact in f32.  Both are checked over seeded
values across f32's exponent range.  The precise launches take the rows a
CTA and the window reach from launch_plan, as the bf16 ones do; their values
at the main path's shapes are pinned here."""

import numpy as np
import pytest
import torch

from mdcommunity_tpu_torch.ops.band_kernels import (
    KC,
    launch_plan,
    split_bf16x3,
    window_reach,
)
from mdcommunity_tpu_torch.parallel.band_partition import block_split
from torch_one_thread import one_torch_thread  # noqa: F401

EXACT_FROM = -110   # binades at or above 2^-110 split exactly (their last bit is on bf16's grid)
# and below this, where hi would round past bf16's largest value to infinity
TOP = (2.0 - 2.0 ** -8) * 2.0 ** 127


def _values(seed, lo=-126, hi=119, n=1 << 14):
    """Seeded f32 normals: random 24-bit significands, signs and binades in
    [lo, hi] (below 2^120, so that 128 times a piece stays finite)."""
    rng = np.random.default_rng(seed)
    sig = 1.0 + rng.integers(0, 1 << 23, n) / float(1 << 23)
    e = rng.integers(lo, hi + 1, n)
    x = (np.ldexp(sig, e) * rng.choice([-1.0, 1.0], n)).astype(np.float32)
    assert np.all(np.abs(x) >= np.float32(2.0 ** -126)) and np.all(np.isfinite(x))
    return x


def _bf16_rne(x32):
    """bf16 rounding to nearest even, from the f32 bits (as cvt.rn.bf16.f32)."""
    u = x32.view(np.uint32).astype(np.uint64)
    r = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return r.astype(np.uint32).view(np.float32)


def _pieces(x):
    return [p.float().numpy() for p in split_bf16x3(torch.from_numpy(x))]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_rebuilds_each_value(seed):
    x = _values(seed)
    hi, mid, lo = _pieces(x)
    # each piece is a bf16 value, rounded to nearest even from its remainder
    for p in (hi, mid, lo):
        assert np.array_equal(p.view(np.uint32) & 0xFFFF, np.zeros_like(p, np.uint32))
    np.testing.assert_array_equal(hi, _bf16_rne(x))
    r = x - hi   # exact in f32 (numpy keeps subnormals)
    np.testing.assert_array_equal(mid, _bf16_rne(r))
    np.testing.assert_array_equal(lo, _bf16_rne(r - mid))
    # each piece at most 2^-8 of the one before: 24 bits in three 8-bit pieces
    assert np.all(np.abs(mid) <= np.abs(hi) * 2.0 ** -8)
    assert np.all(np.abs(lo) <= np.abs(mid) * 2.0 ** -8)
    # hi + mid + lo = x, in f64: exactly from 2^-110 up, and below (the
    # smallest normals) within half of bf16's least subnormal step 2^-133
    total = hi.astype(np.float64) + mid + lo
    exact = np.abs(x) >= 2.0 ** EXACT_FROM
    assert exact.sum() > 0.8 * x.size and (~exact).sum() > 0
    np.testing.assert_array_equal(total[exact], x[exact].astype(np.float64))
    assert np.all(np.abs(total - x)[~exact] <= 2.0 ** -134)


def test_split_at_binade_edges():
    """Powers of two, the values next to them and halfway cases of bf16 in
    every binade, the smallest and the largest normals among them: exact
    from 2^-110 up to TOP, where hi rounds past bf16's largest value (those
    values overflow any f32 sum of the operator anyway)."""
    base = np.ldexp(1.0, np.arange(-126, 128))
    ups = [1.0, 1.0 + 2.0 ** -23, 2.0 - 2.0 ** -23, 1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -9,
           1.0 + 2.0 ** -9 + 2.0 ** -23, 1.0 + 2.0 ** -9 - 2.0 ** -23]
    x = np.concatenate([base * u for u in ups]).astype(np.float32)
    x = np.concatenate([x, -x])
    hi, mid, lo = _pieces(x)
    top = np.abs(x) >= TOP
    assert top.any() and np.all(np.isinf(hi[top])) and np.all(np.isfinite(hi[~top]))
    x, hi, mid, lo = (v[~top] for v in (x, hi, mid, lo))
    total = hi.astype(np.float64) + mid + lo
    exact = np.abs(x) >= 2.0 ** EXACT_FROM
    np.testing.assert_array_equal(total[exact], x[exact].astype(np.float64))
    small = np.abs(x) < 2.0 ** EXACT_FROM
    assert small.any() and np.all(np.abs(total - x)[small] <= 2.0 ** -134)


def test_band_times_piece_is_exact():
    """Every int8 value and every nibble times every piece of seeded values
    across the exponent range is exact in f32 (checked in f64), and the three
    products add to band · x exactly."""
    x = _values(3, n=1 << 11)
    pieces = np.concatenate(_pieces(x))
    bands = np.concatenate([np.arange(-128, 128), np.arange(0, 8)]).astype(np.float32)
    prod32 = bands[:, None] * pieces[None, :]   # f32 multiply, round to nearest
    prod64 = bands.astype(np.float64)[:, None] * pieces.astype(np.float64)[None, :]
    np.testing.assert_array_equal(prod32.astype(np.float64), prod64)
    n = x.size
    parts = prod64[:, :n] + prod64[:, n:2 * n] + prod64[:, 2 * n:]
    exact = np.abs(x) >= 2.0 ** EXACT_FROM
    np.testing.assert_array_equal(
        parts[:, exact], bands.astype(np.float64)[:, None] * x[exact].astype(np.float64))


@pytest.mark.parametrize("n, gp, sms, whole, shard_tr", [
    # the main path: 18,222 nodes pad to 72 blocks of 256; at gp = 4 a shard
    # holds 18 blocks (interior 16, boundary 1 each)
    (18432, 4, 132, 128, (64, 64)),
    # 2^20 nodes: 4,096 blocks; a shard 1,024 (interior 1,022)
    (1 << 20, 4, 132, 256, (256, 64)),
])
def test_launch_plan_at_main_path_shapes(n, gp, sms, whole, shard_tr):
    S, B = 256, 128
    nb = n // S
    assert launch_plan(nb, S, nb, sms) == (whole, 1)
    nb_l = nb // gp
    (interior,), boundary = block_split(nb_l)
    assert launch_plan(interior[1] - interior[0], S, nb_l, sms) == (shard_tr[0], 1)
    for b0, b1 in boundary:
        assert launch_plan(b1 - b0, S, nb_l, sms) == (shard_tr[1], 1)
    # the chunks of KC window columns each CTA of the whole-graph launch walks
    chunks = {r0: tuple(c // KC for c in window_reach(S, B, nb, r0, min(r0 + whole, S)))
              for r0 in range(0, S, whole)}
    W2 = S + 2 * B
    assert chunks == ({0: (0, 6), 128: (2, 8)} if whole == 128 else {0: (0, W2 // KC)})


def test_two_block_rings_take_the_whole_window():
    """A graph of one or two blocks (the window wraps onto the block itself
    or its only neighbour) gets geo = 0: no reach skip."""
    for nb in (1, 2):
        assert launch_plan(nb, 256, nb, 132)[1] == 0
        assert window_reach(256, 128, nb, 0, 64) == (0, 512)
