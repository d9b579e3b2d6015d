"""The blocked-pair kernels' layout and work split, on the CPU.

K4 and K5 (csrc/blocked.cu) run only on the card; what they rest on is
checked here. `row_src`, the global source row K4 reads beside each
row_slot entry, must be src_blk[p]·S + lsrc[p, t] of that slot. And a numpy
model of each kernel's work split, with the launch constants read from the
CUDA source, must give the plain version's result: K4's teams of lanes
walking a row's list in chunks of L entries and its live slots U4 at a
time, over column passes; K5's 32-slot groups (p = slot / T, so groups
straddle pairs where T % 32 != 0), its teams, rounds and butterfly, and
the hand-back of slot k's sum to lane k. The layouts are random, with
T % 32 != 0, empty destination blocks, padded pairs, a hub row longer than
several chunks, and rows whose every slot is dead. On the layouts the JAX
package's build also takes (T % 128 == 0, S % 8 == 0), the models are held
to its Pallas kernels in interpret mode as well.

Tolerance: the models add in the kernels' order with float32 rounding, the
plain versions in index_add_'s and sum's, so they agree to about 1e-6 of
the largest output; 1e-5 is held. The Pallas kernels gather through a
bf16 hi/lo split of the operand (about 2^-17 of each value), so against
them 1e-4 of the largest output is held."""

import math
import re

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401

from mdcommunity_tpu_torch.ops import blocked_kernels as bk

TOL = 1e-5
PALLAS_TOL = 1e-4

# (n, E, S, T, seed, empty destination blocks, hub row, dead rows)
LAYOUTS = {
    "S512_T512_empty_block": (2048, 6000, 512, 512, 0, (1,), None, None),
    "S64_T100_hub_dead": (1000, 5000, 64, 100, 21, (), 70, (100, 150)),
    "S128_T50_empty_hub": (700, 3000, 128, 50, 3, (2,), 5, (400, 440)),
    "S64_T128_hub_dead": (1000, 4000, 64, 128, 8, (3,), 600, (200, 260)),
}
# the layouts the JAX package's build_block_coo takes
PALLAS_LAYOUTS = sorted(k for k, v in LAYOUTS.items() if v[3] % 128 == 0 and v[2] % 8 == 0)


def _consts():
    """The launch constants of csrc/blocked.cu, by name."""
    with open(bk.SRC) as f:
        text = f.read()
    return {m.group(1): int(m.group(2))
            for m in re.finditer(r"constexpr int (\w+) = (\d+);", text)}


def _team_lanes(n):
    L = 1
    while L < n and L < 32:
        L *= 2
    return L


def _fma(a, b, c):
    """a·b + c rounded once to float32 (the product is exact in float64)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _edges(name):
    """The layout's random edges (src, dst), and the generator that drew
    them, whose next draws are the weights."""
    n, E, S, T, seed, empty, hub, dead = LAYOUTS[name]
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, E), rng.integers(0, n, E)
    if hub is not None:  # 300 edges into one row, half from one source block
        src = np.concatenate([src, rng.integers(0, n, 150), rng.integers(S, 2 * S, 150)])
        dst = np.concatenate([dst, np.full(300, hub)])
    keep = ~np.isin(dst // S, empty)
    return src[keep], dst[keep], rng


def _layout(name):
    n, E, S, T, seed, empty, hub, dead = LAYOUTS[name]
    src, dst, rng = _edges(name)
    bcoo, ssrc, sdst, mask = bk.build_block_coo(src, dst, n, S, T, device="cpu")
    w = (rng.random(mask.size) * mask).astype(np.float32)
    if dead is not None:
        w[(sdst >= dead[0]) & (sdst < dead[1])] = 0
    # the features the layouts are for
    assert int(bcoo.rowptr[-1]) < bcoo.n_pairs  # padded pairs
    counts = np.diff(bcoo.row_ptr.numpy())
    if hub is not None:
        assert counts[hub] > 64
    if dead is not None:
        assert counts[dead[0]:dead[1]].max() > 0
    for b in empty:
        assert counts[b * S:(b + 1) * S].max() == 0
    return bcoo, ssrc, sdst, w.reshape(bcoo.n_pairs, T)


def _k4_columns(L, Q4, D):
    """Per pass, the columns each lane of a K4 team holds."""
    return [[[d0 + 4 * (tl + L * q) + i for q in range(Q4) for i in range(4)
              if d0 + 4 * (tl + L * q) + i < D] for tl in range(L)]
            for d0 in range(0, D, 4 * L * Q4)]


def _k5_columns(L, Q5, D):
    """Each lane's columns of a K5 team, in the order it adds them."""
    return [[d0 + 4 * (tl + L * q) + i for d0 in range(0, D, 4 * L * Q5)
             for q in range(Q5) for i in range(4) if d0 + 4 * (tl + L * q) + i < D]
            for tl in range(L)]


def k4_model(bcoo, w, h, c):
    """csrc/blocked.cu's K4, lane by lane: a team of L lanes a row; the
    row's list read L entries at a time; its live slots (w != 0) taken U4
    at a time in list order; one fma a live slot and column."""
    D = h.shape[1]
    L = _team_lanes(math.ceil(D / (4 * c["Q4"])))
    row_ptr, row_slot, row_src = (bcoo.row_ptr.numpy(), bcoo.row_slot.numpy(),
                                  bcoo.row_src.numpy())
    wf = w.reshape(-1)
    out = np.full(h.shape, np.nan, np.float32)
    for cols_of_lane in _k4_columns(L, c["Q4"], D):
        cols = np.array([x for lane in cols_of_lane for x in lane])
        for row in range(bcoo.n_rows):
            acc = np.zeros(len(cols), np.float32)
            for base in range(row_ptr[row], row_ptr[row + 1], L):
                ks = np.arange(base, min(base + L, row_ptr[row + 1]))
                wk, src = wf[row_slot[ks]], row_src[ks]
                live = np.nonzero(wk != 0)[0]
                for g0 in range(0, len(live), c["U4"]):
                    for j in live[g0:g0 + c["U4"]]:
                        acc = _fma(np.float32(wk[j]), h[src[j], cols], acc)
            out[row, cols] = acc
    return out


def k5_model(bcoo, h, g, c):
    """csrc/blocked.cu's K5: groups of 32 slots (p = slot / T), teams of L
    lanes taking slot team + TEAMS·round, each lane's fma partial over its
    columns, the team's xor butterfly, and lane k taking the sum of the slot
    its source lane's team took in round k // TEAMS."""
    D = h.shape[1]
    L = _team_lanes(math.ceil(D / (4 * c["Q5"])))
    TEAMS = 32 // L
    S, T, n = bcoo.S, bcoo.T, bcoo.n_slots
    N = -(-n // 32) * 32
    slot = np.arange(N)
    valid = slot < n
    s = np.where(valid, slot, 0)
    p = s // T
    hrow = np.where(valid, bcoo.src_blk.numpy()[p] * S + bcoo.lsrc.numpy().reshape(-1)[s], 0)
    grow = np.where(valid, bcoo.dst_blk.numpy()[p] * S + bcoo.ldst.numpy().reshape(-1)[s], 0)
    # the slot each (group, team, round) takes, and its lanes' partials
    team, rnd = np.meshgrid(np.arange(TEAMS), np.arange(L), indexing="ij")
    took = (slot.reshape(-1, 32)[:, (team + TEAMS * rnd).reshape(-1)]).reshape(-1)
    parts = np.zeros((len(took), L), np.float32)
    for tl, cols in enumerate(_k5_columns(L, c["Q5"], D)):
        for col in cols:
            parts[:, tl] = _fma(h[hrow[took], col], g[grow[took], col], parts[:, tl])
    off = L // 2
    while off:
        parts = parts + parts[:, np.arange(L) ^ off]
        off //= 2
    sums = parts[:, 0].reshape(-1, TEAMS, L)          # [group, team, round]
    lane = np.arange(32)
    mine = sums[:, lane % TEAMS, lane // TEAMS].reshape(-1)
    return mine[:n].reshape(bcoo.n_pairs, T)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_row_src_is_each_slots_source_row(name):
    bcoo, ssrc, sdst, _ = _layout(name)
    slot = bcoo.row_slot.numpy().astype(np.int64)
    p, t = slot // bcoo.T, slot % bcoo.T
    want = bcoo.src_blk.numpy()[p].astype(np.int64) * bcoo.S + bcoo.lsrc.numpy()[p, t]
    assert bcoo.row_src.dtype == torch.int32
    np.testing.assert_array_equal(bcoo.row_src.numpy(), want)
    np.testing.assert_array_equal(bcoo.row_src.numpy(), ssrc[slot])
    rows = np.repeat(np.arange(bcoo.n_rows), np.diff(bcoo.row_ptr.numpy()))
    np.testing.assert_array_equal(rows, sdst[slot])


@pytest.mark.parametrize("D", [64, 30, 2, 300])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_k4_work_split_gives_the_plain_result(name, D):
    bcoo, *_, w = _layout(name)
    h = np.random.default_rng(D).standard_normal((bcoo.n_rows, D)).astype(np.float32)
    ref = bk.spmm_block_plain(bcoo, torch.from_numpy(w), torch.from_numpy(h)).numpy()
    got = k4_model(bcoo, w, h, _consts())
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * np.abs(ref).max())
    dead = LAYOUTS[name][7]
    if dead is not None:  # rows whose every slot is dead, exactly 0
        assert not got[dead[0]:dead[1]].any()


@pytest.mark.parametrize("D", [64, 30, 2, 300])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_k5_work_split_gives_the_plain_result(name, D):
    bcoo, *_ = _layout(name)
    rng = np.random.default_rng(D + 1)
    h = rng.standard_normal((bcoo.n_rows, D)).astype(np.float32)
    g = rng.standard_normal((bcoo.n_rows, D)).astype(np.float32)
    ref = bk.sddmm_block_plain(bcoo, torch.from_numpy(h), torch.from_numpy(g)).numpy()
    got = k5_model(bcoo, h, g, _consts())
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * np.abs(ref).max())


@pytest.mark.parametrize("D", [64, 30])
@pytest.mark.parametrize("name", PALLAS_LAYOUTS)
def test_work_split_matches_pallas_interpret(name, D):
    """Both models against the JAX package's spmm_block and sddmm_block in
    interpret mode on the same edges (the JAX build's layout is the port's,
    tests/test_torch_blocked.py::test_layout_equals_jax): K4's every row,
    the dead rows exactly 0; K5's every slot, padding included."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from mdcommunity_tpu.ops import pallas_spmm as PS

    n, S, T = LAYOUTS[name][0], LAYOUTS[name][2], LAYOUTS[name][3]
    src, dst, _ = _edges(name)
    jb = PS.build_block_coo(src.astype(np.int32), dst.astype(np.int32), n, S, T)[0]
    bcoo, *_, w = _layout(name)
    rng = np.random.default_rng(D + 2)
    h = rng.standard_normal((bcoo.n_rows, D)).astype(np.float32)
    g = rng.standard_normal((bcoo.n_rows, D)).astype(np.float32)
    c = _consts()
    ref4 = np.asarray(PS.spmm_block(jb, jnp.asarray(w), jnp.asarray(h), interpret=True))
    got4 = k4_model(bcoo, w, h, c)
    np.testing.assert_allclose(got4, ref4, rtol=0, atol=PALLAS_TOL * np.abs(ref4).max())
    dead = LAYOUTS[name][7]
    if dead is not None:
        assert not ref4[dead[0]:dead[1]].any() and not got4[dead[0]:dead[1]].any()
    ref5 = np.asarray(PS.sddmm_block(jb, jnp.asarray(h), jnp.asarray(g), interpret=True))
    got5 = k5_model(bcoo, h, g, c)
    assert got5.shape == ref5.shape == (bcoo.n_pairs, T)
    np.testing.assert_allclose(got5, ref5, rtol=0, atol=PALLAS_TOL * np.abs(ref5).max())


def test_work_split_covers_every_column_once():
    """For every width up to 300, K4's passes and K5's lanes hold each
    column exactly once, and a team fits in a warp."""
    c = _consts()
    for D in range(1, 301):
        L4 = _team_lanes(math.ceil(D / (4 * c["Q4"])))
        cols4 = sorted(x for pass_ in _k4_columns(L4, c["Q4"], D) for lane in pass_ for x in lane)
        L5 = _team_lanes(math.ceil(D / (4 * c["Q5"])))
        cols5 = sorted(x for lane in _k5_columns(L5, c["Q5"], D) for x in lane)
        assert cols4 == cols5 == list(range(D)), D
        assert 32 % L4 == 0 and 32 % L5 == 0


def test_cuda_source_names_its_constants():
    c = _consts()
    for name in ("NT4", "U4", "Q4", "NT5", "R5", "Q5"):
        assert c[name] >= 1, name
    assert c["NT4"] % 32 == 0 and c["NT5"] % 32 == 0
