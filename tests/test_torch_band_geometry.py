"""The premise of the band kernels' chunk skipping, on the host.

csrc/band.cu's kernels (every mode) walk a band block's window in chunks of
KC columns and skip those that the CTA's rows cannot reach
(ops/band_kernels.window_reach): on a ring of three or more blocks the
symmetric band test keeps rows r >= B out of window columns [0, B) and rows
r < S - B out of [S + B, W2).  A skipped chunk that held an entry would drop
it, so the builds' bands are checked against that reach for random graphs,
block sizes and storages, together with the CTA row split
(rows_per_cta) and the chunk ranges the kernels derive from both.  With
one or two blocks the window wraps onto the block itself or its only
neighbour, and an entry can sit anywhere: the reach is then the whole
window, and a graph shows why."""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from mdcommunity_tpu_torch.ops.band_kernels import (
    KC,
    MAX_ROWS,
    MIN_ROWS,
    rows_per_cta,
    window_reach,
)
from mdcommunity_tpu_torch.ops.dense_band import band_rows, build_dense_band
from torch_one_thread import one_torch_thread  # noqa: F401


def _graph(rng, n, long_share):
    """A simple undirected graph on n nodes, both directions listed: ring
    neighbours within a few hops plus a share of uniform long edges."""
    m = 3 * n
    u = rng.integers(0, n, m)
    hop = rng.integers(1, 6, m)
    v = np.where(rng.random(m) < long_share, rng.integers(0, n, m), (u + hop) % n)
    keep = u != v
    pairs = np.unique(np.sort(np.stack([u[keep], v[keep]], 1), axis=1), axis=0)
    return (np.concatenate([pairs[:, 0], pairs[:, 1]]),
            np.concatenate([pairs[:, 1], pairs[:, 0]]))


def _tiles(S, tr):
    return [(r0, min(r0 + tr, S)) for r0 in range(0, S, tr)]


@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2**31 - 1), s8=st.integers(1, 32), b_frac=st.floats(0, 1),
       nb=st.integers(1, 12), shuffle=st.booleans(), nibble=st.booleans(),
       sms=st.sampled_from([1, 16, 132]))
def test_band_entries_lie_in_window_reach(seed, s8, b_frac, nb, shuffle, nibble, sms):
    rng = np.random.default_rng(seed)
    S = 8 * s8
    B = 8 * int(round(b_frac * s8))
    n = int(rng.integers((nb - 1) * S + 1, nb * S + 1))
    src, dst = _graph(rng, n, 0.5 if shuffle else 0.02)
    dbg = build_dense_band(src, dst, n, S=S, B=B, device="cpu", nibble=nibble)
    assert dbg.n_blocks == nb
    band = band_rows(dbg).ne(0)                       # [nb, S, W2]
    # per row: no entry outside window_reach
    for r in range(S):
        lo, hi = window_reach(S, B, nb, r, r + 1)
        row = band[:, r]
        assert not row[:, :lo].any() and not row[:, hi:].any(), (r, lo, hi)
    # per CTA of the launch's row split: the chunks it walks hold every entry
    # of its rows
    tr = rows_per_cta(nb, S, sms)
    for r0, r1 in _tiles(S, tr):
        lo, hi = window_reach(S, B, nb, r0, r1)
        c_lo, c_hi = lo // KC, -(-hi // KC)
        cols = band[:, r0:r1].any(dim=(0, 1)).nonzero().flatten()
        if cols.numel():
            assert c_lo * KC <= cols.min().item()
            assert cols.max().item() < c_hi * KC


@pytest.mark.parametrize("nibble", [False, True])
def test_two_blocks_break_the_reach(nibble):
    """nb = 2: the previous and the next block are the same one, so a row
    r >= B can hold an entry in window columns [0, B) (here the edge between
    the last rows of both blocks); window_reach gives the whole window."""
    S, B = 16, 8
    src, dst = np.array([15, 31]), np.array([31, 15])
    dbg = build_dense_band(src, dst, 2 * S, S=S, B=B, device="cpu", nibble=nibble)
    band = band_rows(dbg)
    assert band[0, 15, 7] == 1 and band[1, 15, 7] == 1   # row 15 >= B, column 7 < B
    assert window_reach(S, B, 2, 15, 16) == (0, S + 2 * B)
    assert window_reach(S, B, 3, 15, 16) == (B, S + 2 * B)


@pytest.mark.parametrize("S", [8, 56, 200, 256, 512])
@pytest.mark.parametrize("sms", [16, 132])
def test_row_split_covers_each_row_once(S, sms):
    full = min(MAX_ROWS, -(-S // 16) * 16)
    prev = 0
    for nb in range(1, 201):
        tr = rows_per_cta(nb, S, sms)
        assert tr % 16 == 0 and min(full, MIN_ROWS) <= tr <= full
        cover = torch.zeros(S, dtype=torch.int64)
        for r0, r1 in _tiles(S, tr):
            cover[r0:r1] += 1
        assert torch.equal(cover, torch.ones(S, dtype=torch.int64))
        # split only where whole-block CTAs would leave an SM without one,
        # and only as far as one an SM or the floor
        ctas = nb * -(-S // tr)
        if tr < full:
            assert nb * -(-S // full) < sms
        assert tr == full or tr == MIN_ROWS or ctas >= sms
        assert tr >= prev   # more blocks never split finer
        prev = tr
