"""The probe kernels and entry points of the port on the CPU: the stream
probe's plain version (ops/probe_kernels.py) against a numpy reading of the
JAX package's probe kernels (scripts/probe_pallas_stream.py::make_stream,
scripts/probe_overlap.py::make), including their last-group output; K1's
timing variants noscale and nodot (ops/band_kernels.spmm_band diag=)
against their definitions and against the JAX package's band kernel run
with the same diag in interpret mode (band_pallas._apply, as
scripts/tune_band_packed.py --diag calls it), and noh and hlin refused on a
CPU tensor; and each probe's main (probe_f32_epi, bench_nibble, tune_band,
probe_hbm_roof) at a small size, printing one JSON line.

Tolerances: 0 for the stream (integer sums, exact in f32 below 2^24) and
for nodot (one product a row, rounded as the definition rounds it); 1e-5
of max|ref| for noscale (f32 sums in another order), against the
definition and against JAX, where nodot is exact too."""

import json

import numpy as np
import pytest
import torch

from mdcommunity_tpu_torch import bench_nibble, probe_f32_epi, probe_hbm_roof, tune_band
from mdcommunity_tpu_torch.ops import band_kernels as bk
from mdcommunity_tpu_torch.ops import dense_band as tdb
from mdcommunity_tpu_torch.ops.probe_kernels import stream_sum
from torch_one_thread import one_torch_thread  # noqa: F401

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdcommunity_tpu.ops import dense_band as jdb  # noqa: E402
from mdcommunity_tpu.ops.band_pallas import _apply, pack_band, pack_rows, unpack_rows  # noqa: E402


def _jax_stream_body(x, G, extra, s):
    """What the JAX probe kernels compute, grid step after grid step, as
    numpy: each program writes sum(group) + s to the one output block, so
    the last program's value is what the call returns."""
    o = None
    for p in range(x.shape[0] // G):
        total = 0.0
        for g in range(G):
            blk = x[p * G + g].astype(np.float32)
            acc = blk.sum()
            if extra:
                ii = np.arange(256)[:, None]
                kk = np.arange(128)[None, :]
                t = blk[:256, :128]
                acc += (t * (kk == 2 * (ii % 64))).sum() + (t * (kk == 2 * (ii % 64) + 1)).sum()
            total += acc
        o = total + s
    return o


@pytest.mark.parametrize("G,extra", [(2, False), (4, False), (2, True)])
def test_stream_plain_matches_jax_probe_body(G, extra):
    rng = np.random.default_rng(G)
    x = rng.integers(0, 3, (8, 256, 256)).astype(np.int8)
    s = rng.standard_normal((8, 128)).astype(np.float32)
    got = stream_sum(torch.from_numpy(x), G, extra)
    assert got.shape == (8 // G,) and got.dtype == torch.float32
    want = [x[i * G:(i + 1) * G].astype(np.int64).sum() for i in range(8 // G)]
    if extra:
        ii, kk = np.arange(256)[:, None], np.arange(128)[None, :]
        mask = (kk == 2 * (ii % 64)).astype(np.int64) + (kk == 2 * (ii % 64) + 1)
        for i in range(8 // G):
            want[i] += (x[i * G:(i + 1) * G, :256, :128].astype(np.int64) * mask).sum()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.float32))
    np.testing.assert_array_equal(got[-1].item() + s, _jax_stream_body(x, G, extra, s))


def test_stream_refuses_what_it_does_not_take():
    with pytest.raises(ValueError):
        stream_sum(torch.zeros(6, 4, 16, dtype=torch.int8), 4)
    with pytest.raises(ValueError):
        stream_sum(torch.zeros(4, 4, 16, dtype=torch.float32), 2)


def _graph(n=1024, S=256, B=128, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, 4 * n)
    dst = (src + rng.integers(-60, 60, 4 * n)) % n
    dst[: n // 16] = rng.integers(0, n, n // 16)
    keep = src != dst
    ss = np.concatenate([src[keep], dst[keep]])
    dd = np.concatenate([dst[keep], src[keep]])
    g = tdb.build_dense_band(ss, dd, n, S=S, B=B, device="cpu")
    assert g.C > 0
    row = torch.from_numpy((rng.random(n) * (rng.random(n) > 0.1)).astype(np.float32))
    col = torch.from_numpy((0.5 + rng.random(n)).astype(np.float32))
    h = torch.from_numpy(rng.standard_normal((n, 16)).astype(np.float32))
    return g, row, col, h


@pytest.mark.parametrize("precise", [True, False])
def test_diag_noscale_is_the_unscaled_operator(precise):
    g, row, col, h = _graph()
    sub = tdb.mirror_sub(g, col, h, precise)
    got = bk.spmm_band(g, row, col, h, sub, precise=precise, diag="noscale")
    dense = torch.zeros(g.pad_n, g.pad_n, dtype=torch.float64)
    band = tdb.band_rows(g).double()
    for b in range(g.n_blocks):
        cols = (b * g.S - g.B + torch.arange(g.W2)) % g.pad_n
        dense[b * g.S:(b + 1) * g.S].index_add_(1, cols, band[b])
    hh = h.double() if precise else h.to(torch.bfloat16).double()
    want = dense @ hh
    slot = g.slot_of_row.reshape(-1).long()
    s = sub.double() if precise else sub.to(torch.bfloat16).double()
    flat = torch.arange(g.pad_n) // g.S * g.C + slot
    want += torch.where((slot >= 0)[:, None], s[flat.clamp(min=0)], torch.zeros(1))
    assert (got.double() - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("precise", [True, False])
def test_diag_nodot_writes_the_window_value_of_row_i_minus_b(precise):
    g, row, col, h = _graph(seed=1)
    sub = tdb.mirror_sub(g, col, h, precise)
    got = bk.spmm_band(g, row, col, h, sub, precise=precise, diag="nodot")
    j = (torch.arange(g.pad_n) - g.B) % g.pad_n
    cw = col[j, None] * h[j]
    if not precise:
        cw = cw.to(torch.bfloat16).float()
    assert torch.equal(got, cw * row[:, None])


@pytest.fixture(scope="module")
def pallas_diag_case():
    """tests/test_band_pallas.py:124-136's ring graph (n = 4,096, 8,192
    edges, S = 512, B = 128, mirror lanes) in int8, with row and col scales
    that differ, so that dropping or swapping a scale shows; and the live
    mask as a second col, for the bf16 mode, where the Pallas engine's
    mirror compaction bf16(h)·col equals bf16(col ⊙ h) only for col in
    {0, 1} (tests/test_torch_band_bf16.py)."""
    rng = np.random.default_rng(5)
    n = 4096
    src = rng.integers(0, n, 8192)
    off = np.minimum((24.0 * (rng.pareto(2.0, 8192) + 1)).astype(np.int64), n // 2 - 1)
    dst = (src + off * rng.choice([-1, 1], 8192)) % n
    ss, dd = np.concatenate([src, dst]), np.concatenate([dst, src])
    jg = jdb.build_dense_band(ss, dd, None, n, S=512, B=128, dtype=jnp.int8)
    tg = tdb.build_dense_band(ss, dd, n, S=512, B=128, device="cpu")
    # no spill: _apply adds it after the kernel, outside what diag changes
    assert tg.C > 0 and tg.spill.nnz == 0 and tg.pad_n == n
    live = (rng.random(n) > 0.15).astype(np.float32)
    row = live * rng.uniform(0.5, 1.5, n).astype(np.float32)
    cols = {True: (0.5 + rng.random(n)).astype(np.float32), False: live}
    h = rng.standard_normal((n, 64)).astype(np.float32)
    return jg, pack_band(jg, G=8), tg, row, cols, h


@pytest.mark.parametrize("diag", ["noscale", "nodot"])
@pytest.mark.parametrize("precise", [True, False])
def test_diag_matches_pallas_diag(pallas_diag_case, diag, precise):
    jg, pk, tg, row, cols, h = pallas_diag_case
    col = cols[precise]
    ref = np.asarray(unpack_rows(_apply(pk, jg, jnp.asarray(row), jnp.asarray(col),
                                        pack_rows(jnp.asarray(h)), True, diag, precise)),
                     np.float64)
    r, c, x = map(torch.from_numpy, (row, col, h))
    got = bk.spmm_band(tg, r, c, x, tdb.mirror_sub(tg, c, x, precise), precise=precise,
                       diag=diag)
    if diag == "nodot":
        np.testing.assert_array_equal(got.double().numpy(), ref)
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(got.double().numpy(), ref, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("diag", ["noh", "hlin"])
def test_diag_without_an_output_needs_the_card(diag):
    g, row, col, h = _graph()
    sub = tdb.mirror_sub(g, col, h)
    with pytest.raises(NotImplementedError, match="CUDA"):
        bk.spmm_band(g, row, col, h, sub, diag=diag)


def test_diag_refuses_unknown_names_and_other_storage():
    g, row, col, h = _graph()
    sub = tdb.mirror_sub(g, col, h)
    with pytest.raises(ValueError, match="diag"):
        bk.spmm_band(g, row, col, h, sub, diag="nosuch")
    hb = h.to(torch.bfloat16)
    with pytest.raises(ValueError, match="storage"):
        bk.spmm_band(g, row, col, hb, tdb.mirror_sub(g, col, hb, False), precise=False,
                     diag="nodot")


@pytest.mark.parametrize("probe,argv", [
    (probe_f32_epi, ["--n", "2048", "--severs", "40", "--rounds", "2"]),
    (bench_nibble, ["--n-check", "4096", "--n", "4096"]),
    (tune_band, ["--diag", "--sweep", "--proto", "--n", "4096"]),
    (probe_hbm_roof, ["--n", "4096"]),
])
def test_probe_main_prints_one_json_line(probe, argv, capsys):
    out = probe.main(["--device", "cpu", *argv])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1
    assert json.loads(lines[0]) == json.loads(json.dumps(out))
    assert out["device"] == "cpu" and out["gpu"] is None


@pytest.mark.parametrize("probe,argv", [
    (probe_f32_epi, []), (bench_nibble, []), (tune_band, ["--diag"]), (probe_hbm_roof, []),
])
def test_probe_main_runs_on_the_card_unless_cpu_asked(probe, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        probe.main(["--n", "4096", *argv])
