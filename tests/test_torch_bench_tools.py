"""The port's measurement entry points against the JAX repo's scripts, at
small sizes on the CPU:

* bench_spmm (bench.py's workload and step): the same draws (edges, covered
  mask, h) as bench.py; one fwd+bwd step against jax.grad through the JAX
  package's dense_band engine, bf16 mode (1e-2 of max|·|) and precise
  (1e-5); the `sol` bytes, and no TPU constant in the line;
* scaling_bench: gp = 2 and 4 against gp = 1 (band bit for bit, the edge
  partition within 1e-6 of max), gp = 2 against the JAX package's
  spmm_band_sharded on its 8-device CPU mesh;
* bench_cascade_host: the same removals, batches, score and final rank as
  scripts/bench_cascade_host.py on the same arguments;
* bf16_ab_train: its curves against a direct DQNAgent run.
"""

import io
import json
import os
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import bench  # noqa: E402
from mdcommunity_tpu.ops import dense_band as jdb  # noqa: E402
from mdcommunity_tpu.parallel import band_partition as jbp  # noqa: E402
from mdcommunity_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402
from mdcommunity_tpu_torch import bench_cascade_host, bench_spmm, bf16_ab_train  # noqa: E402
from mdcommunity_tpu_torch import scaling_bench  # noqa: E402
from mdcommunity_tpu_torch.ops.dense_band import band_rows  # noqa: E402
from mdcommunity_tpu_torch.utils.timing import band_pass_bytes  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

N, E = 1 << 12, 1 << 14
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bench_draws(n, e, seed=0, dim=64):
    """bench.py's _measure draws, in its order (its own generator and the
    JAX package's build)."""
    rng = np.random.default_rng(seed)
    src, dst = bench.ring_powerlaw_edges(n, e, rng)
    dbg = jdb.build_dense_band(np.concatenate([src, dst]), np.concatenate([dst, src]), None,
                               n, S=256, B=128, dtype=jnp.int8)
    covered = rng.random(dbg.pad_n) < 0.1
    h = rng.standard_normal((dbg.pad_n, dim)).astype(np.float32)
    return src, dst, dbg, covered, h


@pytest.fixture(scope="module")
def draws():
    return _bench_draws(N, E)


@pytest.mark.parametrize("precise", [False, True])
def test_bench_spmm_draws_equal_bench_py(draws, precise):
    src, dst, jd, covered, h = draws
    w = bench_spmm.workload(N, E, precise=precise, device="cpu")
    np.testing.assert_array_equal(w["src"], src)
    np.testing.assert_array_equal(w["dst"], dst)
    assert w["dbg"].pad_n == jd.pad_n and w["directed_edges"] == 2 * E
    np.testing.assert_array_equal(w["dbg"].base.numpy(), np.asarray(jd.base))
    np.testing.assert_array_equal(w["row"].numpy(), (~covered).astype(np.float32))
    np.testing.assert_array_equal(w["col"].numpy(), (~covered).astype(np.float32))
    want = torch.from_numpy(h).to(torch.float32 if precise else torch.bfloat16)
    assert w["h"].dtype == want.dtype and torch.equal(w["h"], want)


def test_bench_spmm_reuses_a_given_build(draws):
    w = bench_spmm.workload(N, E, device="cpu")
    again = bench_spmm.workload(N, E, device="cpu", dbg=w["dbg"])
    assert again["dbg"] is w["dbg"] and torch.equal(again["h"], w["h"])
    with pytest.raises(ValueError, match="int8 build"):
        bench_spmm.workload(2 * N, E, device="cpu", dbg=w["dbg"])


@pytest.mark.parametrize("precise,tol", [(False, 1e-2), (True, 1e-5)])
def test_bench_spmm_step_matches_jax_grad(draws, precise, tol):
    """One step's gradient and updated h: the port (K1's plain version both
    ways through BandSpmm) against jax.grad through the JAX dense_band
    engine in the same mode, bench.py's step body (h + g / (1 + i), i = 3),
    within tol of max|·|; the written-out plain step agrees too."""
    _, _, jd, covered, h = draws
    dt = jnp.float32 if precise else jnp.bfloat16
    row, col = jdb.live_scales(jd, jnp.asarray(covered), "sum")
    hj = jnp.asarray(h).astype(dt)
    gj = jax.grad(lambda x: jnp.sum(jnp.square(
        jdb.spmm_dense_band(jd, row, col, x, precise=precise).astype(jnp.float32))) * 1e-6)(hj)
    step_j = np.asarray((hj + gj / dt(1.0 + 3)).astype(jnp.float32))
    gj = np.asarray(gj.astype(jnp.float32))

    w = bench_spmm.workload(N, E, precise=precise, device="cpu")
    g = bench_spmm.fwd_bwd(w["dbg"], w["row"], w["col"], w["h"], precise)
    step = bench_spmm.grad_step(w["dbg"], w["row"], w["col"], w["h"], 3, precise)
    assert g.dtype == w["h"].dtype and step.dtype == w["h"].dtype
    scale = np.abs(gj).max()
    assert scale > 0
    np.testing.assert_allclose(g.float().numpy(), gj, rtol=0, atol=tol * scale)
    np.testing.assert_allclose(step.float().numpy(), step_j, rtol=0,
                               atol=tol * np.abs(step_j).max())
    plain = bench_spmm.plain_fwd_bwd(w["dbg"], w["row"], w["col"], w["h"], precise)
    np.testing.assert_allclose(plain.float().numpy(), gj, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("precise", [False, True])
def test_bench_spmm_line_and_sol_bytes(precise, capsys):
    """The line keeps bench.py's metric and baseline; its bytes are two
    band passes at h's width plus five h-sized glue streams; it names no
    TPU constant; untimed on the CPU."""
    out = bench_spmm.main(["--cpu", "--n", str(N), "--edges", str(E)]
                          + (["--precise"] if precise else []))
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert out["metric"] == "spmm_fwdbwd_edges_per_s_per_chip" and out["value"] is None
    assert bench_spmm.BASELINE_EDGES_PER_S == 6.0e8
    w = bench_spmm.workload(N, E, precise=precise, device="cpu")
    store = 4 if precise else 2
    glue = 5 * w["dbg"].pad_n * 64 * store
    assert out["sol"]["bytes_step"] == 2 * band_pass_bytes(w["dbg"], 64, store) + glue
    nnz = int((band_rows(w["dbg"]) != 0).sum())
    assert out["sol"]["ops_step"] == 4 * nnz * 64
    text = json.dumps(out).lower()
    for word in ("v5e", "tpu", "819", "197", "657", "mxu"):
        assert word not in text, word
    src = open(bench_spmm.__file__).read()
    for const in ("819e9", "197e12", "657e9", "V5E"):
        assert const not in src


@pytest.fixture(scope="module")
def scaling():
    wl = scaling_bench.workload(N, E, 64, "cpu")
    return wl, scaling_bench.run(wl, on_card=False)


def test_scaling_bench_gp_equal_gp1(scaling):
    _, res = scaling
    assert res["vs_gp1"]["band_gp2"] == 0.0 and res["vs_gp1"]["band_gp4"] == 0.0
    assert res["vs_gp1"]["coo_gp2"] <= 1e-6 and res["vs_gp1"]["coo_gp4"] <= 1e-6
    for engine in ("band", "coo"):
        assert [r["gp"] for r in res[engine]] == [1, 2, 4]
        assert res[engine][0]["collective_bytes"] == 0
        assert all(r["edges_per_s"] is None for r in res[engine])  # untimed on the CPU


def test_scaling_bench_band_gp2_matches_jax(scaling):
    """The band engine at gp = 2 (bf16 mode, f32 h) against the JAX
    package's spmm_band_sharded(precise=False) on a dp = 1, gp = 2 mesh:
    sum(y²)'s output and gradient, within 1e-5 of max|·|."""
    wl, res = scaling
    y, dh = res["outputs"]["band"][2]
    n = wl["n"]
    rng = np.random.default_rng(0)   # the script's draws
    usrc = rng.integers(0, n, E // 2).astype(np.int64)
    off = (8.0 * (rng.pareto(2.5, E // 2) + 1.0)).astype(np.int64)
    off = np.minimum(off, n // 2 - 1) * rng.choice(np.array([-1, 1]), E // 2)
    udst = (usrc + off) % n
    keep = usrc != udst
    usrc, udst = usrc[keep], udst[keep]
    src, dst = np.concatenate([usrc, udst]), np.concatenate([udst, usrc])
    rng.random(len(src))
    h0 = rng.standard_normal((n, 64)).astype(np.float32)
    covered = rng.random(n) < 0.1
    jd = jdb.build_dense_band(src, dst, None, n, S=256, B=128, max_mirror=256)
    mesh = jax_mesh(dp=1, gp=2, devices=jax.devices()[:2])
    with mesh:
        dbg_s = jbp.shard_band_graph(mesh, jd)
        row, col = jdb.live_scales(jd, jnp.asarray(covered), "sum")
        row_s, col_s, h_s = jbp.shard_band_vectors(mesh, row, col, jnp.asarray(h0))
        yj, vjp = jax.vjp(lambda x: jbp.spmm_band_sharded(mesh, dbg_s, row_s, col_s, x), h_s)
        (gj,) = vjp(2 * yj)
    yj, gj = np.asarray(yj), np.asarray(gj)
    np.testing.assert_allclose(y.numpy()[:n], yj[:n], rtol=0, atol=1e-5 * np.abs(yj).max())
    np.testing.assert_allclose(dh.numpy()[:n], gj[:n], rtol=0, atol=1e-5 * np.abs(gj).max())


def test_bench_cascade_host_matches_the_script(monkeypatch, capsys):
    argv = ["--n", "4096", "--batch", "16"]
    port = bench_cascade_host.main(argv)
    assert port["terminal"]
    sys.path.insert(0, REPO)
    from scripts import bench_cascade_host as script

    monkeypatch.setattr(sys, "argv", ["bench_cascade_host.py"] + argv)
    buf = io.StringIO()
    with redirect_stdout(buf):
        script.main()
    ref = json.loads(buf.getvalue().strip().splitlines()[-1])
    for key in ("removed", "batches", "score", "rank_final", "terminal", "edges_directed"):
        assert port[key] == ref[key], key


def test_bf16_ab_train_curves_equal_a_direct_run(tmp_path, monkeypatch):
    """Both arms' curves (4 iterations, validations at 0 and 2, SMOKE
    sizes made smaller through their variables, which the arms inherit)
    against DQNAgent(float32, seed 0).train at the same config: on the CPU
    TF32 changes nothing, so both equal it."""
    from mdcommunity_tpu_torch.rl.dqn import DQNAgent

    for var, v in (("SMOKE_TRAIN", "4"), ("SMOKE_VALID", "2"), ("SMOKE_WARMUP_GAMES", "1"),
                   ("SMOKE_WARMUP_TRAJ", "8")):
        monkeypatch.setenv(var, v)

    models = sorted(os.listdir(os.path.join(REPO, "models_tpu")))
    out = bf16_ab_train.main(["--cpu", "--smoke", "--iters", "4", "--save-frequency", "2",
                              "--out", str(tmp_path / "ab")])
    cfg = bf16_ab_train.agent_config("float32", 4, 2, smoke=True)
    direct = str(tmp_path / "direct")
    DQNAgent(cfg, seed=0, device="cpu").train(save_dir=direct, log=lambda *a: None)
    want = bf16_ab_train.vc_curve(direct, cfg)
    assert len(want) == 2
    assert out["f32"] == want and out["bf16"] == want
    assert sorted(os.listdir(os.path.join(REPO, "models_tpu"))) == models  # nothing written
